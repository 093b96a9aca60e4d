"""Matrix-factorization models: MF-BPR with its APR adversarial variant, and
pointwise MF (counterpart of ``acf_tpu/models/mf.py``).

The hyperparameter fields match the JAX dataclasses so configurations carry
across. :meth:`MFBPR.loss` is the clean BPR objective, or with
``adversarial=True`` APR: the clean loss plus ``reg_adv`` times the BPR loss
at embedding rows moved by FGSM deltas (``adv_mode="grad"``: ε times the
row-normalized gradient of the clean loss, ``adv_steps`` PGD-style steps;
``"random"``: ε times row-normalized truncated-normal noise). For the
reference configuration (grad mode, one step) :attr:`MFBPR.manual_grads`
gives APR's gradients in closed form, which the pair trainer takes instead
of autograd up to ``manual_grads_max_batch``. DNS (``dns > 1``) lives in the
pair trainer (``acf_tpu_torch/train/trainer.py``).

The inner FGSM gradient is taken on detached copies of the tables with
their own gathers, so it never touches the graph of the loss the caller
differentiates, and it is constant under that outer gradient.

The row path (``row_path``: clean MF-BPR, DNS, pointwise MF, and APR by its
closed form) serves the trainer's sharded storage: :meth:`MFBPR.row_step`
and :meth:`row_scores` read the batch's rows of P and Q through a
:class:`~acf_tpu_torch.parallel.sharded_embedding.TableRows` (across
"model" for a shard), take the gradients of those rows (the model's own
loss on them by autograd, or APR's closed form) and scatter them into the
rank's own rows, so no whole table is formed on a rank. The gathers are
exact and each id's gradient rows are summed in the order a whole table's
scatter sums them, so the step equals the whole-table step bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import (
    PairwiseModel, bpr_pair_loss, project_rows, row_normalize, scatter_rows, softplus,
)


def _trunc_normal(generator, shape, std=0.01):
    """tf.truncated_normal semantics: normal(0, std) truncated at 2 std.
    Drawn on the generator's device; the draws differ from ``jax.random``,
    the distribution matches."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(x, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def _mf_factored_scorer(model):
    if not hasattr(model, "_fs"):
        def user_repr(params, users, hists):
            return params["P"][users]

        def table(params):
            return params["Q"], None

        model._fs = (user_repr, table)
    return model._fs


class _RowPath:
    """The row path of a model whose loss and ``score_some`` read its
    tables P and Q only at the batch's ids (the module docstring)."""

    row_path = True
    repr_reads_table = False  # the factored user representation is P's row

    def row_scores(self, tables, params, users, hists, items):
        """``score_some`` on the rows of P and Q that ``tables`` reads for
        ``users`` [B] and ``items`` [B, M]."""
        b, k = items.shape
        view = {"P": tables.rows("P", params["P"], users),
                "Q": tables.rows("Q", params["Q"], items.reshape(-1))}
        ids = torch.arange(b * k, device=items.device)
        return self.score_some(view, ids[:b], hists, ids.reshape(b, k))

    def row_step(self, tables, params, batch, generator=None, closed_form=False):
        """(gradients {"P", "Q"} shaped as the tables are stored, aux) of the
        step's objective on ``batch`` = (users, pos, neg): APR's closed form
        when ``closed_form``, else autograd of :meth:`loss` on the gathered
        rows, each table's row gradients scattered as its whole-table
        gather's backward scatters them (pos and neg apart, then added)."""
        if closed_form:
            return self._apr_manual_grads(params, batch, generator, tables)
        users, pos, neg = batch
        P, Q = params["P"], params["Q"]
        b = users.shape[0]
        p = tables.rows("P", P, users).requires_grad_(True)
        q = tables.rows("Q", Q, torch.cat([pos, neg])).requires_grad_(True)
        ids = torch.arange(b, device=users.device)
        with torch.enable_grad():
            loss, aux = self.loss({"P": p, "Q": q}, (ids, ids, ids + b), generator)
            gp, gq = torch.autograd.grad(loss, (p, q))
        return ({"P": tables.scatter("P", P, users, gp),
                 "Q": tables.scatter("Q", Q, pos, gq[:b]) + tables.scatter("Q", Q, neg, gq[b:])},
                aux)


def _mf_adv_encoders(model):
    """The user and item towers (``acf_tpu/models/mf.py`` ``adv_encoders``):
    name -> (side, fn(params, ids) -> [N, d], width)."""
    d = model.dim
    return {
        "u": ("user", lambda p, ids: p["P"][ids], d),
        "i": ("item", lambda p, ids: p["Q"][ids], d),
    }


def _pair_bpr(p, qp, qn):
    """(pos scores, neg scores) of gathered rows p [B, d], qp, qn."""
    return torch.sum(p * qp, dim=-1), torch.sum(p * qn, dim=-1)


def _acc(diff):
    """The share of pairs with ``diff > 0``, as an f32 mean of a bool."""
    return torch.mean((diff > 0).to(torch.float32))


def equality(ids):
    """[N, N] float32: 1 where ``ids[i] == ids[j]``. Its product with
    per-occurrence rows [N, d] gives each row its duplicate group's sum."""
    return (ids[:, None] == ids[None, :]).to(torch.float32)


def equality_deltas(ids):
    """``delta(g, eps)``: eps times the row-normalized sum of each slot's
    duplicate group of rows ``g`` [N, d] (the FGSM delta of a table row that
    several slots of ``ids`` share)."""
    eq = equality(ids)

    def delta(g, eps):
        return eps * row_normalize(torch.matmul(eq, g))

    return delta


def _clip_grad_coef(diff):
    """(clipped diff, dL/ddiff) of ``softplus(-clip(diff, -80, 1e8))``: the
    clip passes no gradient outside its range, inclusive at the ends."""
    diff_c = torch.clamp(diff, -80.0, 1e8)
    in_range = ((diff >= -80.0) & (diff <= 1e8)).to(torch.float32)
    return diff_c, -torch.sigmoid(-diff_c) * in_range


@dataclasses.dataclass(eq=False)
class MFBPR(_RowPath, PairwiseModel):
    """MF with BPR loss; APR (FGSM on embedding rows) when ``adversarial``.

    Hyperparameter defaults follow the reference CLI (run_adv.py:15-54):
    Adagrad(lr=0.05), reg=0, eps=0.5, reg_adv=1.
    """

    reg: float = 0.0
    adversarial: bool = False
    eps: float = 0.5
    reg_adv: float = 1.0
    adv_mode: str = "grad"  # "grad" (FGSM) or "random"
    init_std: float = 0.01
    dns: int = 1  # >1 = hardest-of-k dynamic negative sampling
    adv_steps: int = 1  # >1 = multi-step (PGD-style) perturbation
    # the closed form aggregates duplicate rows with [B, B] and [2B, 2B]
    # equality matrices, so past this batch size the trainer takes autograd
    manual_grads_max_batch: int = 4096

    @property
    def row_path(self):
        """Clean MF-BPR and DNS by autograd, APR by its closed form; APR's
        other modes read whole perturbation tables."""
        return not self.adversarial or self.manual_grads is not None

    def init_params(self, generator: torch.Generator, device=None):
        dev = resolve_device(device)
        return {
            "P": _trunc_normal(generator, (self.num_users, self.dim),
                               self.init_std).to(dev),
            "Q": _trunc_normal(generator, (self.num_items, self.dim),
                               self.init_std).to(dev),
        }

    # -- scoring ------------------------------------------------------------
    def _pair_scores(self, params, users, items, dP=None, dQ=None):
        """(scores [B], user rows, item rows), the rows moved by the
        perturbation tables ``dP``/``dQ`` when given."""
        p = params["P"][users]
        q = params["Q"][items]
        if dP is not None:
            p = p + dP[users]
            q = q + dQ[items]
        return torch.sum(p * q, dim=-1), p, q

    def score_all(self, params, users, hists):
        return params["P"][users] @ params["Q"].T

    def score_some(self, params, users, hists, items):
        p = params["P"][users]  # [B, d]
        q = params["Q"][items]  # [B, M, d]
        return torch.einsum("bd,bmd->bm", p, q)

    def factored_scorer(self):
        return _mf_factored_scorer(self)

    # -- training loss ------------------------------------------------------
    def _clean_loss(self, params, users, pos, neg):
        """(BPR loss, mean(p² + q_pos² + q_neg²), acc, the gathered rows
        (p, q_pos, q_neg)) of the batch."""
        p, qp, qn = params["P"][users], params["Q"][pos], params["Q"][neg]
        pos_s, neg_s = _pair_bpr(p, qp, qn)
        reg_term = self.data_share(
            torch.mean(torch.square(p) + torch.square(qp) + torch.square(qn)))
        return (bpr_pair_loss(pos_s, neg_s), reg_term, self.data_share(_acc(pos_s - neg_s)),
                (p, qp, qn))

    def _clean_table_grads(self, params, users, pos, neg, dP=None, dQ=None):
        """Dense gradients (gP, gQ) of the raw BPR loss at the tables moved
        by ``dP``/``dQ``, taken on detached copies (their own gathers,
        ``torch.autograd.grad`` without ``create_graph``) and returned
        detached: constant under any outer gradient. Under a mesh, summed
        over the data ranks."""
        P = params["P"].detach().requires_grad_(True)
        Q = params["Q"].detach().requires_grad_(True)
        with torch.enable_grad():
            pos_s, _, _ = self._pair_scores({"P": P, "Q": Q}, users, pos, dP, dQ)
            neg_s, _, _ = self._pair_scores({"P": P, "Q": Q}, users, neg, dP, dQ)
            gP, gQ = torch.autograd.grad(bpr_pair_loss(pos_s, neg_s), (P, Q))
        return self.data_sum(gP.detach()), self.data_sum(gQ.detach())

    def fgsm_deltas(self, params, users, pos, neg, generator=None, noise=None):
        """Perturbation tables (dP [U, d], dQ [I, d]) for the adversarial
        objective, constant under the outer gradient.

        ``adv_steps=1`` (reference semantics, evaluation_adv.py:192-203):
        ε times the row-normalized gradient of the *clean* BPR loss wrt the
        full tables; rows outside the batch get zero delta. ``adv_steps>1``
        iterates PGD-style (MSAP, arXiv:2010.01329): step ε/adv_steps, the
        gradient taken at the perturbed point, each row projected back into
        the ε-ball. ``adv_mode="random"``: ε times row-normalized
        truncated-normal (std 0.01) tables, drawn from ``generator`` or
        given as ``noise`` = (gP, gQ) (how a test hands over JAX's draws).
        """
        if self.adv_mode == "random":
            if noise is None:
                noise = (_trunc_normal(generator, tuple(params["P"].shape), 0.01),
                         _trunc_normal(generator, tuple(params["Q"].shape), 0.01))
            gP, gQ = noise
            return (self.eps * row_normalize(gP.detach()),
                    self.eps * row_normalize(gQ.detach()))
        alpha = self.eps / self.adv_steps
        dP = torch.zeros_like(params["P"].detach())
        dQ = torch.zeros_like(params["Q"].detach())
        for _ in range(self.adv_steps):
            gP, gQ = self._clean_table_grads(params, users, pos, neg, dP, dQ)
            dP = project_rows(dP + alpha * row_normalize(gP), self.eps)
            dQ = project_rows(dQ + alpha * row_normalize(gQ), self.eps)
        return dP, dQ

    # -- closed-form step gradients -----------------------------------------
    @property
    def manual_grads(self):
        """Closed-form gradient function of the APR step, or None.

        Defined only for the reference configuration (grad-mode single-step
        FGSM); other modes train through autograd. It writes one scatter
        per table (:func:`scatter_rows`: the same sums on every run) and no
        dense intermediate: duplicate batch rows are aggregated (what the
        dense gradient does before the FGSM normalize) by products with 0/1
        equality matrices.
        """
        if (self.adversarial and self.adv_mode == "grad"
                and self.adv_steps == 1):
            return self._apr_manual_grads
        return None

    def _apr_manual_grads(self, params, batch, generator=None, tables=None):
        """({"P": gP, "Q": gQ}, aux) of APR's objective at ``params`` on
        ``batch`` = (users, pos, neg); aux as :meth:`loss` gives it. With
        ``tables`` (a :class:`~acf_tpu_torch.parallel.sharded_embedding.
        TableRows`) the rows are read and the gradients scattered as the
        tables are stored (the row path)."""
        if tables is None:
            from acf_tpu_torch.parallel.sharded_embedding import TableRows

            tables = TableRows()
        users, pos, neg = batch
        P, Q = params["P"].detach(), params["Q"].detach()
        items2 = torch.cat([pos, neg], dim=0)
        if self.data_mesh is None or self.data_mesh.shape["data"] == 1:  # the whole batch here
            delta_u, delta_i = equality_deltas(users), equality_deltas(items2)
        else:
            delta_u = self._table_deltas(tables, "P", P, users)
            delta_i = self._table_deltas(tables, "Q", Q, items2)
        B = users.shape[0]
        q = tables.rows("Q", Q, items2)  # the pos rows, then the neg rows
        rows_p, rows_q, aux = self.row_grads(tables.rows("P", P, users), q[:B], q[B:], delta_u,
                                             delta_i)
        grads = {"P": tables.scatter("P", P, users, rows_p),
                 "Q": tables.scatter("Q", Q, items2, rows_q)}
        return grads, aux

    def _table_deltas(self, tables, name, table, ids):
        """``delta(g, eps)`` under a mesh: eps times the row-normalized row of
        each slot's id in the dense clean gradient summed over the data ranks
        (the rank's rows ``g`` [N, d] scattered as ``table`` is stored, then
        summed, then read back), as the single-device dense gradient gives
        it."""
        def delta(g, eps):
            summed = self.data_sum(tables.scatter(name, table, ids, g))
            return eps * row_normalize(tables.rows(name, summed, ids))

        return delta

    def row_grads(self, p, qp, qn, delta_u, delta_i):
        """The closed-form gradients of the step's objective (the clean one,
        or with ``adversarial`` APR's with one grad-mode FGSM step) with
        respect to the gathered rows p [B, d], q_pos and q_neg, one row per
        occurrence: (rows_p [B, d], rows_q [2B, d], the pos rows then the
        neg rows, aux as :meth:`loss` gives it). The FGSM deltas are
        ``delta_u(g, eps)`` and ``delta_i(g, eps)`` of the clean loss's rows
        (the users'; the items', pos then neg): each sums the rows of an
        id's duplicate slots before the row normalize, as the dense gradient
        does (:func:`equality_deltas`)."""
        B, d = p.shape

        # clean BPR: L = sum softplus(-clip(s+ - s-)); dL/ddiff = -sigmoid(-diff)
        diff = torch.sum(p * (qp - qn), dim=-1)
        diff_c, c = _clip_grad_coef(diff)
        aux = {"loss": torch.sum(softplus(-diff_c)), "acc": self.data_share(_acc(diff))}

        # per-occurrence clean gradient rows of L wrt P and Q (pos, then neg)
        rows_p = c[:, None] * (qp - qn)
        rows_q = torch.cat([c[:, None] * p, -c[:, None] * p], dim=0)
        n_reg = 1
        if self.adversarial:
            dP = delta_u(rows_p, self.eps)  # [B, d] rows for users
            dQ = delta_i(rows_q, self.eps)  # [2B, d] rows for pos, then neg

            # the adversarial pair loss at the perturbed point
            ph = p + dP
            qph = qp + dQ[:B]
            qnh = qn + dQ[B:]
            diff_a = torch.sum(ph * (qph - qnh), dim=-1)
            diff_ac, ca = _clip_grad_coef(diff_a)
            aux["loss_adv"] = torch.sum(softplus(-diff_ac))
            aux["acc_adv"] = self.data_share(_acc(diff_a))

            # clean + reg_adv * adversarial; the objective counts the reg
            # term twice (evaluation_adv.py:175-177)
            wa = (self.reg_adv * ca)[:, None]
            rows_p = rows_p + wa * (qph - qnh)
            rows_q = rows_q + torch.cat([wa * ph, -wa * ph], dim=0)
            n_reg = 2
        if self.reg != 0.0:
            # d/dx of reg * mean(p² + q_pos² + q_neg²) over B d entries, n_reg times
            rcoef = self.data_share(2.0 * n_reg * self.reg / (B * d))
            rows_p = rows_p + rcoef * p
            rows_q = rows_q + rcoef * torch.cat([qp, qn], dim=0)
        return rows_p, rows_q, aux

    def adv_target_loss(self, params, batch, generator=None):
        """FGSM linearization target: the raw BPR loss WITHOUT the reg term
        (the reference's delta is the gradient of the pre-reg pairwise
        loss, evaluation_adv.py:162 vs 192-203)."""
        users, pos, neg = batch
        return self._clean_loss(params, users, pos, neg)[0]

    def adv_encoders(self):
        """Embedding towers for the popularity discriminators (AdversarialBPR
        discriminates on the user and pos-item embeddings, reference
        BPR.py:112-123)."""
        return _mf_adv_encoders(self)

    def loss(self, params, batch, generator=None, noise=None):
        """The BPR loss (summed over the batch) plus ``reg`` times mean(p² +
        q_pos² + q_neg²); aux ``loss`` (BPR alone, differentiable) and
        ``acc``. With ``adversarial`` it adds ``reg_adv`` times the BPR
        loss at the perturbed rows and the reg term a second time, and aux
        ``loss_adv`` and ``acc_adv``. ``generator`` or ``noise`` feed the
        random mode (:meth:`fgsm_deltas`)."""
        users, pos, neg = batch
        loss, reg_term, acc, (p, qp, qn) = self._clean_loss(params, users, pos, neg)
        opt_loss = loss + self.reg * reg_term
        aux = {"loss": loss, "acc": acc}
        if not self.adversarial:
            return opt_loss, aux
        dP, dQ = self.fgsm_deltas(params, users, pos, neg, generator, noise)
        pu = p + dP[users]
        pos_a = torch.sum(pu * (qp + dQ[pos]), dim=-1)
        neg_a = torch.sum(pu * (qn + dQ[neg]), dim=-1)
        loss_adv = bpr_pair_loss(pos_a, neg_a)
        # the reference adds the clean-embedding reg term a second time
        # (evaluation_adv.py:175-177 reuses the clean lookups)
        opt_loss = opt_loss + self.reg_adv * loss_adv + self.reg * reg_term
        aux["loss_adv"] = loss_adv.detach()
        aux["acc_adv"] = self.data_share(_acc(pos_a - neg_a))
        return opt_loss, aux


@dataclasses.dataclass(eq=False)
class PointwiseMF(_RowPath, PairwiseModel):
    """Keras-style pointwise MF (reference MF.py:7-59): sigmoid(u·i) with
    binary cross-entropy; the trainer feeds (user, pos, neg) and the loss
    takes pos as label 1 and neg as label 0 (MF.py:42-56 draws one negative
    per positive)."""

    init_scale: float = 0.05  # keras Embedding default: uniform(-0.05, 0.05)

    def init_params(self, generator: torch.Generator, device=None):
        dev = resolve_device(device)

        def uniform(shape):
            x = torch.empty(shape, dtype=torch.float32, device=generator.device)
            return x.uniform_(-self.init_scale, self.init_scale,
                              generator=generator).to(dev)

        return {"P": uniform((self.num_users, self.dim)),
                "Q": uniform((self.num_items, self.dim))}

    def score_all(self, params, users, hists):
        return params["P"][users] @ params["Q"].T

    def score_some(self, params, users, hists, items):
        return torch.einsum("bd,bmd->bm", params["P"][users], params["Q"][items])

    def factored_scorer(self):
        return _mf_factored_scorer(self)

    def adv_encoders(self):
        """AMF discriminates on the raw user and item tables
        (reference MF.py:80-98)."""
        return _mf_adv_encoders(self)

    def loss(self, params, batch, generator=None):
        """The mean BCE over the 2B pointwise examples (pos labelled 1, neg
        0); aux ``loss`` (the same value) and ``acc``."""
        users, pos, neg = batch
        p = params["P"][users]
        pos_s, neg_s = _pair_bpr(p, params["Q"][pos], params["Q"][neg])
        logits = torch.cat([pos_s, neg_s])
        labels = torch.cat([torch.ones_like(pos_s), torch.zeros_like(neg_s)])
        bce = softplus(logits) - labels * logits
        loss = self.data_share(torch.mean(bce))
        return loss, {"loss": loss, "acc": self.data_share(_acc(pos_s - neg_s))}
