"""APL: Adversarial Pairwise Learning, a generator and a critic
(counterpart of ``acf_tpu/models/apl.py``).

Reference APL.py:52-259: the generator's full-catalog softmax yields
differentiable "fake" items by Gumbel-softmax (temperature 0.2); the critic
scores (real, fake) dot products and trains on ``y = real − fake`` with a
log, wgan or hinge loss; the generator mixes ``p_aux`` (0.2 spread evenly
over the user's unique positives) into its distribution during its own
step. SGD(0.05) for both players, the critic's weights clipped to ±0.05
under wgan. The reference never trains APL from scratch: its generator
starts from a pretrained MF-BPR (APL.py:68-78); hand a trained ``MFBPR``'s
``{"P", "Q"}`` to ``params["g"]``.

An epoch (:meth:`APL.make_epoch_fn`) runs every critic step first, with the
generator fixed, then every generator step against the new critic, on the
same shuffled batches. The critic step is plain PyTorch with autograd. The
generator step (:func:`gen_step`) is the closed form of the JAX package's
``gen_step_manual``, through :mod:`acf_tpu_torch.ops.apl_gen_fused`: on the
GPU the kernels K3a–K3e and nothing else, on the CPU their plain versions.
The JAX package's formulation switches (``manual_gen``, ``fused_gen``,
``remat_gen``) and its cap on fused epochs (``max_fuse_epochs``, a TPU
runtime workaround, ``docs/APL_RUNTIME_CRASH.md``) are not ported: the port
has one path and dispatches one epoch at a time.

Under a mesh (``make_epoch_fn(..., mesh=)`` on the data-parallel copy) every
rank draws the global batch and its [B, I] uniforms and takes its data
rank's rows: the critic's means are the rank's shares (its l2 term sums the
rank's own rows) and its gradient is summed over the data ranks before the
update, so the wgan clip acts on the same params everywhere. The generator
step runs K3a–K3e on the rank's B/dp users, as one device runs them on B:
K3a–K3d are per user, and K3e's Q_g gradient, a sum over users, is a
partial that is summed over the data ranks with the scattered P_g rows. The
whole-table terms (``reg_g`` times Q_g, and half of its squared norm in the
loss) are added once, after the sum or as a share. The JAX package takes its
autodiff generator under a mesh; this is the same closed form as on one
device.
"""

from __future__ import annotations

import dataclasses

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import PairwiseModel, scatter_rows, softplus
from acf_tpu_torch.ops.apl_gen_fused import EPS, NEG, apl_gen_backward, apl_gen_forward
from acf_tpu_torch.parallel.mesh import all_reduce_tree
from acf_tpu_torch.sampling.negatives import sample_pair_epoch
from acf_tpu_torch.train.optim import grad_update, player, sgd, whole
from acf_tpu_torch.train.trainer import _data_parallel, _mean_stats
from acf_tpu_torch.utils.tree import tree_map


def gumbel(u):
    """Gumbel noise from uniforms ``u`` in [0, 1), as the reference draws it
    (APL.py:42-47): −log(−log(u + 1e-20) + 1e-20)."""
    return -torch.log(-torch.log(u + EPS) + EPS)


def gumbel_softmax(u, probs, temperature):
    """softmax((log(probs + 1e-20) + gumbel(u)) / T): the input is a
    probability vector, not logits (APL.py:42-47)."""
    return torch.softmax((torch.log(probs + EPS) + gumbel(u)) / temperature, dim=-1)


def membership(hist_rows, num_items: int):
    """[B, I] uint8: 1 at each user's unique positives (set semantics, so a
    duplicate history entry counts once), the pad column 0 left at 0; and
    nuniq [B] float32, the count of ones, at least 1."""
    member = torch.zeros(hist_rows.shape[0], num_items, dtype=torch.uint8,
                         device=hist_rows.device)
    member.scatter_(1, hist_rows.long(), (hist_rows != 0).to(torch.uint8))
    nuniq = torch.clamp(member.sum(dim=1, dtype=torch.float32), min=1.0)
    return member, nuniq


@dataclasses.dataclass(eq=False)
class APL(PairwiseModel):
    lr: float = 0.05
    loss_function: str = "log"   # 'log' | 'wgan' | 'hinge' (APL.py:62)
    reg_g: float = 0.0           # regs[0] (APL.py:61)
    reg_c: float = 0.05          # regs[1]
    temperature: float = 0.2
    p_aux_weight: float = 0.2    # APL.py:196, 250-252

    # the p_aux mixture reads the history as a set of positives: the trainer
    # must not truncate it with membership_len
    uses_full_hist = True
    repr_reads_table = False  # the user representation is P_g's row

    def __post_init__(self):
        if self.loss_function not in ("log", "wgan", "hinge"):
            raise ValueError(f"apl loss_function {self.loss_function!r} not "
                             "in ('log', 'wgan', 'hinge')")

    def init_params(self, generator: torch.Generator, device=None):
        """Both players' tables uniform in ±0.05, drawn in the order g/P,
        g/Q, c/P, c/Q."""
        dev = resolve_device(device)

        def uniform(rows):
            x = torch.empty((rows, self.dim), dtype=torch.float32, device=generator.device)
            return x.uniform_(-0.05, 0.05, generator=generator).to(dev)

        g = {"P": uniform(self.num_users), "Q": uniform(self.num_items)}
        c = {"P": uniform(self.num_users), "Q": uniform(self.num_items)}
        return {"g": g, "c": c}

    def init_opt_state(self, optimizer, params):
        """Separate SGD(lr) states for the two players (the trainer's
        optimizer is not used, as in the JAX package)."""
        opt = sgd(self.lr)
        return {"g": opt.init(params["g"]), "c": opt.init(params["c"])}

    def opt_state_rows(self, optimizer, rows):
        """Where each leaf of :meth:`init_opt_state` lives (the
        optimizers' ``state_rows``)."""
        opt = sgd(self.lr)
        return {"g": opt.state_rows(rows["g"]), "c": opt.state_rows(rows["c"])}

    # evaluation ranks with the generator (APL.py:205-211)
    def score_all(self, params, users, hists):
        return params["g"]["P"][users] @ params["g"]["Q"].T

    def score_some(self, params, users, hists, items):
        return torch.einsum("bd,bmd->bm", params["g"]["P"][users], params["g"]["Q"][items])

    def factored_scorer(self):
        if not hasattr(self, "_fs"):
            def user_repr(params, users, hists):
                return params["g"]["P"][users]

            def table(params):
                return params["g"]["Q"], None

            self._fs = (user_repr, table)
        return self._fs

    def loss(self, params, batch, generator=None):
        """BPR on the generator, mean over the batch; aux ``loss`` and ``acc``."""
        users, pos, neg = batch
        g = params["g"]
        ps = torch.sum(g["P"][users] * g["Q"][pos], dim=-1)
        ns = torch.sum(g["P"][users] * g["Q"][neg], dim=-1)
        loss = self.data_share(torch.mean(softplus(-(ps - ns))))
        return loss, {"loss": loss,
                      "acc": self.data_share(torch.mean((ps > ns).to(torch.float32)))}

    def _losses(self, real, fake, g_l2, c_l2):
        """(gen_loss, critic_loss) per APL.py:157-184; under a mesh each mean
        over the batch is the rank's share (the l2 terms are as given)."""
        y = real - fake

        def mean(x):
            return self.data_share(torch.mean(x))

        if self.loss_function == "wgan":
            return -mean(fake) + self.reg_g * g_l2, mean(-y)
        if self.loss_function == "hinge":
            hinge = mean(torch.clamp(1.0 - y, min=0.0))
            return -hinge + self.reg_g * g_l2, hinge + self.reg_c * c_l2
        # log loss (stable): log σ(y) = −softplus(−y)
        return (mean(-softplus(-y)) + self.reg_g * g_l2,
                mean(softplus(-y)) + self.reg_c * c_l2)

    # -- the two steps -------------------------------------------------------------
    def critic_loss(self, c_params, g_params, users, items, u):
        """The critic's loss (APL.py:120-184) on one batch, with the
        generator fixed: its fake item is gumbel_softmax(softmax(logits /
        T)) from the uniforms ``u`` [B, I], a constant here, the pad column
        0 masked; the user rows are counted twice in the l2 term, as the
        reference accumulates them in both scopes (APL.py:132, 140)."""
        pu = c_params["P"][users]
        qi = c_params["Q"][items]
        real = torch.sum(pu * qi, dim=-1)
        with torch.no_grad():
            logits = g_params["P"][users] @ g_params["Q"].T
            logits[:, 0] = NEG
            onehot = gumbel_softmax(u, torch.softmax(logits / self.temperature, dim=-1),
                                    self.temperature)
        fake_emb = onehot @ c_params["Q"]
        fake = torch.sum(pu * fake_emb, dim=-1)
        c_l2 = (2 * torch.sum(torch.square(pu)) + torch.sum(torch.square(qi))
                + torch.sum(torch.square(fake_emb))) / 2
        return self._losses(real, fake, 0.0, c_l2)[1]

    def critic_step(self, c_params, c_state, g_params, users, items, u, reduce=None,
                    optimizer=None):
        """One SGD step of the critic (``optimizer``, default SGD(lr); a
        :class:`~acf_tpu_torch.train.optim.Sharded` one under sharded
        storage), its gradient through ``reduce`` when given (the sum over
        the data ranks), ``g_params`` whole; returns (c_params, c_state,
        loss)."""
        c_params, c_state, loss, _ = grad_update(
            sgd(self.lr) if optimizer is None else optimizer, c_params, c_state,
            lambda prm: (self.critic_loss(prm, g_params, users, items, u), None), reduce)
        if self.loss_function == "wgan":
            c_params = tree_map(lambda x: torch.clamp(x, -0.05, 0.05), c_params)
        return c_params, c_state, loss

    def gen_step(self, g_params, c_params, users, items, hist_rows, gnoise):
        """The generator's loss and gradients ``{"P", "Q"}`` on one batch
        against the fixed critic (``gen_step_manual``'s closed form), with
        the Gumbel noise ``gnoise`` [B, I]: K3a–K3c, a = ∂L/∂fake through
        the [B] loss head, K3d–K3e. Under a mesh the B rows are this data
        rank's, the loss is its share and the gradients are the global
        batch's: the scattered P rows and K3e's Q partial summed over the
        data ranks, then ``reg_g`` times the whole Q added once."""
        w, T = self.p_aux_weight, self.temperature
        pu_g = g_params["P"][users]
        Qg = g_params["Q"]
        pu_c = c_params["P"][users]
        Qc = c_params["Q"]
        member, nuniq = membership(hist_rows, self.num_items)
        fake, res = apl_gen_forward(pu_g, Qg, pu_c, Qc, member, nuniq, gnoise, w=w,
                                    temperature=T)
        real = torch.sum(pu_c * Qc[items], dim=-1)
        with torch.enable_grad():
            f = fake.detach().requires_grad_(True)
            g_main = self._losses(real, f, 0.0, 0.0)[0]
            (a,) = torch.autograd.grad(g_main, f)
        dP_rows, dQ = apl_gen_backward(pu_g, pu_c, nuniq, a, res, w=w, temperature=T)
        grads = {"P": scatter_rows(g_params["P"].shape[0], users, dP_rows + self.reg_g * pu_g),
                 "Q": dQ}
        if self.data_mesh is not None:
            grads = all_reduce_tree(self.data_mesh, grads, "data")
        grads["Q"] = grads["Q"] + self.reg_g * Qg
        g_l2 = (torch.sum(torch.square(pu_g)) + self.data_share(torch.sum(torch.square(Qg)))) / 2
        return g_main.detach() + self.reg_g * g_l2, grads

    def make_epoch_fn(self, optimizer, batch_size: int, num_batches: int, dev=None,
                      mesh=None):
        """``epoch_fn(params, opt_state, data, generator, batches=None,
        critic_u=None, gen_u=None) -> (params, opt_state, stats)``: every
        critic step on the epoch's batches with the generator fixed, then
        every generator step against the new critic. ``batches``
        [num_batches, B] (pair indices) and the uniforms ``critic_u`` and
        ``gen_u`` [num_batches, B, I] replace the draws from ``generator``
        when given; otherwise each step draws its [B, I] uniforms when it
        runs. Stats: the mean generator ``loss``, the mean critic
        ``d_loss`` and ``acc`` 0, as the JAX epoch reports them. With
        ``mesh`` (``self`` then :func:`~acf_tpu_torch.models.base.
        data_parallel`'s copy) the batches and uniforms are the global
        batch's and each step takes this data rank's rows. Under sharded
        storage (``optimizer`` a :class:`~acf_tpu_torch.train.optim.Sharded`)
        each phase reads the fixed player's leaves gathered once and the
        stepping player's gathered each step; K3e's dQ_g, whole, is cut to
        the rank's rows by the update."""
        rows, reduce = _data_parallel(mesh, batch_size)
        opt_g, opt_c = (player(optimizer, k, sgd(self.lr)) for k in ("g", "c"))

        def epoch_fn(params, opt_state, data, generator, batches=None, critic_u=None,
                     gen_u=None):
            def uniforms(given, step):
                if given is not None:
                    return given[step]
                return torch.rand((batch_size, self.num_items), generator=generator,
                                  device=generator.device)

            if batches is None:
                batches = sample_pair_epoch(generator, data["pairs_u"].shape[0], batch_size,
                                            num_batches)
            steps = [(data["pairs_u"][idx[rows]], data["pairs_i"][idx[rows]])
                     for idx in batches]
            g_params, c_params = params["g"], params["c"]
            g_state, c_state = opt_state["g"], opt_state["c"]
            d_loss = 0.0
            g_fixed = whole(opt_g, g_params)
            for step, (u, i) in enumerate(steps):
                c_params, c_state, cl = self.critic_step(
                    c_params, c_state, g_fixed, u, i, uniforms(critic_u, step)[rows], reduce,
                    opt_c)
                d_loss = d_loss + cl
            del g_fixed
            c_fixed = whole(opt_c, c_params)
            g_loss = 0.0
            with torch.no_grad():
                for step, (u, i) in enumerate(steps):
                    gl, grads = self.gen_step(whole(opt_g, g_params), c_fixed, u, i,
                                              data["hist"][u],
                                              gumbel(uniforms(gen_u, step)[rows]))
                    g_params, g_state = opt_g.update(grads, g_state, g_params)
                    g_loss = g_loss + gl
            stats = _mean_stats({"loss": g_loss, "d_loss": d_loss}, num_batches, mesh)
            return ({"g": g_params, "c": c_params}, {"g": g_state, "c": c_state},
                    dict(stats, acc=0.0))

        return epoch_fn
