"""SASRec and its adversarial variants (ASASRec / ASASRec2): the port of
``acf_tpu/models/sasrec.py``, inference and training.

The hyperparameter fields match the JAX dataclass (the TPU-only routing
fields ``fused`` and ``pack_attention`` excepted) so configurations carry
across. ``train_dtype="bfloat16"`` runs the training path's encoder (the
loss, the FGSM linearisation and asasrec2's adversarial pass) in the JAX
kernel's bfloat16 form, ``SASRec(fused="always", train_dtype="bfloat16")``:
each product takes bfloat16 operands and sums in float32, while LayerNorm,
softmax, dropout, biases and the residual stream stay float32 (the K2a and
K2b kernels' bfloat16 forms on CUDA). Evaluation and serving (``encode``,
``score_all``, ``score_some``, the factored scorer) run float32 whatever
``train_dtype`` is, as in the JAX package.

Routing: on a CUDA tensor every window goes to
:func:`acf_tpu_torch.ops.sasrec_fused.fused_encoder`: the K2a kernel
forward and, when a gradient is taken, the K2b kernel backward. They take
one head, any width 1 <= d <= 128 and, in training as in serving, every
window up to ``max_window(d)`` (200 up to d = 68, 108 at d = 128). A shape
the kernels do not take raises ``ValueError``; there is no other path. On a
CPU tensor a single-head encoder runs the same function's plain versions
(the hand-derived backward included); a multi-head one runs
:meth:`SASRec.encode_math` under autograd. A serving window is the last
``maxlen`` history items, ``hists[:, -maxlen:]``, never padded: a history
narrower than ``maxlen`` gives a window of its own width. Training windows
come from the sampler, left-padded to ``maxlen`` as the JAX sampler pads
them.

Randomness: every function that draws takes a :class:`torch.Generator`
(dropout masks are drawn on its device) or the masks themselves (``masks``
for the training pass, ``adv_masks`` for asasrec2's adversarial encoder
pass), so a test can hand it the JAX package's exact draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import SequenceModel, project_rows, row_normalize, softplus
from acf_tpu_torch.nn.layers import glorot_uniform, init_dense, init_layer_norm, trunc_normal
from acf_tpu_torch.ops.sasrec_fused import encoder_math, fused_encoder
from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _tf_l2_normalize(x, eps: float = 1e-12):
    """tf.nn.l2_normalize semantics: axis=1 for matrices (rows), all axes for
    vectors (reference SASRec.py:371, 382-386)."""
    if x.dim() >= 2:
        sq = torch.sum(torch.square(x), dim=1, keepdim=True)
    else:
        sq = torch.sum(torch.square(x))
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


@dataclasses.dataclass(eq=False)
class SASRec(SequenceModel):
    """Self-attentive sequential recommendation.

    Defaults follow the reference (SASRec.py:33-36, run_adv_ori.py):
    hidden = dim, 2 blocks, 1 head, dropout 0.5, trained with
    Adam(lr=1e-3, b2=0.98).
    """

    num_blocks: int = 2
    num_heads: int = 1
    dropout_rate: float = 0.5
    l2_emb: float = 0.0
    # adversarial config
    adversarial: bool = False
    adv_mode: str = "asasrec"  # or "asasrec2"
    eps: float = 0.5
    reg_adv: float = 1.0
    eps_pos: float = 0.0    # run_adv_ori.py --eps_pos (asasrec2)
    eps_dense: float = 0.0  # run_adv_ori.py --eps_dense
    eps_conv: float = 0.0   # run_adv_ori.py --eps_conv
    adv_steps: int = 1      # >1 = PGD-style multi-step perturbation
    train_dtype: str = "float32"  # or "bfloat16": the training path's encoder compute dtype

    def init_params(self, generator: torch.Generator, device=None):
        """The JAX tree: ``item_emb`` (truncnormal 0.01, pad row 0 zero),
        ``pos_emb`` (glorot), ``blocks[i].{ln1,wq,wk,wv,ln2,conv1,conv2,ln3}``
        and ``ln_f``. Drawn on the generator's device, then moved."""
        dev = resolve_device(device)
        d = self.dim
        item = trunc_normal(generator, (self.num_items, d), 0.01)
        item[0] = 0.0
        params = {
            "item_emb": item,
            "pos_emb": glorot_uniform(generator, (self.maxlen, d)),
            "blocks": [],
            "ln_f": init_layer_norm(d, generator.device),
        }
        for _ in range(self.num_blocks):
            params["blocks"].append({
                "ln1": init_layer_norm(d, generator.device),
                "wq": init_dense(generator, d, d),
                "wk": init_dense(generator, d, d),
                "wv": init_dense(generator, d, d),
                "ln2": init_layer_norm(d, generator.device),
                "conv1": init_dense(generator, d, d),
                "conv2": init_dense(generator, d, d),
                "ln3": init_layer_norm(d, generator.device),
            })
        return tree_map(lambda x: x.to(dev), params)

    def _compute_dtype(self):
        """The training path's compute dtype: None (float32) or bfloat16."""
        if self.train_dtype in ("float32", "f32"):
            return None
        if self.train_dtype == "bfloat16":
            return torch.bfloat16
        raise ValueError(f"train_dtype is float32 or bfloat16, not {self.train_dtype!r}")

    # ------------------------------------------------------------------
    def _dropout_masks(self, generator: torch.Generator, b: int, t: int):
        """Bool keep-masks (True = kept, probability 1 - dropout_rate) drawn
        on the generator's device, in the shapes of the JAX package's
        ``_dropout_masks`` (``acf_tpu/models/sasrec.py:166-191``, pack 1):
        ``emb`` [B, T, d]; per block ``p`` [B, H, T, T], ``f1`` and ``f2``
        [B, T, d]."""
        if generator is None:
            raise ValueError("dropout needs a torch.Generator or injected masks")
        keep = 1.0 - self.dropout_rate
        dev = generator.device

        def m(*shape):
            return torch.rand(shape, generator=generator, device=dev) < keep

        d, h = self.dim, self.num_heads
        return {"emb": m(b, t, d),
                "blocks": [{"p": m(b, h, t, t), "f1": m(b, t, d), "f2": m(b, t, d)}
                           for _ in range(self.num_blocks)]}

    def train_masks(self, generator, batch):
        """The training pass's masks, then asasrec2's adversarial pass's, of
        ``batch``'s windows (none without dropout)."""
        if self.dropout_rate <= 0.0:
            return None, None
        b = batch[0].shape[0]
        masks = self._dropout_masks(generator, b, self.maxlen)
        adv = (self._dropout_masks(generator, b, self.maxlen)
               if self.adversarial and self.adv_mode == "asasrec2" else None)
        return masks, adv

    def encode(self, params, seq, train: bool = False, generator=None, masks=None):
        """[B, T] item ids → [B, T, d] sequence representations."""
        x = params["item_emb"][seq] * math.sqrt(self.dim)  # √d scale (SASRecLayers.py:129-130)
        return self.encode_core(params, x, seq != 0, train=train, generator=generator,
                                masks=masks)

    def encode_core(self, params, x, ids_mask, train: bool = False, generator=None,
                    masks=None, dtype=None):
        """Encoder from √d-scaled input embeddings [B, T, d] and the ids mask
        [B, T], its products in compute dtype ``dtype`` (None: float32; the
        training path passes :meth:`_compute_dtype`). With ``train`` (and
        dropout) the masks are ``masks`` or drawn from ``generator``. CUDA:
        the K2a/K2b kernels through :func:`fused_encoder` (``ValueError``
        beyond their limits); CPU: their plain versions, or
        :meth:`encode_math` for several heads."""
        if not (train and self.dropout_rate > 0.0):
            masks = None
        elif masks is None:
            masks = self._dropout_masks(generator, x.shape[0], x.shape[1])
        if x.device.type == "cpu" and self.num_heads != 1:
            return self.encode_math(params, x, ids_mask, masks, dtype)
        return fused_encoder(self, params, x, ids_mask, masks, dtype)

    def encode_math(self, params, x, ids_mask, masks=None, dtype=None):
        """The plain encoder (any ``num_heads``) given the dropout masks
        (None = inference), in compute dtype ``dtype``."""
        return encoder_math(params, x, ids_mask, self.num_heads, masks,
                            1.0 - self.dropout_rate, dtype)

    # ------------------------------------------------------------------
    def _pointwise_loss_rows(self, reprs, pos_e, neg_e, pos):
        """Per-position sigmoid CE over (pos, neg) target rows
        (SASRec.py:183-191), in stable softplus form; returns (loss, auc)."""
        pos_logit = torch.sum(pos_e * reprs, -1)
        neg_logit = torch.sum(neg_e * reprs, -1)
        ist = (pos != 0).to(torch.float32)
        n = torch.clamp(self.data_sum(ist.sum()), min=1.0)  # the global count
        loss = (torch.sum(softplus(-pos_logit) * ist)
                + torch.sum(softplus(neg_logit) * ist)) / n
        auc = torch.sum(((torch.sign(pos_logit - neg_logit) + 1) / 2) * ist) / n
        return loss, auc.detach()

    def _embed_rows(self, item_emb, seq, pos, neg):
        """One [B, 3T] gather for the encoder input and the pos/neg rows."""
        t = seq.shape[1]
        rows = item_emb[torch.cat([seq, pos, neg], dim=1)]
        return rows[:, :t], rows[:, t:2 * t], rows[:, 2 * t:]

    def _window_rows(self, item_emb, window, neg):
        """One [B, 2T+1] gather for the packed sampler form: the seq and pos
        row sets share the window rows."""
        t = neg.shape[1]
        rows = item_emb[torch.cat([window, neg], dim=1)]
        return rows[:, :t], rows[:, 1:t + 1], rows[:, t + 1:]

    def _clean_loss_fn(self, params, seq, pos, neg):
        """No-dropout clean loss — the FGSM linearization point
        (SASRec.py:453-454 runs the delta update with is_training=False)."""
        seq_e, pos_e, neg_e = self._embed_rows(params["item_emb"], seq, pos, neg)
        reprs = self.encode_core(params, seq_e * math.sqrt(self.dim), seq != 0,
                                 dtype=self._compute_dtype())
        return self._pointwise_loss_rows(reprs, pos_e, neg_e, pos)[0]

    def _clean_loss_fn_window(self, params, window, neg):
        """`_clean_loss_fn` in packed-window form."""
        seq, pos = window[:, :-1], window[:, 1:]
        seq_e, pos_e, neg_e = self._window_rows(params["item_emb"], window, neg)
        reprs = self.encode_core(params, seq_e * math.sqrt(self.dim), seq != 0,
                                 dtype=self._compute_dtype())
        return self._pointwise_loss_rows(reprs, pos_e, neg_e, pos)[0]

    def adv_target_loss(self, params, batch, generator=None):
        """FGSM linearization target: the no-dropout pointwise loss WITHOUT
        the l2_emb regularizer (SASRec.py:365-371, 453-454)."""
        users, seq, pos, neg = batch
        return self._clean_loss_fn(params, seq, pos, neg)

    def primary_loss(self, loss, aux):
        """The returned loss: aux values are detached, and without the
        adversary (which the FGSM wrapper refuses) ``aux["loss"]`` is this
        loss's value, ``l2_emb`` term included, as in the JAX package."""
        return loss

    def _eps_tree(self, params):
        """Per-leaf perturbation radii: 0.0 for leaves the protocol leaves
        clean (the reference assigns dense deltas ONLY for the Q projection,
        SASRec.py:378-387)."""
        eps = tree_map(lambda _: 0.0, params)
        eps["item_emb"] = self.eps
        if self.adv_mode == "asasrec2":
            if self.eps_pos:
                eps["pos_emb"] = self.eps_pos
            for bi in range(self.num_blocks):
                if self.eps_dense:
                    eps["blocks"][bi]["wq"] = {"w": self.eps_dense, "b": self.eps_dense}
                if self.eps_conv:
                    for name in ("conv1", "conv2"):
                        eps["blocks"][bi][name] = {"w": self.eps_conv, "b": self.eps_conv}
        return eps

    def _fgsm_emb_grad(self, loss_fn, params, *batch):
        """The dense item-table gradient of ``loss_fn`` at the clean point,
        with every other leaf constant: the encoder's backward computes dx
        alone (K2b's dx-only mode on CUDA). Under a mesh, summed over the
        data ranks."""
        emb = params["item_emb"].detach().requires_grad_(True)
        prm_c = tree_map(lambda x: x.detach(), params)
        prm_c["item_emb"] = emb
        with torch.enable_grad():
            return self.data_sum(torch.autograd.grad(loss_fn(prm_c, *batch), emb)[0])

    def _delta_tree(self, params, seq, pos, neg):
        """FGSM deltas as a zero-filled copy of ``params`` with perturbed
        leaves set (SASRec.py:368-404). ``adv_steps>1`` iterates PGD-style:
        step ε/adv_steps per leaf, gradient re-taken at the perturbed point,
        per-leaf projection back into its ε-ball. Constant under the outer
        gradient."""
        params = tree_map(lambda x: x.detach(), params)
        eps = self._eps_tree(params)
        names = [i for i, e in enumerate(tree_leaves(eps)) if e != 0.0]

        def project(d, e):
            if e == 0.0:
                return torch.zeros_like(d)
            return project_rows(d, e, dim=1 if d.dim() >= 2 else None)

        delta = tree_map(torch.zeros_like, params)
        for _ in range(self.adv_steps):
            shifted = tree_map(torch.add, params, delta)
            leaves = tree_leaves(shifted)
            wanted = [leaves[i].requires_grad_(True) for i in names]
            with torch.enable_grad():
                got = torch.autograd.grad(self._clean_loss_fn(shifted, seq, pos, neg), wanted)
            grads = [torch.zeros_like(x) for x in leaves]
            for i, gl in zip(names, got):
                grads[i] = self.data_sum(gl)
            g = tree_unflatten(params, grads)
            delta = tree_map(
                lambda d, gl, e: project(d + (e / self.adv_steps) * _tf_l2_normalize(gl), e),
                delta, g, eps)
        return delta

    def loss_window(self, params, batch, generator=None, masks=None, adv_masks=None):
        """Packed-window training loss: the value of ``loss`` on the
        expanded batch. The asasrec2 / PGD paths delegate to the expansion."""
        if self.adversarial and (self.adv_mode == "asasrec2" or self.adv_steps != 1):
            return super().loss_window(params, batch, generator, masks=masks,
                                       adv_masks=adv_masks)
        users, window, neg = batch
        seq, pos = window[:, :-1], window[:, 1:]
        seq_e, pos_e, neg_e = self._window_rows(params["item_emb"], window, neg)
        reprs = self.encode_core(params, seq_e * math.sqrt(self.dim), seq != 0, train=True,
                                 generator=generator, masks=masks, dtype=self._compute_dtype())
        loss, auc = self._pointwise_loss_rows(reprs, pos_e, neg_e, pos)
        if self.l2_emb:
            loss = loss + self.data_share(self.l2_emb * torch.sum(torch.square(params["item_emb"])))
        aux = {"loss": loss.detach(), "acc": auc}
        if self.adversarial:
            g_emb = self._fgsm_emb_grad(self._clean_loss_fn_window, params, window, neg)
            loss = self._hot_path_adv(loss, aux, g_emb, reprs, pos_e, neg_e, pos, neg)
        return loss, aux

    def _hot_path_adv(self, loss, aux, g_emb, reprs, pos_e, neg_e, pos, neg):
        """The reference asasrec FGSM (SASRec.py:356-363): the perturbed table
        is read only at the pos/neg rows of the logit layer (the encoder stays
        clean), and row-wise l2-normalize commutes with the row gather."""
        t = pos.shape[1]
        g_rows = g_emb[torch.cat([pos, neg], dim=1)]
        pos_adv = pos_e + self.eps * row_normalize(g_rows[:, :t])
        neg_adv = neg_e + self.eps * row_normalize(g_rows[:, t:])
        adv_loss, adv_auc = self._pointwise_loss_rows(reprs, pos_adv, neg_adv, pos)
        aux["loss_adv"] = adv_loss.detach()
        aux["acc_adv"] = adv_auc
        return loss + self.reg_adv * adv_loss

    def loss(self, params, batch, generator=None, masks=None, adv_masks=None):
        """Training loss on ``(users, seq, pos, neg)``; returns (loss, aux)
        with aux ``loss``/``acc`` (and ``loss_adv``/``acc_adv``) detached."""
        users, seq, pos, neg = batch
        seq_e, pos_e, neg_e = self._embed_rows(params["item_emb"], seq, pos, neg)
        reprs = self.encode_core(params, seq_e * math.sqrt(self.dim), seq != 0, train=True,
                                 generator=generator, masks=masks, dtype=self._compute_dtype())
        loss, auc = self._pointwise_loss_rows(reprs, pos_e, neg_e, pos)
        if self.l2_emb:
            loss = loss + self.data_share(self.l2_emb * torch.sum(torch.square(params["item_emb"])))
        aux = {"loss": loss.detach(), "acc": auc}
        if not self.adversarial:
            return loss, aux
        if self.adv_mode != "asasrec2" and self.adv_steps == 1:
            g_emb = self._fgsm_emb_grad(self._clean_loss_fn, params, seq, pos, neg)
            return self._hot_path_adv(loss, aux, g_emb, reprs, pos_e, neg_e, pos, neg), aux
        delta = self._delta_tree(params, seq, pos, neg)
        emb_plus = params["item_emb"] + delta["item_emb"]
        if self.adv_mode == "asasrec2":
            adv_params = tree_map(torch.add, params, delta)
            aseq_e, apos_e, aneg_e = self._embed_rows(emb_plus, seq, pos, neg)
            adv_reprs = self.encode_core(adv_params, aseq_e * math.sqrt(self.dim), seq != 0,
                                         train=True, generator=generator, masks=adv_masks,
                                         dtype=self._compute_dtype())
        else:
            adv_reprs = reprs  # clean encoder (SASRec.py:356-363)
            t = seq.shape[1]
            rows = emb_plus[torch.cat([pos, neg], dim=1)]
            apos_e, aneg_e = rows[:, :t], rows[:, t:]
        adv_loss, adv_auc = self._pointwise_loss_rows(adv_reprs, apos_e, aneg_e, pos)
        aux["loss_adv"] = adv_loss.detach()
        aux["acc_adv"] = adv_auc
        return loss + self.reg_adv * adv_loss, aux

    # ------------------------------------------------------------------
    def _last_repr(self, params, hists):
        """[B, d] representation at the last position of each window."""
        return self.encode(params, hists[:, -self.maxlen:])[:, -1, :]

    def score_all(self, params, users, hists):
        """Full-catalog scores from each user's last-position representation
        (reference test_logits, SASRec.py:176-181)."""
        return self._last_repr(params, hists) @ params["item_emb"].T

    def score_some(self, params, users, hists, items):
        reprs = self._last_repr(params, hists)
        return torch.einsum("bd,bmd->bm", reprs, params["item_emb"][items])

    def factored_scorer(self):
        if not hasattr(self, "_fs"):
            def user_repr(params, users, hists):
                return self._last_repr(params, hists)

            def table(params):
                return params["item_emb"], None

            self._fs = (user_repr, table)
        return self._fs

