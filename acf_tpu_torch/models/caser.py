"""Caser: Convolutional Sequence Embedding Recommendation (the port of
``acf_tpu/models/caser.py``).

Reference Caser.py:14-325: the last L items embedded as an L×d "image";
horizontal convolutions (one height per length 1..L, ``n_h`` filters each,
ReLU, max over time) and a vertical convolution (``n_v`` filters over the
time axis) feed a fully-connected layer; the user representation
``[z ; user_emb]`` scores items through the output table ``W2`` and bias
``b2``. Pointwise sigmoid loss over ``target_len`` targets and as many
uniform negatives per sliding window (Caser.py:33-91, 152-158).

The convolutions are products: the vertical one over time, each
horizontal one over its unfolded windows of ``l * d`` values (the kernel
``conv_h[l-1]["w"]`` keeps the JAX layout [l, d, n_h], so either package's
files load). Scores factor as ``[z ; user_emb] · W2 + b2``, so evaluation
goes through K1. Training runs on the sliding windows of
:meth:`extra_device_data` through the model's own epoch
(:meth:`make_epoch_fn`); dropout masks are drawn from a
:class:`torch.Generator` or injected.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acf_tpu_torch.data import native_io
from acf_tpu_torch.data.datasets import Interactions
from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.models.base import SequenceModel, softplus
from acf_tpu_torch.nn.layers import dropout, glorot_uniform
from acf_tpu_torch.sampling.negatives import (
    negatives_from_draws, sample_pair_epoch, uniform_negatives,
)
from acf_tpu_torch.train.optim import grad_update
from acf_tpu_torch.train.trainer import _add_stats, _data_parallel, _mean_stats
from acf_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(eq=False)
class Caser(SequenceModel):
    n_h: int = 16         # horizontal filters per length (Caser.py:231)
    n_v: int = 4          # vertical filters (Caser.py:232)
    dropout_rate: float = 0.5
    target_len: int = 3   # targets per window (Caser.py:68)

    @property
    def num_features(self) -> int:
        """Width of the convolutions' output, where dropout applies."""
        return self.n_v * self.dim + self.n_h * self.maxlen

    def init_params(self, generator: torch.Generator, device=None):
        """The torch reference's init (Caser.py:261-264): embeddings
        normal(0, 1/d), ``W2`` normal(0, 1/(2d)), zero biases; glorot
        convolution and fc1 kernels."""
        dev = resolve_device(device)
        d, L, g = self.dim, self.maxlen, generator

        def normal(*shape):
            return torch.randn(shape, generator=g, device=g.device)

        params = {
            "user_emb": normal(self.num_users, d) / d,
            "item_emb": normal(self.num_items, d) / d,
            "conv_v_w": glorot_uniform(g, (L, self.n_v)),
            "conv_v_b": torch.zeros(self.n_v, device=g.device),
            "conv_h": [],
            "fc1_w": glorot_uniform(g, (self.num_features, d)),
            "fc1_b": torch.zeros(d, device=g.device),
            "W2": normal(self.num_items, 2 * d) / (2 * d),
            "b2": torch.zeros(self.num_items, device=g.device),
        }
        for l in range(1, L + 1):
            params["conv_h"].append({
                "w": glorot_uniform(g, (l * d, self.n_h)).reshape(l, d, self.n_h),
                "b": torch.zeros(self.n_h, device=g.device),
            })
        return tree_map(lambda x: x.to(dev), params)

    # ------------------------------------------------------------------
    def dropout_masks(self, generator: torch.Generator, batch):
        """Keep-mask [B, num_features] of one training pass (True = kept,
        probability 1 - dropout_rate), drawn on the generator's device."""
        if generator is None:
            raise ValueError("dropout needs a torch.Generator or injected masks")
        shape = (batch[0].shape[0], self.num_features)
        return torch.rand(shape, generator=generator, device=generator.device) \
            < 1.0 - self.dropout_rate

    def _user_repr(self, params, seq, users, train: bool = False, generator=None,
                   masks=None):
        """[B, L] window + users → [B, 2d] representation ``[z ; P_u]``;
        with ``train``, dropout on the convolutions' output (``masks`` or
        drawn from ``generator``)."""
        E = params["item_emb"][seq]  # [B, L, d]
        b, L, d = E.shape
        # vertical conv: a weighted sum over time per filter (Caser.py:241)
        out_v = torch.einsum("bld,lv->bvd", E, params["conv_v_w"]) \
            + params["conv_v_b"][None, :, None]
        outs = [out_v.reshape(b, self.n_v * d)]
        # horizontal convs: height l over time, relu, max over time
        # (Caser.py:244-304), as products over the unfolded windows
        for l, blk in enumerate(params["conv_h"], start=1):
            win = E.unfold(1, l, 1).transpose(2, 3).reshape(b, L - l + 1, l * d)
            conv = torch.relu(win @ blk["w"].reshape(l * d, self.n_h) + blk["b"])
            outs.append(conv.max(dim=1).values)  # [B, n_h]
        out = dropout(torch.cat(outs, dim=-1), self.dropout_rate, train, generator, masks)
        z = torch.relu(out @ params["fc1_w"] + params["fc1_b"])
        return torch.cat([z, params["user_emb"][users]], dim=-1)

    def _item_scores(self, params, x, items):
        """x [B, 2d] · W2[items] + b2[items]; items [B, M]."""
        return torch.einsum("bd,bmd->bm", x, params["W2"][items]) + params["b2"][items]

    def loss(self, params, batch, generator=None, masks=None):
        """−mean log σ(pos) − mean log(1 − σ(neg)) (Caser.py:152-158) on
        ``(users, seq [B, L], pos [B, M], neg [B, M])``, dropout from
        ``masks`` or ``generator``. Under a mesh this data rank's share: the
        positives' count is the global batch's."""
        users, seq, pos, neg = batch
        x = self._user_repr(params, seq, users, train=True, generator=generator, masks=masks)
        pos_s = self._item_scores(params, x, pos)
        neg_s = self._item_scores(params, x, neg)
        pos_valid = (pos != 0).to(torch.float32)
        n_pos = torch.clamp(self.data_sum(pos_valid.sum()), min=1.0)  # the global count
        loss = (torch.sum(softplus(-pos_s) * pos_valid) / n_pos
                + self.data_share(torch.mean(softplus(neg_s))))
        acc = torch.sum((pos_s > neg_s) * pos_valid) / n_pos
        return loss, {"loss": loss, "acc": acc}

    # ------------------------------------------------------------------
    def extra_device_data(self, data: Interactions):
        """Sliding-window training instances (Caser.py:67-91): every user
        with more than L train items contributes the windows [i, i+L) with
        the following ``target_len`` items as targets, front-padded with 0
        (the native ``caser_windows``). A dataset where no user has that
        many gets one padded window per user with at least two items, its
        last item the target (the JAX package's fallback for tiny data)."""
        L, T = self.maxlen, self.target_len
        users, seqs, tgts = native_io.caser_windows(data.hist, data.hist_len, L, T)
        if len(users) == 0:
            seq_l, us, tgt_l = [], [], []
            for u in range(1, data.num_users):
                if int(data.hist_len[u]) < 2:
                    continue
                h = data.hist[u][-(L + 1):]
                seq_l.append(np.r_[np.zeros(max(L + 1 - len(h), 0), dtype=h.dtype), h][:L])
                tgt_l.append(np.r_[np.zeros(T - 1, dtype=h.dtype), data.hist[u][-1:]])
                us.append(u)
            users = np.array(us, dtype=np.int32)
            seqs = np.stack(seq_l).astype(np.int32)
            tgts = np.stack(tgt_l).astype(np.int32)
        return {"win_seq": seqs, "win_user": users, "win_pos": tgts}

    def make_epoch_fn(self, optimizer, batch_size: int, num_batches: int, dev, mesh=None):
        """``epoch_fn(params, opt_state, data, generator, batches=None,
        cands=None, masks=None) -> (params, opt_state, stats)`` over the
        windows of ``dev``: ``max(n_windows // batch_size, 1)`` steps
        (``num_batches`` is the trainer's pair count and is not used; the
        function's ``num_batches`` attribute holds the count), each on a
        batch of the shuffled windows (wrapped when there are fewer windows
        than a batch), ``target_len`` uniform negatives and one dropout
        mask. ``batches`` [steps, batch_size] (window indices), ``cands``
        [steps, target_len, R, batch_size] (negative candidates) and
        ``masks`` [steps, batch_size, num_features] replace the draws from
        ``generator`` when given, which come in that order within a step.
        With ``mesh`` (``self`` then :func:`~acf_tpu_torch.models.base.
        data_parallel`'s copy) the draws are the global batch's, each step
        takes this data rank's rows and the gradients are summed over the
        data ranks."""
        n_windows = int(dev["win_seq"].shape[0])
        steps = max(n_windows // batch_size, 1)
        rows, reduce = _data_parallel(mesh, batch_size)

        def epoch_fn(params, opt_state, data, generator, batches=None, cands=None,
                     masks=None):
            if batches is None:
                batches = sample_pair_epoch(generator, n_windows, batch_size, steps)
            sums = {}
            for step in range(steps):
                idx = batches[step]
                users = data["win_user"][idx]
                seq, pos = data["win_seq"][idx], data["win_pos"][idx]
                hist_rows = data["hist"][users]
                if cands is None:
                    negs = [uniform_negatives(generator, hist_rows, self.num_items)
                            for _ in range(self.target_len)]
                else:
                    negs = [negatives_from_draws(c, hist_rows) for c in cands[step]]
                batch = (users, seq, pos, torch.stack(negs, dim=1))
                m = self.dropout_masks(generator, batch) if masks is None else masks[step]
                batch = tuple(x[rows] for x in batch)
                params, opt_state, _, aux = grad_update(
                    optimizer, params, opt_state,
                    lambda prm: self.loss(prm, batch, masks=m[rows]), reduce)
                _add_stats(sums, aux)
            return params, opt_state, _mean_stats(sums, steps, mesh)

        epoch_fn.num_batches = steps
        return epoch_fn

    # ------------------------------------------------------------------
    def score_all(self, params, users, hists):
        x = self._user_repr(params, hists[:, -self.maxlen:], users)
        return x @ params["W2"].T + params["b2"]

    def score_some(self, params, users, hists, items):
        x = self._user_repr(params, hists[:, -self.maxlen:], users)
        return self._item_scores(params, x, items)

    def factored_scorer(self):
        if not hasattr(self, "_fs"):
            def user_repr(params, users, hists):
                return self._user_repr(params, hists[:, -self.maxlen:], users)

            def table(params):
                return params["W2"], params["b2"]

            self._fs = (user_repr, table)
        return self._fs
