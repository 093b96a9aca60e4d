"""Recurrent cells over param dicts (counterpart of ``acf_tpu/nn/rnn.py``).

TF1's ``rnn_cell.GRUCell`` / ``BasicRNNCell`` and Keras ``SimpleRNN``
(reference GRU4Rec.py:181-187, DREAM.py:24/109-116) written by hand: TF's
GRU is not ``torch.nn.GRU``. Its candidate sees ``r * h`` before the
product, ``c = act([x, r * h] W_c + b_c)``, the gates are one
``[d_in + d_h, 2 d_h]`` kernel split as (r, u) with bias 1.0, and
``h' = u * h + (1 - u) * c``; PyTorch and cuDNN apply ``r`` after
``W_hn h + b_hn``, in another weight layout. Sequences are right-aligned
and 0-padded, and a pad step keeps the state (Keras ``mask_zero``), which
packed cuDNN sequences do not give. :func:`run_rnn` is a Python loop of T
steps.
"""

from __future__ import annotations

import torch

from acf_tpu_torch.nn.layers import glorot_uniform


def init_gru(generator: torch.Generator, d_in: int, d_h: int):
    """TF GRUCell layout: one [d_in+d_h, 2*d_h] gate kernel (r, u) and one
    [d_in+d_h, d_h] candidate kernel; gate bias 1.0 (TF default)."""
    dev = generator.device
    return {
        "w_gates": glorot_uniform(generator, (d_in + d_h, 2 * d_h)),
        "b_gates": torch.ones(2 * d_h, device=dev),
        "w_cand": glorot_uniform(generator, (d_in + d_h, d_h)),
        "b_cand": torch.zeros(d_h, device=dev),
    }


def gru_cell(p, x, h, activation=torch.tanh):
    """One GRU step (TF semantics: the candidate sees r * h)."""
    gates = torch.sigmoid(torch.cat([x, h], dim=-1) @ p["w_gates"] + p["b_gates"])
    r, u = gates.chunk(2, dim=-1)
    c = activation(torch.cat([x, r * h], dim=-1) @ p["w_cand"] + p["b_cand"])
    return u * h + (1.0 - u) * c


def init_simple_rnn(generator: torch.Generator, d_in: int, d_h: int):
    """Keras SimpleRNN: kernel glorot, recurrent kernel orthogonal, zero
    bias."""
    w_in = glorot_uniform(generator, (d_in, d_h))
    q, r = torch.linalg.qr(torch.randn(d_h, d_h, generator=generator,
                                       device=generator.device))
    # Keras Orthogonal applies sign(diag(R)) so the draw is Haar-uniform;
    # plain qr()[0] has sign-biased columns
    return {"w_in": w_in, "w_rec": q * torch.sign(torch.diagonal(r))[None, :],
            "b": torch.zeros(d_h, device=generator.device)}


def simple_rnn_cell(p, x, h):
    return torch.tanh(x @ p["w_in"] + h @ p["w_rec"] + p["b"])


def run_rnn(cell, p, xs, mask, h0):
    """Run a cell over time with pad masking.

    Args:
      cell: fn(p, x_t [B, d_in], h [B, d_h]) -> h'
      xs:   [B, T, d_in]
      mask: [B, T] bool; False positions keep the previous state.
      h0:   [B, d_h]

    Returns:
      (h_final [B, d_h], hs [B, T, d_h]): the state after each step.
    """
    h, hs = h0, []
    for t in range(xs.shape[1]):
        h = torch.where(mask[:, t, None], cell(p, xs[:, t], h), h)
        hs.append(h)
    return h, torch.stack(hs, dim=1)
