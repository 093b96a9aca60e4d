"""Shared NN building blocks over param dicts (counterpart of
``acf_tpu/nn/layers.py``).

Random initialisers draw from an explicit :class:`torch.Generator`, on the
generator's device. Their draws differ from ``jax.random``; the
distributions match.
"""

from __future__ import annotations

import math

import torch


def trunc_normal(generator: torch.Generator, shape, std: float = 0.01):
    """tf.truncated_normal semantics: normal(0, std) truncated at ±2σ."""
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(x, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def glorot_uniform(generator: torch.Generator, shape):
    """tf.glorot_uniform_initializer, with TF's fans: for rank > 2 kernels
    the leading dims are the receptive field and multiply both fans."""
    if len(shape) > 2:
        rf = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    elif len(shape) == 2:
        fan_in, fan_out = shape
    else:
        fan_in = fan_out = shape[0]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return x.uniform_(-limit, limit, generator=generator)


def init_layer_norm(dim: int, device=None):
    """LayerNorm params (gamma = 1, beta = 0); draws nothing."""
    return {"beta": torch.zeros(dim, device=device),
            "gamma": torch.ones(dim, device=device)}


def layer_norm(p, x, eps: float = 1e-8):
    """The reference's ``normalize`` (SASRecLayers.py:15-45): mean, then the
    mean of squared deviations, over the last axis; ε inside the sqrt."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return p["gamma"] * (x - mean) / torch.sqrt(var + eps) + p["beta"]


def init_dense(generator: torch.Generator, d_in: int, d_out: int):
    """Dense params: a glorot-uniform [d_in, d_out] kernel and a zero bias."""
    return {"w": glorot_uniform(generator, (d_in, d_out)),
            "b": torch.zeros(d_out, device=generator.device)}


def dense(p, x):
    return x @ p["w"] + p["b"]


def dropout(x, rate: float, train: bool, generator: torch.Generator = None, mask=None):
    """Inverted dropout (tf.layers.Dropout semantics): kept units scaled by
    1 / (1 - rate), dropped ones 0. ``mask`` (bool, True = kept, the shape
    of ``x``) is the keep-mask, drawn from ``generator`` on its device when
    not given; identity outside training or at rate 0."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        if generator is None:
            raise ValueError("dropout needs a torch.Generator or an injected mask")
        mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask, x / keep, 0.0)
