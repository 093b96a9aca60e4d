"""SASRec's bfloat16 training path (``train_dtype="bfloat16"``) on the CPU,
where the K2a/K2b wrappers run their plain versions, against the JAX
package's kernel form of it: ``SASRec(fused="always",
train_dtype="bfloat16")``, whose Pallas encoder runs in interpret mode as
``tests/test_sasrec_fused.py`` runs it. Each product of the encoder takes
bfloat16 operands and sums in float32 (the attention's from T = 32 on), and
its vjp rounds each product's input and weight gradient once. This file
runs T = 8 at d = 16 (the attention in float32) and the shared checks;
``tests/test_torch_sasrec_bf16_t32.py`` runs T = 32 at d = 10 (the
attention's products in bfloat16, a width with d % 4 != 0) and
``tests/test_torch_sasrec_bf16_asasrec2.py`` asasrec2 at both (three files,
so that their JAX references, ~10-30 s each, run on separate workers).

Tolerances. Both sides round the same float32 values to bfloat16, but they
form those values with float32 sums in different orders (and LayerNorm by
a division here, by ``rsqrt`` in JAX), so a value one float32 ulp apart
sometimes rounds to the neighbouring bfloat16 value: an error of 2⁻⁸ of
it, where the float32 path sees 2⁻²⁴. Encoder outputs (unit scale after
LN_f): atol 2e-3. Losses: rtol 1e-5. Gradients: each leaf within two
bfloat16 ulps of its largest entry (2⁻⁷ of it) plus 1e-4 of the whole
tree's largest entry, which covers the attention's key bias, whose
gradient is zero but for rounding on both sides. A weight gradient is
rounded once over the batch on both sides here: one JAX grid program
holds every user. Measured maxima are in ``CHANGES.md``. Against the JAX
XLA path's bfloat16 form (``fused="never"``, activations and residuals in
bfloat16 too): both bfloat16 losses within rtol 2e-2 of the float32 loss,
the bar of ``tests/test_sasrec.py:314-316``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.ops.sasrec_fused import fused_encoder as jax_fused_encoder
from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.ops.sasrec_fused import (
    compute_rounding, encoder_bwd_math, encoder_math, fused_encoder, fused_encoder_plain,
)
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.train import adam
from acf_tpu_torch.train.trainer import seq_train_step
from acf_tpu_torch.utils.tree import tree_map
from tests.test_torch_sasrec_train import B, NUM_ITEMS, jax_masks, port_value_and_grad, window_batch

CPU = "cpu"
T, D = 8, 16
OUT_TOL = dict(rtol=0, atol=2e-3)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
LEAF_TOL = 2 ** -7  # of each gradient leaf's largest entry: two bfloat16 ulps
TREE_TOL = 1e-4     # of the whole gradient tree's largest entry
MESH_TOL = 2e-2     # of each state leaf's largest entry, 2x1 against one device
XLA_RTOL = 2e-2   # tests/test_sasrec.py:314-316
KEEP = 0.7

CONFIGS = {
    "sasrec": {},
    "asasrec": dict(adversarial=True, eps=0.5, reg_adv=1.0),
    "asasrec2": dict(adversarial=True, adv_mode="asasrec2", eps_pos=0.3, eps_dense=0.2,
                     eps_conv=0.1),
}


def models(d, t, fused="always", train_dtype="bfloat16", **kw):
    """(JAX model, port model) of one configuration, dropout 0.3."""
    jm = JaxSASRec(10, NUM_ITEMS, d, maxlen=t, dropout_rate=1 - KEEP, fused=fused,
                   train_dtype=train_dtype, **kw)
    return jm, SASRec(10, NUM_ITEMS, d, maxlen=t, dropout_rate=1 - KEEP,
                      train_dtype=train_dtype, **kw)


def jittered(jm, seed):
    """JAX init params with LayerNorm gammas/betas and dense biases moved off
    their init constants (numpy noise from ``seed``), so every leaf matters;
    (JAX tree, port tree on the CPU)."""
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p in tree["blocks"] + [tree]:
        for name, leaf in p.items():
            for k in {"ln1": ("gamma", "beta"), "ln2": ("gamma", "beta"),
                      "ln3": ("gamma", "beta"), "ln_f": ("gamma", "beta"), "wq": ("b",),
                      "wk": ("b",), "wv": ("b",), "conv1": ("b",), "conv2": ("b",)}.get(name, ()):
                leaf[k] = leaf[k] + 0.1 * rng.standard_normal(leaf[k].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device=CPU)


def check_forward(d, t, dropout, seed):
    """The plain bfloat16 forward (the wrapper on CPU tensors) against JAX's
    ``fused_encoder(..., dtype=bfloat16)``; returns the largest |port - JAX|."""
    jm, tm = models(d, t)
    jp, tp = jittered(jm, seed)
    seq = np.asarray(window_batch(t, seed)[1][:, :-1])
    key = jax.random.PRNGKey(seed)
    jmasks = jm._dropout_masks(key, B, t) if dropout else None
    ref = np.asarray(jax_fused_encoder(jm, jp, jp["item_emb"][seq] * math.sqrt(d),
                                       jnp.asarray(seq != 0), jmasks, dtype=jnp.bfloat16))
    masks = None if jmasks is None else params_from_numpy(jax.tree.map(np.asarray, jmasks),
                                                          device=CPU)
    s = torch.from_numpy(seq)
    x, mask = tp["item_emb"][s] * math.sqrt(d), s != 0
    before = (fused_encoder.launches, fused_encoder.bf16_launches)
    got = fused_encoder(tm, tp, x, mask, masks, torch.bfloat16)
    assert (fused_encoder.launches, fused_encoder.bf16_launches) == before  # CPU: no launch
    np.testing.assert_array_equal(
        got.numpy(), fused_encoder_plain(tp, x, mask, masks, KEEP, torch.bfloat16).numpy())
    np.testing.assert_allclose(got.numpy(), ref, **OUT_TOL)
    f32 = fused_encoder(tm, tp, x, mask, masks).numpy()
    assert np.abs(f32 - got.numpy()).max() > 10 * np.abs(got.numpy() - ref).max()  # it rounds
    return float(np.abs(got.numpy() - ref).max())


def assert_leaves_close(jgrads, tgrads):
    """Each leaf within LEAF_TOL of its own largest entry plus TREE_TOL of
    the tree's; returns the largest |port - JAX| as a share of its leaf's
    largest entry (the key biases, rounding noise, left out) and of the
    tree's."""
    ref = jax_named(jgrads)
    assert ref.keys() == tgrads.keys()
    tree = max(float(np.abs(v).max()) for v in ref.values())
    leaf_share = tree_share = 0.0
    for name, r in ref.items():
        scale = float(np.abs(r).max())
        err = float(np.abs(tgrads[name] - r).max())
        assert err <= LEAF_TOL * scale + TREE_TOL * tree, (name, err, scale, tree)
        if scale and not name.endswith("/wk/b"):
            leaf_share = max(leaf_share, err / scale)
        tree_share = max(tree_share, err / tree)
    return leaf_share, tree_share


def check_step(d, t, config, seed):
    """``loss`` and every gradient leaf of the bfloat16 model against
    ``jax.value_and_grad`` of JAX's kernel form on the same batch and
    dropout masks; returns (loss error, :func:`assert_leaves_close`'s
    shares)."""
    jm, tm = models(d, t, **CONFIGS[config])
    jp, tp = jittered(jm, seed)
    users, window, neg = window_batch(t, seed + 1)
    batch = (users, window[:, :-1], window[:, 1:], neg)
    key = jax.random.PRNGKey(seed + 2)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, batch, key)
    masks, adv_masks = jax_masks(jm, key, t)
    loss, aux, tg = port_value_and_grad(tm.loss, tp, batch, masks, adv_masks)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOSS_TOL)
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **LOSS_TOL, err_msg=k)
    return abs(float(loss.detach()) - float(jl)), assert_leaves_close(jg, tg)


@pytest.mark.parametrize("d,dropout", [(D, False), (10, True)], ids=["d16", "d10-dropout"])
def test_plain_forward_matches_jax_kernel(d, dropout):
    check_forward(d, T, dropout, seed=d)


@pytest.mark.parametrize("config", ["asasrec", "sasrec"])
def test_loss_and_every_grad_match_jax_kernel(config):
    check_step(D, T, config, seed=len(config))


def test_float32_is_unchanged_bit_for_bit():
    """``dtype=None`` and ``torch.float32`` compute the float32 encoder as it
    was: forward and backward bit for bit; float16 is refused."""
    jm, tm = models(D, T)
    _, tp = jittered(jm, 3)
    users, window, neg = window_batch(T, 4)
    s = torch.from_numpy(window[:, :-1])
    x, mask = tp["item_emb"][s] * math.sqrt(D), s != 0
    masks = jax_masks(jm, jax.random.PRNGKey(5), T)[0]
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((B, T, D)).astype(np.float32))
    out = encoder_math(tp, x, mask, 1, masks, KEEP)
    np.testing.assert_array_equal(encoder_math(tp, x, mask, 1, masks, KEEP, torch.float32), out)
    dx, grads = encoder_bwd_math(tp, x, mask, masks, KEEP, g)
    dx32, grads32 = encoder_bwd_math(tp, x, mask, masks, KEEP, g, dtype=torch.float32)
    np.testing.assert_array_equal(dx32, dx)
    for a, b in zip(jax.tree.leaves(tree_map(np.asarray, grads32)),
                    jax.tree.leaves(tree_map(np.asarray, grads))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        compute_rounding(torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        SASRec(10, NUM_ITEMS, D, train_dtype="float16")._compute_dtype()


def test_evaluation_ignores_train_dtype():
    """``score_all`` (the evaluation and serving path) is the same to the
    last bit whatever ``train_dtype`` is, as in JAX."""
    jm, m16 = models(D, T, **CONFIGS["asasrec"])
    m32 = SASRec(10, NUM_ITEMS, D, maxlen=T, dropout_rate=1 - KEEP, adversarial=True)
    _, tp = jittered(jm, 10)
    hists = torch.from_numpy(window_batch(T, 11)[1])
    users = torch.arange(B)
    np.testing.assert_array_equal(m16.score_all(tp, users, hists).numpy(),
                                  m32.score_all(tp, users, hists).numpy())


def test_mesh_step_equals_one_device():
    """One bfloat16 ASASRec step of the data-parallel trainer on two gloo
    ranks at 1x2 and 2x1 (one launch) against the same step on one device.
    At 1x2 one data rank holds the whole batch: bit for bit. At 2x1 each
    rank's weight gradients are rounded to bfloat16 over its own rows and
    then summed, where one device rounds the sum over all of them (as JAX's
    grid programs do), so each state leaf (params, Adam's moments) agrees
    to within 2e-2 of its largest entry (measured at most 7.2e-3; Adam's
    first step moves a param by about ±lr whatever the gradient's size, so
    a gradient entry near 0 whose sign the rounding flips moves its param
    by 2 lr)."""
    b = 16
    jm, tm = models(D, T, **CONFIGS["asasrec"])
    jp, tp = jittered(jm, 12)
    init = jax.tree.map(np.asarray, jp)
    users, window, neg = window_batch(T, 13)
    rng = np.random.default_rng(14)
    batch = (np.arange(b, dtype=np.int32), window[rng.integers(0, B, b)],
             rng.integers(1, NUM_ITEMS, (b, T)).astype(np.int32))
    jmasks = jax.tree.map(np.asarray, jm._dropout_masks(jax.random.PRNGKey(15), b, T))
    opt = adam(1e-3, b2=0.98)
    calls = [("seq_steps", (tm, opt, init, [batch], [(jmasks, None)]))]
    got = launch.run("tests.torch_rank_cases:meshes", 2, None, CPU,
                     [("1x2", calls), ("2x1", calls)], device=CPU, timeout=120.0)
    from acf_tpu_torch.train.checkpoint import state_arrays

    prm = params_from_numpy(init, device=CPU)
    prm, st, _ = seq_train_step(tm, opt, prm, opt.init(prm),
                                tuple(torch.from_numpy(x) for x in batch), None,
                                params_from_numpy(jmasks, device=CPU))
    want = state_arrays(prm, st)
    # params, Adam's first moments, its second moments: the key bias's
    # moments are rounding noise, held on their kind's scale
    kind = {k: "/".join(k.split("/")[:1 if k.startswith("params") else 3]) for k in want}
    kind_max = {}
    for k, w in want.items():
        kind_max[kind[k]] = max(kind_max.get(kind[k], 0.0), float(np.abs(w).max()))
    for r, rank in enumerate(got):
        one, two = rank[0][0]["state"], rank[1][0]["state"]
        assert one.keys() == two.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(one[k], w, err_msg=f"1x2 rank {r} {k}")
            tol = MESH_TOL * max(float(np.abs(w).max()), 1e-3 * kind_max[kind[k]])
            assert np.abs(two[k] - w).max() <= tol, f"2x1 rank {r} {k}"


if __name__ == "__main__":  # python -m tests.test_torch_sasrec_bf16
    # the measured maxima of the three files' cases (CHANGES.md): the
    # forward's largest |port - JAX|; a step's loss error, its largest
    # gradient error as a share of its leaf's largest entry (key biases
    # aside) and of the tree's
    jax.config.update("jax_platforms", "cpu")
    for d, t, dropout in ((16, 8, False), (10, 8, True), (16, 32, True), (10, 32, False)):
        print(f"forward d={d} T={t} dropout={dropout}:",
              check_forward(d, t, dropout, seed=d + (t if t == 32 else 0)))
    for d, t, config in ((16, 8, "sasrec"), (16, 8, "asasrec"), (10, 32, "sasrec"),
                         (10, 32, "asasrec"), (16, 8, "asasrec2"), (10, 32, "asasrec2")):
        seed = t + d if config == "asasrec2" else len(config)
        print(f"step {config} d={d} T={t}:", check_step(d, t, config, seed))
