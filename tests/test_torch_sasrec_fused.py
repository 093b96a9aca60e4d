"""The port's SASRec encoder math, its hand-derived backward, and the K2a/K2b
wrappers (on the CPU, where they take their plain versions) against the JAX
package's encoder and ``jax.vjp``, plus the kernels' stated limits.

Tolerances: rtol 1e-5, atol 1e-5 on the encoder outputs. Both sides compute
in f32 but sum the d-term products, the softmax denominators and the
LayerNorm moments in different orders; the outputs are LayerNorm'd to unit
scale, where f32 rounding of a few such sums stays near 1e-6. Gradients:
rtol 1e-4 and an atol of 1e-5 times the largest entry of the leaf's
gradient tree (GRAD_TOL). Backpropagating through two blocks of LayerNorm
(whose 1/σ amplifies rounding) and the softmax sums many more terms; some
entries are analytically zero (the key bias: softmax ignores a per-row
constant) and are rounding noise on both sides, hence the atol scaled to
the gradient's own size.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.ops import sasrec_fused
from acf_tpu_torch.ops.sasrec_fused import (
    _bwd_form, _bwd_layout, _flat_leaves, _grad_tree, _layout, _tree_from, check_supported,
    encoder_bwd_math, encoder_math, fused_encoder, fused_encoder_plain, grad_size,
    SMEM_LIMIT, max_train_window, max_window,
)

CPU = "cpu"
D, NUM_ITEMS, B = 16, 60, 6
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
KEEP = 0.7  # dropout 0.3


def jittered_params(jmodel, seed):
    """JAX init params with LayerNorm gammas/betas and dense biases moved off
    their init constants (numpy noise from ``seed``), so every leaf matters;
    returned as (JAX tree, port tree on the CPU)."""
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p in tree["blocks"] + [tree]:
        for name, leaf in p.items():
            if name in ("ln1", "ln2", "ln3", "ln_f"):
                leaf["gamma"] = leaf["gamma"] + 0.1 * rng.standard_normal(D).astype(np.float32)
                leaf["beta"] = leaf["beta"] + 0.1 * rng.standard_normal(D).astype(np.float32)
            elif name in ("wq", "wk", "wv", "conv1", "conv2"):
                leaf["b"] = leaf["b"] + 0.1 * rng.standard_normal(D).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device=CPU)


def windows(t, seed, b=B):
    """[b, t] item ids with a left-padded row 0 and an all-padding row 1."""
    seq = np.random.default_rng(seed).integers(1, NUM_ITEMS, (b, t)).astype(np.int32)
    seq[0, : t // 2 + 1] = 0
    seq[1] = 0
    return seq


def encoder_inputs(tparams, seq):
    s = torch.from_numpy(seq)
    return tparams["item_emb"][s] * math.sqrt(D), s != 0


@pytest.mark.parametrize("t", [5, 8, 33])
@pytest.mark.parametrize("num_heads", [1, 2])
def test_encode_math_matches_jax(num_heads, t):
    jmodel = JaxSASRec(20, NUM_ITEMS, D, maxlen=t, num_heads=num_heads, fused="never")
    jparams, tparams = jittered_params(jmodel, seed=t + num_heads)
    seq = windows(t, seed=t)
    jx = jparams["item_emb"][seq] * math.sqrt(D)
    ref = np.asarray(jmodel.encode_math(jparams, jx, jnp.asarray(seq != 0), None))
    x, mask = encoder_inputs(tparams, seq)
    tmodel = SASRec(20, NUM_ITEMS, D, maxlen=t, num_heads=num_heads)
    got = tmodel.encode_math(tparams, x, mask)
    assert got.shape == (B, t, D)
    assert torch.isfinite(got).all()  # the all-padding row too
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(got.numpy(), encoder_math(tparams, x, mask, num_heads).numpy())


@pytest.mark.parametrize("t", [8, 33])  # the unrolled (T < 32) and block-diagonal forms
def test_fused_encoder_cpu_matches_jax_kernel(t):
    """The wrapper on CPU tensors (the plain version) against the JAX Pallas
    kernel in interpret mode, as tests/test_sasrec_fused.py runs it."""
    jmodel = JaxSASRec(20, NUM_ITEMS, D, maxlen=t, fused="always", train_dtype="float32")
    assert jmodel._use_fused(t)
    jparams, tparams = jittered_params(jmodel, seed=t)
    seq = windows(t, seed=t + 1)
    ref = np.asarray(jmodel.encode(jparams, jnp.asarray(seq), train=False))
    x, mask = encoder_inputs(tparams, seq)
    tmodel = SASRec(20, NUM_ITEMS, D, maxlen=t)
    before = fused_encoder.launches
    got = fused_encoder(tmodel, tparams, x, mask)
    assert fused_encoder.launches == before  # CPU: the plain version, no launch
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(got.numpy(), fused_encoder_plain(tparams, x, mask).numpy())


@pytest.mark.parametrize("t", [1, 8, 50, 200])
def test_check_supported_accepts_every_window_to_200_at_d64(t):
    check_supported(t, 64, 1)
    assert _layout(t, 64)[2] <= 232_448  # fits one Hopper block's shared memory


@pytest.mark.parametrize("t,d,num_heads,match", [
    (50, 64, 2, "single-head.*ROADMAP.md Queue 2"),
    (201, 64, 1, "1 to 200 items at d=64; got t=201.*ROADMAP.md Queue 2"),
    (0, 64, 1, "1 to 200 items"),
    (8, 0, 1, "1 <= d <= 128"),
    (8, 132, 1, "d <= 128"),
])
def test_check_supported_raises(t, d, num_heads, match):
    with pytest.raises(ValueError, match=match):
        check_supported(t, d, num_heads)


def test_max_window_follows_shared_memory():
    assert max_window(64) == 200  # the SASRec paper's widest window
    assert max_window(16) == 200
    wide = max_window(128)
    assert 50 <= wide < 200
    assert _layout(wide, 128)[2] <= 232_448 < _layout(wide + 1, 128)[2]


def test_fused_encoder_raises_for_what_the_kernel_does_not_take():
    model = SASRec(20, NUM_ITEMS, D, maxlen=8, num_heads=2)
    params = model.init_params(torch.Generator().manual_seed(0), device=CPU)
    x, mask = encoder_inputs(params, windows(8, seed=0))
    with pytest.raises(ValueError, match="single-head"):
        fused_encoder(model, params, x, mask)
    with pytest.raises(ValueError, match="single-head"):  # in training too
        fused_encoder(model, params, x.requires_grad_(True), mask)
    wide = max_train_window(D) + 1  # 201: past the widest window K2a takes
    assert wide == max_window(D) + 1
    model = SASRec(20, NUM_ITEMS, D, maxlen=wide)
    params = model.init_params(torch.Generator().manual_seed(0), device=CPU)
    x, mask = encoder_inputs(params, windows(wide, seed=0))
    with pytest.raises(ValueError, match=f"1 to {wide - 1} items.*ROADMAP.md Queue 2"):
        fused_encoder(model, params, x, mask)
    with pytest.raises(ValueError, match=f"1 to {wide - 1} items.*ROADMAP.md Queue 2"):
        fused_encoder(model, params, x.requires_grad_(True), mask)
    with pytest.raises(ValueError, match=r"\[B, T\]"):
        fused_encoder(SASRec(20, NUM_ITEMS, D, maxlen=8), params, x, mask[:, :3])


# --- dropout masks and the backward ----------------------------------------------

def jax_masks(jmodel, key, b, t):
    """The JAX model's masks for ``key``: (JAX tree, port tree of bool tensors)."""
    jm = jmodel._dropout_masks(key, b, t)
    return jm, params_from_numpy(jax.tree.map(np.asarray, jm), device=CPU)


def assert_grads_close(got, ref, label=""):
    """Leaf by leaf, with the tolerance of the module docstring."""
    got, ref = list(got), list(ref)
    assert len(got) == len(ref)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=f"{label} leaf {i}")


@pytest.mark.parametrize("t", [8, 33])
@pytest.mark.parametrize("num_heads", [1, 2])
def test_encode_math_with_masks_matches_jax(num_heads, t):
    jmodel = JaxSASRec(20, NUM_ITEMS, D, maxlen=t, num_heads=num_heads, dropout_rate=1 - KEEP,
                       fused="never")
    jparams, tparams = jittered_params(jmodel, seed=t + num_heads)
    seq = windows(t, seed=t)
    jm, tm = jax_masks(jmodel, jax.random.PRNGKey(t), B, t)
    assert tm["blocks"][0]["p"].shape == (B, num_heads, t, t) and tm["emb"].dtype == torch.bool
    jx = jparams["item_emb"][seq] * math.sqrt(D)
    ref = np.asarray(jmodel.encode_math(jparams, jx, jnp.asarray(seq != 0), jm))
    x, mask = encoder_inputs(tparams, seq)
    tmodel = SASRec(20, NUM_ITEMS, D, maxlen=t, num_heads=num_heads, dropout_rate=1 - KEEP)
    got = tmodel.encode_math(tparams, x, mask, tm)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(got.numpy(),
                                  encoder_math(tparams, x, mask, num_heads, tm, KEEP).numpy())


@pytest.mark.parametrize("t", [8, 33])
def test_fused_encoder_cpu_with_masks_matches_jax_kernel(t):
    """The dropout form on CPU tensors (the plain version) against the JAX
    Pallas kernel in interpret mode, with the masks its key draws."""
    jmodel = JaxSASRec(20, NUM_ITEMS, D, maxlen=t, dropout_rate=1 - KEEP, fused="always",
                       train_dtype="float32")
    jparams, tparams = jittered_params(jmodel, seed=t)
    seq = windows(t, seed=t + 2)
    key = jax.random.PRNGKey(t + 5)
    ref = np.asarray(jmodel.encode(jparams, jnp.asarray(seq), train=True, key=key))
    _, tm = jax_masks(jmodel, key, B, t)
    x, mask = encoder_inputs(tparams, seq)
    tmodel = SASRec(20, NUM_ITEMS, D, maxlen=t, dropout_rate=1 - KEEP)
    before = fused_encoder.launches
    got = fused_encoder(tmodel, tparams, x, mask, tm)
    assert fused_encoder.launches == before
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(got.numpy(), fused_encoder_plain(tparams, x, mask, tm, KEEP).numpy())


def _autograd_ref(tparams, x, mask, masks, g):
    """(dx, [pos rows, *leaves]) by torch.autograd through encoder_math."""
    t = x.shape[1]
    leaves = [v.clone().requires_grad_(True) for v in _flat_leaves(tparams)]
    pos = tparams["pos_emb"][-t:].clone().requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    out = encoder_math(_tree_from(pos, leaves), xs, mask, 1, masks, KEEP)
    grads = torch.autograd.grad(out, [xs, pos, *leaves], g)
    return grads[0], list(grads[1:])


@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("t", [8, 33])
def test_encoder_bwd_math_matches_autograd(t, with_masks):
    jmodel = JaxSASRec(20, NUM_ITEMS, D, maxlen=t, dropout_rate=1 - KEEP)
    _, tparams = jittered_params(jmodel, seed=t + 7)
    seq = windows(t, seed=t + 3)  # a left-padded and an all-padding window
    x, mask = encoder_inputs(tparams, seq)
    masks = jax_masks(jmodel, jax.random.PRNGKey(1), B, t)[1] if with_masks else None
    g = torch.from_numpy(np.random.default_rng(t).standard_normal((B, t, D)).astype(np.float32))
    dx, grads = encoder_bwd_math(tparams, x, mask, masks, KEEP, g)
    rdx, rgrads = _autograd_ref(tparams, x, mask, masks, g)
    assert not dx[1].any() and not dx[0, : t // 2 + 1].any()  # padding gets exactly 0
    assert_grads_close([dx], [rdx], "dx")
    assert_grads_close([grads["pos_emb"]] + _flat_leaves(grads), rgrads, "leaves")
    dx_only, none = encoder_bwd_math(tparams, x, mask, masks, KEEP, g, weight_grads=False)
    assert none is None
    np.testing.assert_array_equal(dx_only.numpy(), dx.numpy())


@pytest.mark.parametrize("t", [8, 33])
def test_encoder_bwd_math_matches_jax_vjp(t):
    """dx and every leaf against jax.vjp of the JAX model's encode_math,
    with its dropout masks."""
    jmodel = JaxSASRec(20, NUM_ITEMS, D, maxlen=t, dropout_rate=1 - KEEP, fused="never")
    jparams, tparams = jittered_params(jmodel, seed=t + 11)
    seq = windows(t, seed=t + 4)
    jm, tm = jax_masks(jmodel, jax.random.PRNGKey(t), B, t)
    g = np.random.default_rng(t + 1).standard_normal((B, t, D)).astype(np.float32)
    jx = jparams["item_emb"][seq] * math.sqrt(D)
    enc = {k: jparams[k] for k in ("pos_emb", "blocks", "ln_f")}
    _, pull = jax.vjp(lambda x, w: jmodel.encode_math(w, x, jnp.asarray(seq != 0), jm), jx, enc)
    jdx, jw = pull(jnp.asarray(g))
    x, mask = encoder_inputs(tparams, seq)
    dx, grads = encoder_bwd_math(tparams, x, mask, tm, KEEP, torch.from_numpy(g))
    assert_grads_close([dx], [jdx], "dx")
    ref = [jw["pos_emb"]] + _flat_leaves(jax.tree.map(np.asarray, jw))
    assert_grads_close([grads["pos_emb"]] + _flat_leaves(grads), ref, "leaves")


@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("t", [1, 8, 33])
def test_key_bias_gradient_is_zero_to_rounding(t, with_masks):
    """Softmax ignores a per-row constant, so the key bias's gradient is
    analytically zero: encoder_bwd_math and torch.autograd both leave
    rounding noise there, at most 1e-6 of the gradient tree's largest entry
    (exactly 0 at T=1, where the one-key softmax's backward cancels). Two
    correct backwards disagree by the size of that noise, which is why the
    gradient comparisons scale their error to the tree, not to each leaf."""
    jmodel = JaxSASRec(20, NUM_ITEMS, D, maxlen=t, dropout_rate=1 - KEEP)
    _, tparams = jittered_params(jmodel, seed=t + 13)
    seq = windows(t, seed=t + 6)
    x, mask = encoder_inputs(tparams, seq)
    masks = jax_masks(jmodel, jax.random.PRNGKey(2), B, t)[1] if with_masks else None
    g = torch.from_numpy(np.random.default_rng(t + 2).standard_normal((B, t, D)).astype(np.float32))
    _, grads = encoder_bwd_math(tparams, x, mask, masks, KEEP, g)
    _, auto = _autograd_ref(tparams, x, mask, masks, g)
    auto = _tree_from(auto[0], auto[1:])
    for tree in (grads, auto):
        scale = max(float(v.abs().max()) for v in [tree["pos_emb"]] + _flat_leaves(tree))
        for blk in tree["blocks"]:
            assert float(blk["wk"]["b"].abs().max()) <= 1e-6 * scale
            if t > 1:  # the query bias, for contrast, is live
                assert float(blk["wq"]["b"].abs().max()) > 1e-3 * scale
    if t == 1:
        assert not any(bool(blk["wk"]["b"].any()) for blk in grads["blocks"])


def test_cpu_autograd_runs_the_hand_derivation(monkeypatch):
    """On CPU tensors the autograd function's backward is encoder_bwd_math
    (no launch), with weight gradients only when a weight needs one."""
    t = 8
    tmodel = SASRec(20, NUM_ITEMS, D, maxlen=t, dropout_rate=1 - KEEP)
    _, tparams = jittered_params(JaxSASRec(20, NUM_ITEMS, D, maxlen=t), seed=3)
    x, mask = encoder_inputs(tparams, windows(t, seed=5))
    calls = []
    real = sasrec_fused.encoder_bwd_math
    monkeypatch.setattr(sasrec_fused, "encoder_bwd_math",
                        lambda *a, **k: calls.append(a[-1]) or real(*a, **k))
    g = torch.ones(B, t, D)
    before = (fused_encoder.launches, sasrec_fused.encoder_bwd.launches)
    leaves = [v.clone().requires_grad_(True) for v in _flat_leaves(tparams)]
    xs = x.clone().requires_grad_(True)
    out = fused_encoder(tmodel, _tree_from(tparams["pos_emb"], leaves), xs, mask)
    got = torch.autograd.grad(out, [xs, *leaves], g)
    assert calls == [True]
    rdx, rgrads = _autograd_ref(tparams, x, mask, None, g)
    assert_grads_close(got, [rdx] + rgrads[1:])
    dx = torch.autograd.grad(fused_encoder(tmodel, tparams, xs, mask), xs, g)[0]
    assert calls == [True, False]  # only x needs a gradient: dx alone
    np.testing.assert_array_equal(dx.numpy(), got[0].numpy())
    assert (fused_encoder.launches, sasrec_fused.encoder_bwd.launches) == before


@pytest.mark.parametrize("t", [1, 8, 50, 74])
def test_check_supported_takes_the_training_windows_at_d64(t):
    """Both training geometries of the repo (maxlen 8 and 50) fit K2b."""
    check_supported(t, 64, 1, 2, train=True)
    assert _bwd_layout(t, 64)[2] <= 232_448


def test_max_train_window_follows_shared_memory():
    """K2b's tile form still holds its block in shared memory up to 79 at
    d = 64 (74 before its seven-buffer layout) and 44 at d = 128 (40
    before); the wide form takes the windows past them, so training reaches
    every window K2a takes."""
    assert _bwd_layout(79, 64)[2] <= 232_448 < _bwd_layout(80, 64)[2]
    assert _bwd_layout(44, 128)[2] <= 232_448 < _bwd_layout(45, 128)[2]
    assert _bwd_form(79, 64) == _bwd_form(44, 128) == "tile"
    assert _bwd_form(80, 64) == _bwd_form(45, 128) == "wide"
    assert max_train_window(64) == max_window(64) == 200
    assert max_train_window(128) == max_window(128) == 108
    check_supported(80, 64, 1, 2, train=True)  # training takes it now
    with pytest.raises(ValueError, match="1 to 200 items at d=64; got t=201"):
        check_supported(201, 64, 1, 2, train=True)


# An H100 SM: 233,472 bytes of shared memory (228 KB), 1,024 of them kept
# per resident block; 65,536 registers, K2b's kernel takes at most 128 a
# thread (__launch_bounds__(512, 1)).
SM_SMEM, BLOCK_RESERVED, SM_REGISTERS, K2B_REGISTERS = 233_472, 1_024, 65_536, 128


@pytest.mark.parametrize("t", [8, 50])
def test_k2b_layout_runs_16_warps_an_sm(t):
    """The training windows of the repo (maxlen 8 and 50) give K2b at least
    16 resident warps on every SM, and at B=512 at least 128 user groups
    (T=8: 128 groups of four users, each SM but four takes one)."""
    users, threads, smem = _bwd_layout(t, 64)
    assert smem <= SMEM_LIMIT
    blocks = min(SM_SMEM // (smem + BLOCK_RESERVED), SM_REGISTERS // (K2B_REGISTERS * threads))
    assert blocks >= 1 and threads // 32 * blocks >= 16
    assert -(-512 // users) >= 128


# K2a's kernel takes at most 128 registers a thread at either thread count
# (__launch_bounds__(256, 2) and (512, 1)).
K2A_REGISTERS = 128


@pytest.mark.parametrize("t,users,blocks", [(8, 2, 256), (50, 1, 512)])
def test_k2a_layout_runs_16_warps_an_sm(t, users, blocks):
    """K2a's layout at the repo's windows (maxlen 8 and 50): about 16 rows a
    block (two users at T=8, one at T=50) on 256 threads, whose shared
    memory and registers let two blocks share an SM (16 warps); at B=512,
    T=8 gives 256 blocks, so every one of an H100's 132 SMs takes work."""
    from acf_tpu_torch.ops.sasrec_fused import FWD_BLOCKS_AN_SM

    got, threads, smem = _layout(t, 64)
    assert (got, threads) == (users, 256) and smem <= SMEM_LIMIT
    per_sm = min(SM_SMEM // (smem + BLOCK_RESERVED), SM_REGISTERS // (K2A_REGISTERS * threads))
    assert per_sm == FWD_BLOCKS_AN_SM[threads] == 2 and threads // 32 * per_sm == 16
    assert -(-512 // users) == blocks >= 132


def test_grad_tree_matches_the_kernel_offsets():
    """The flat gradient's leaf order and offsets are the ones
    csrc/sasrec_encoder_bwd.cu computes (block_grad_off, lnf_off,
    pos_off)."""
    nb, t, d = 2, 5, 8
    flat = torch.arange(grad_size(nb, t, d), dtype=torch.float32)
    tree = _grad_tree(flat, nb, t, d)
    dd = d * d
    for blk in range(nb):
        o = blk * (5 * dd + 11 * d)
        want = {"ln1": (o, "gamma"), "wq": (o + 2 * d, "w"), "wk": (o + 3 * d + dd, "w"),
                "wv": (o + 4 * d + 2 * dd, "w"), "ln2": (o + 5 * d + 3 * dd, "gamma"),
                "conv1": (o + 7 * d + 3 * dd, "w"), "conv2": (o + 8 * d + 4 * dd, "w"),
                "ln3": (o + 9 * d + 5 * dd, "gamma")}
        for name, (off, first) in want.items():
            leaf = tree["blocks"][blk][name]
            assert int(leaf[first].flatten()[0]) == off, name
            second = "b" if first == "w" else "beta"
            assert int(leaf[second][0]) == off + (dd if first == "w" else d), name
    lnf = nb * (5 * dd + 11 * d)
    assert int(tree["ln_f"]["gamma"][0]) == lnf and int(tree["pos_emb"][0, 0]) == lnf + 2 * d
    assert tree["pos_emb"].shape == (t, d) and int(tree["pos_emb"][-1, -1]) == flat.numel() - 1
