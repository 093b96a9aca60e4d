"""The plain versions of K3a–K3e (``acf_tpu_torch/ops/apl_gen_fused.py``,
what the wrappers run on CPU tensors) against the JAX package's Pallas
kernels in interpret mode (``acf_tpu/ops/apl_gen_fused.py``) and against the
dense closed form of ``gen_step_manual``.

Inputs come from numpy with a seed: random tables, Gumbel noise, a cotangent
``a``, and histories with duplicate entries and one user with no
positives. Tolerance rtol 1e-5, atol 1e-6: both sides are f32 with the same
formulas; only the order of the sums differs (JAX streams 512-item tiles
with an online softmax, the plain versions reduce whole rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.ops.apl_gen_fused import apl_gen_backward as jax_backward
from acf_tpu.ops.apl_gen_fused import apl_gen_forward as jax_forward
from acf_tpu_torch.models.apl import membership
from acf_tpu_torch.ops.apl_gen_fused import (
    KERNELS, apl_bigr_plain, apl_fake_plain, apl_gen_backward, apl_gen_forward, apl_grad_plain,
    MAX_WHOLE_D, SLICE, SMEM_LIMIT, apl_stats1_plain, apl_z_plain, check_supported, smem_bytes,
    smem_footprints,
)

TOL = dict(rtol=1e-5, atol=1e-6)
W, T = 0.2, 0.2


def inputs(b, d, num_items, seed=0):
    """numpy inputs of one generator step: tables at the scale a pretrained
    MF-BPR reaches (logits of a few units), histories of 12 entries with
    duplicates, user 0 without positives."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.4 * rng.standard_normal(s)).astype(np.float32)
    hist = rng.integers(1, num_items, (b, 12)).astype(np.int32)
    hist[:, :3] = hist[:, 3:6]      # duplicate entries
    hist[:, :2] = 0                 # left padding
    hist[0] = 0                     # a user with no positives
    u = rng.uniform(0.0, 1.0, (b, num_items)).astype(np.float32)
    gn = -np.log(-np.log(u + 1e-20) + 1e-20).astype(np.float32)
    return dict(pu_g=f(b, d), Qg=f(num_items, d), pu_c=f(b, d), Qc=f(num_items, d),
                hist=hist, gnoise=gn, a=f(b))


def port_member(x, num_items):
    return membership(torch.from_numpy(x["hist"]), num_items)


def t(x):
    return torch.from_numpy(np.asarray(x))


def jax_chain(x, num_items):
    """The JAX kernels (interpret mode): forward, then backward with ``a``."""
    member, nuniq = port_member(x, num_items)
    jm = jnp.asarray(member.numpy()).astype(jnp.bfloat16)
    jn = jnp.asarray(nuniq.numpy())
    fake, res = jax_forward(jnp.asarray(x["pu_g"]), jnp.asarray(x["Qg"]),
                            jnp.asarray(x["pu_c"]), jnp.asarray(x["Qc"]), jm, jn,
                            jnp.asarray(x["gnoise"]), w=W, temperature=T, interpret=True)
    dP, dQ = jax_backward(jnp.asarray(x["pu_g"]), jnp.asarray(x["pu_c"]), jn,
                          jnp.asarray(x["a"]), res, w=W, temperature=T, interpret=True)
    _, _, _, z, m1, l1, m2, l2, _, _ = res
    return {k: np.asarray(v) for k, v in dict(
        fake=fake, z=z[:, :num_items], m1=m1[:, 0], l1=l1[:, 0], m2=m2[:, 0], l2=l2[:, 0],
        dP=dP, dQ=dQ[:num_items]).items()}


# The grid of small shapes, then K3b's staging edges: one user tile plus a row
# by two item tiles plus 3 items, where the [B, I] rows start at every offset
# of a word. The edge case has an atol of its own: with 131 items log(mixed) lies near -5, where an f32 ulp is 4.8e-7,
# and z = (log(mixed) + gumbel)/T carries it 5-fold, so where z (or a dP, dQ
# entry) is near 0 two ulps of the logits' summation order exceed TOL's atol
# (both sides stay within 1.5e-6 of the output's scale of a float64 chain).
EDGE = (65, 64, 131)
EDGE_ATOL = 5e-6
CASES = [(b, d, n) for b in (7, 32) for d in (8, 64) for n in (40, 1100)] + [EDGE]


@pytest.mark.parametrize("b,d,num_items", CASES)
def test_plain_passes_match_the_jax_kernels(b, d, num_items):
    x = inputs(b, d, num_items, seed=b + d + num_items)
    ref = jax_chain(x, num_items)
    member, nuniq = port_member(x, num_items)
    pu_g, Qg, pu_c, Qc, gn, a = (t(x[k]) for k in ("pu_g", "Qg", "pu_c", "Qc", "gnoise", "a"))

    m1, l1 = apl_stats1_plain(pu_g, Qg)
    z, m2, l2 = apl_z_plain(pu_g, Qg, member, nuniq, gn, m1, l1, w=W, temperature=T)
    fake = apl_fake_plain(pu_c, Qc, z, m2, l2)
    chain = (pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake)
    R = apl_bigr_plain(*chain, w=W, temperature=T)
    dQ, dP = apl_grad_plain(*chain, R, w=W, temperature=T)
    got = dict(m1=m1, l1=l1, z=z, m2=m2, l2=l2, fake=fake, dP=dP, dQ=dQ)
    tol = dict(TOL, atol=EDGE_ATOL) if (b, d, num_items) == EDGE else TOL
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), ref[name], err_msg=name, **tol)
    # R has no JAX output of its own: dP = (probs∘(r − R)) Q_g holds it, and
    # the closed form below checks it directly
    assert torch.isfinite(R).all()

    # the wrappers on CPU tensors are the plain passes, with no launch
    before = [k.launches for k in KERNELS]
    fake2, res = apl_gen_forward(pu_g, Qg, pu_c, Qc, member, nuniq, gn, w=W, temperature=T)
    dP2, dQ2 = apl_gen_backward(pu_g, pu_c, nuniq, a, res, w=W, temperature=T)
    assert torch.equal(fake2, fake) and torch.equal(dP2, dP) and torch.equal(dQ2, dQ)
    assert [k.launches for k in KERNELS] == before == [0] * 5


def dense_closed_form(x, num_items):
    """``gen_step_manual``'s closed form (acf_tpu/models/apl.py:250-291),
    written densely in float64 from the same inputs: (fake, R, dP, dQ)."""
    f64 = {k: torch.from_numpy(v).double() for k, v in x.items() if k != "hist"}
    member, nuniq = port_member(x, num_items)
    logits = f64["pu_g"] @ f64["Qg"].T
    logits[:, 0] = -1e30
    probs = torch.softmax(logits, dim=-1)
    mixed = (1 - W) * probs + W * member.double() / nuniq.double()[:, None]
    s = torch.softmax((torch.log(mixed + 1e-20) + f64["gnoise"]) / T, dim=-1)
    cs = f64["pu_c"] @ f64["Qc"].T
    fake = (s * cs).sum(-1)
    dz = s * (f64["a"][:, None] * (cs - fake[:, None]))
    r = ((1 - W) / T) * dz / (mixed + 1e-20)
    R = (probs * r).sum(-1)
    dlogits = probs * (r - R[:, None])
    return fake, R, dlogits @ f64["Qg"], dlogits.T @ f64["pu_g"]


@pytest.mark.parametrize("b,d,num_items", [(7, 8, 40), (32, 64, 1100)])
def test_chain_equals_the_dense_closed_form(b, d, num_items):
    """The five passes compose to ``gen_step_manual``'s gradients: checked
    in float64 against the dense formulas, to f32 rounding of each output's
    scale (1e-5)."""
    x = inputs(b, d, num_items, seed=7)
    member, nuniq = port_member(x, num_items)
    pu_g, Qg, pu_c, Qc, gn, a = (t(x[k]) for k in ("pu_g", "Qg", "pu_c", "Qc", "gnoise", "a"))
    fake, res = apl_gen_forward(pu_g, Qg, pu_c, Qc, member, nuniq, gn, w=W, temperature=T)
    dP, dQ = apl_gen_backward(pu_g, pu_c, nuniq, a, res, w=W, temperature=T)
    R = apl_bigr_plain(pu_g, Qg, pu_c, Qc, member, nuniq, *res[3:8], a, fake, w=W,
                       temperature=T)
    ref = dense_closed_form(x, num_items)
    for name, got, want in zip(("fake", "R", "dP", "dQ"), (fake, R, dP, dQ), ref):
        scale = float(want.abs().max())
        err = float((got.double() - want).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)
    assert not dQ[0].any()  # the pad item gets no gradient


def test_limits_are_stated_once():
    """No width limit is left: up to MAX_WHOLE_D (K3e's register tile, 128
    columns) a tile holds whole rows, and past it one k slice of SLICE
    columns, so every footprint past MAX_WHOLE_D is that of d = SLICE.
    K3e's is the largest at MAX_WHOLE_D and still fits a block; at d = 64
    (and so past MAX_WHOLE_D) K3e fits two blocks on an SM (233,472 B of
    shared memory, less 1 KB reserved a block)."""
    assert MAX_WHOLE_D == 128 and SLICE == 64 and smem_bytes(MAX_WHOLE_D) <= SMEM_LIMIT
    footprints = smem_footprints(MAX_WHOLE_D)
    assert max(footprints, key=footprints.get) == "apl_grad"
    for d in (MAX_WHOLE_D + 1, 180, 184, 256, 512, 4096):
        assert smem_footprints(d) == smem_footprints(SLICE)
    assert 2 * (smem_footprints(64)["apl_grad"] + 1024) <= 233_472
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        check_supported(pu_g=x, Qg=torch.zeros(10, 8))


def test_k3c_footprint_keeps_two_blocks_an_sm():
    """K3c's staged z (two [64, 80] tiles beside the user tile and two Q_c
    tiles) still fits two blocks on an SM at d = 64, and so in the sliced
    form; at MAX_WHOLE_D it stays below K3e's footprint. At d = 50 its rows
    of 52 floats (d rounded up to 4) take 52 of a row's stride."""
    assert smem_footprints(64)["apl_fake"] == 93_184
    assert smem_footprints(MAX_WHOLE_D)["apl_fake"] == 142_336
    assert smem_footprints(50)["apl_fake"] == 80_896  # ld 52: 13 (odd) 16-byte units
    assert 2 * (smem_footprints(64)["apl_fake"] + 1024) <= 233_472
    assert smem_footprints(MAX_WHOLE_D)["apl_fake"] < smem_footprints(MAX_WHOLE_D)["apl_grad"]
    assert smem_footprints(512)["apl_fake"] == smem_footprints(64)["apl_fake"]


def test_k3a_footprint_fits_its_blocks_an_sm():
    """K3a's user tile and two Q_g tiles fit as many blocks on an SM at d = 64
    (and at every d up to 64: rows of d rounded up to 4) as its
    ``__launch_bounds__`` asks for of the whole-row forms (``kStatsBlocks``
    in apl_gen.cu, three), each with the 1 KB the card reserves a block; the
    sliced form's footprint is d = 64's."""
    import re

    from acf_tpu_torch.ops import _build

    source = (_build.CSRC_DIR / "apl_gen.cu").read_text()
    blocks = int(re.search(r"constexpr int kStatsBlocks = (\d+);", source).group(1))
    assert blocks == 3
    assert smem_footprints(64)["apl_stats1"] == 52_224
    assert smem_footprints(53)["apl_stats1"] == 3 * 64 * 60 * 4  # rows of 56 at a stride of 60
    assert blocks * (smem_footprints(64)["apl_stats1"] + 1024) <= 233_472
    assert 2 * (smem_footprints(MAX_WHOLE_D)["apl_stats1"] + 1024) <= 233_472
    assert smem_footprints(200)["apl_stats1"] == smem_footprints(64)["apl_stats1"]
