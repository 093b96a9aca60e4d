"""APL's generator chain at the widths the JAX package takes and the kernels
took only from their any-width forms on: d % 4 != 0 (3, 10, 50) and d past
the whole-row tiles (130, which the kernels take in k slices). On the CPU
the wrappers run their plain versions (``acf_tpu_torch/ops/apl_gen_fused.py``);
they are held to the JAX package's Pallas chain in interpret mode
(``acf_tpu/ops/apl_gen_fused.py``): the five passes, and one generator step
of the port's ``APL.gen_step`` (loss, gP, gQ) against the same step written
from the JAX chain as ``gen_step_fused`` writes it
(``acf_tpu/models/apl.py:295-342``). The JAX chain runs once a width, for
both tests. Also the width rule: the wrapper's checks and the shared-memory
footprints take every d in 1..512.

Shapes: B = 33, I = 131 (odd: the kernels' staging edge), 40 users,
12-entry histories with duplicates and padding. Tolerance: the ``TOL`` of
``tests/test_torch_apl_gen_fused.py`` (rtol 1e-5, atol 1e-6) for every
output, both sides f32 with the same formulas summed in another order. That
file's ``EDGE_ATOL`` (its I = 131 case's z near 0) is not needed on these
draws: the largest excess over rtol is 8.6e-7 (z and m2 at d = 50).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.models.apl import APL as JaxAPL
from acf_tpu.ops.apl_gen_fused import apl_gen_backward as jax_backward
from acf_tpu.ops.apl_gen_fused import apl_gen_forward as jax_forward
from acf_tpu_torch.models.apl import APL
from acf_tpu_torch.ops.apl_gen_fused import (
    KERNELS, MAX_WHOLE_D, SMEM_LIMIT, apl_bigr_plain, apl_fake_plain, apl_grad_plain,
    apl_stats1_plain, apl_z_plain, check_operands, smem_footprints,
)
from tests.test_torch_apl_gen_fused import TOL, W, T, port_member

WIDTHS = (3, 10, 50, 130)
B, NUM_ITEMS, NUM_USERS = 33, 131, 40
REG_G = 0.01  # a generator regularization, so that the step's reg terms are held too


def step_inputs(d, seed):
    """numpy inputs of one generator step: both players' tables (logits of
    a few units), a batch of users with repeats (so gP's scatter sums rows),
    their positive items, histories with duplicates, left padding and one
    empty row, and Gumbel noise."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.4 * rng.standard_normal(s)).astype(np.float32)
    hist = rng.integers(1, NUM_ITEMS, (B, 12)).astype(np.int32)
    hist[:, :3] = hist[:, 3:6]
    hist[:, :2] = 0
    hist[0] = 0
    u = rng.uniform(0.0, 1.0, (B, NUM_ITEMS)).astype(np.float32)
    return dict(Pg=f(NUM_USERS, d), Qg=f(NUM_ITEMS, d), Pc=f(NUM_USERS, d), Qc=f(NUM_ITEMS, d),
                users=rng.integers(0, NUM_USERS, B).astype(np.int32),
                items=rng.integers(1, NUM_ITEMS, B).astype(np.int32), hist=hist,
                gnoise=-np.log(-np.log(u + 1e-20) + 1e-20).astype(np.float32))


@functools.cache
def jax_step(d):
    """The JAX chain in interpret mode on ``step_inputs(d)``, composed as
    ``gen_step_fused`` composes it: the chain's outputs, ``a`` = ∂L/∂fake
    and the step's (loss, gP, gQ)."""
    x = step_inputs(d, seed=d)
    model = JaxAPL(NUM_USERS, NUM_ITEMS, d, reg_g=REG_G)
    users, items = jnp.asarray(x["users"]), jnp.asarray(x["items"])
    hist = jnp.asarray(x["hist"])
    pu_g, Qg = jnp.asarray(x["Pg"])[users], jnp.asarray(x["Qg"])
    pu_c, Qc = jnp.asarray(x["Pc"])[users], jnp.asarray(x["Qc"])
    rows = jnp.arange(B)[:, None]
    member = jnp.zeros((B, NUM_ITEMS), jnp.bfloat16).at[rows, hist].max(
        (hist != 0).astype(jnp.bfloat16))
    nuniq = jnp.maximum(member.astype(jnp.float32).sum(-1), 1.0)
    fake, res = jax_forward(pu_g, Qg, pu_c, Qc, member, nuniq, jnp.asarray(x["gnoise"]), w=W,
                            temperature=T, interpret=True)
    real = jnp.sum(pu_c * Qc[items], -1)
    g_main, a = jax.value_and_grad(lambda f: model._losses(real, f, 0.0, 0.0)[0])(fake)
    dP_rows, dQ = jax_backward(pu_g, pu_c, nuniq, a, res, w=W, temperature=T, interpret=True)
    gP = jnp.zeros((NUM_USERS, d)).at[users].add(dP_rows + REG_G * pu_g)
    gQ = dQ[:NUM_ITEMS] + REG_G * Qg
    loss = g_main + REG_G * (jnp.sum(jnp.square(pu_g)) + jnp.sum(jnp.square(Qg))) / 2
    _, _, _, z, m1, l1, m2, l2, _, _ = res
    chain = dict(fake=fake, z=z[:, :NUM_ITEMS], m1=m1[:, 0], l1=l1[:, 0], m2=m2[:, 0],
                 l2=l2[:, 0], dP=dP_rows, dQ=dQ[:NUM_ITEMS])
    return (x, {k: np.asarray(v) for k, v in chain.items()}, np.asarray(a),
            (float(loss), np.asarray(gP), np.asarray(gQ)))


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_passes_match_the_jax_kernels_at_width(d):
    """The port's five plain passes on the JAX step's inputs and its ∂L/∂fake,
    against the JAX chain's outputs."""
    x, ref, a, _ = jax_step(d)
    member, nuniq = port_member({"hist": x["hist"]}, NUM_ITEMS)
    users = torch.from_numpy(x["users"]).long()
    pu_g, pu_c = torch.from_numpy(x["Pg"])[users], torch.from_numpy(x["Pc"])[users]
    Qg, Qc, gn = (torch.from_numpy(x[k]) for k in ("Qg", "Qc", "gnoise"))

    m1, l1 = apl_stats1_plain(pu_g, Qg)
    z, m2, l2 = apl_z_plain(pu_g, Qg, member, nuniq, gn, m1, l1, w=W, temperature=T)
    fake = apl_fake_plain(pu_c, Qc, z, m2, l2)
    chain = (pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, torch.tensor(a), fake)
    R = apl_bigr_plain(*chain, w=W, temperature=T)
    dQ, dP = apl_grad_plain(*chain, R, w=W, temperature=T)
    got = dict(m1=m1, l1=l1, z=z, m2=m2, l2=l2, fake=fake, dP=dP, dQ=dQ)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), ref[name], err_msg=f"d={d} {name}", **TOL)
    assert torch.isfinite(R).all() and not dQ[0].any()


@pytest.mark.parametrize("d", WIDTHS)
def test_generator_step_matches_jax_at_width(d):
    """``APL.gen_step`` on the CPU (the wrappers' plain passes, ``a`` through
    the log loss head, gP scattered over repeated users, the reg terms)
    against the step written from the JAX chain: loss, gP and gQ. No kernel
    launches on CPU tensors."""
    x, _, _, (loss_ref, gP_ref, gQ_ref) = jax_step(d)
    model = APL(NUM_USERS, NUM_ITEMS, d, reg_g=REG_G)
    g = {"P": torch.from_numpy(x["Pg"]), "Q": torch.from_numpy(x["Qg"])}
    c = {"P": torch.from_numpy(x["Pc"]), "Q": torch.from_numpy(x["Qc"])}
    before = [k.launches for k in KERNELS]
    loss, grads = model.gen_step(g, c, torch.from_numpy(x["users"]).long(),
                                 torch.from_numpy(x["items"]).long(),
                                 torch.from_numpy(x["hist"]), torch.from_numpy(x["gnoise"]))
    assert [k.launches for k in KERNELS] == before
    np.testing.assert_allclose(float(loss), loss_ref, err_msg=f"d={d} loss", **TOL)
    np.testing.assert_allclose(grads["P"].numpy(), gP_ref, err_msg=f"d={d} gP", **TOL)
    np.testing.assert_allclose(grads["Q"].numpy(), gQ_ref, err_msg=f"d={d} gQ", **TOL)


def test_the_width_rule_takes_every_width():
    """Every d in 1..512 passes the wrapper's checks (all but the device's)
    with tables at an element's alignment, and every kernel's block fits in
    the shared memory a Hopper block may use; d = 0 is refused."""
    buf = torch.zeros(3 * 512 + 1)
    for d in range(1, 513):
        users = buf[1:1 + 2 * d].view(2, d)  # one float off a 16-byte boundary
        check_operands(pu_g=users, Qg=torch.zeros(3, d), nuniq=torch.ones(2),
                       member=torch.zeros(2, 3, dtype=torch.uint8)[:, :3])
        assert max(smem_footprints(d).values()) <= SMEM_LIMIT, d
    assert max(smem_footprints(MAX_WHOLE_D + 1).values()) < max(
        smem_footprints(MAX_WHOLE_D).values())
    with pytest.raises(ValueError, match="d >= 1"):
        check_operands(pu_g=torch.zeros(2, 0), Qg=torch.zeros(3, 0))
    with pytest.raises(ValueError, match="uint8"):
        check_operands(pu_g=torch.zeros(2, 50), Qg=torch.zeros(3, 50),
                       member=torch.zeros(2, 3))
