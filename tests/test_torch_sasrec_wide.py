"""SASRec at the widths and windows the kernels newly take: widths that are
not multiples of 4 (d = 10, 18) and windows past the old backward limits
(T = 96 and 130 at d = 16; K2b's tile form took 79 at d = 64 and 127 at
d = 32), on the CPU against the JAX package; the limits and the choice of
K2b's form; and the command line at ``--d 10 --maxlen 96`` against the JAX
command line's model on one injected step.

The JAX side runs its default XLA path (``fused="never"``, what
``fused="auto"`` means); the port's CPU path is the kernels' plain versions,
the hand-derived backward included, so the gradients follow the derivation
K2b follows. The dropout masks are JAX's own draws, injected.

Tolerances, as ``tests/test_torch_sasrec_train.py``'s: losses and aux
values rtol 1e-5 (f32 sums in another order); gradients rtol 1e-4 and an
atol of 1e-5 times the largest entry of the whole gradient tree (the item
table's gradient is a scatter-add summed in another order, the key bias's
gradient is analytically zero and rounding noise on both sides, and the
FGSM directions carry the inner gradient's rounding into the outer one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.cli.main import build_parser as jax_build_parser
from acf_tpu.cli.main import make_model as jax_make_model
from acf_tpu.data import load_dataset as jax_load_dataset
from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
from acf_tpu_torch.cli import main as cli
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.data import load_dataset
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.ops.sasrec_fused import (
    MAX_D, MAX_T, SMEM_LIMIT, _bwd_fits, _bwd_form, _bwd_layout, _bwd_wide_layout, _layout,
    check_supported, max_train_window, max_window,
)
from acf_tpu_torch.train.checkpoint import _flatten_with_names
from acf_tpu_torch.utils.tree import tree_leaves, tree_map

CPU = "cpu"
NUM_ITEMS, B = 40, 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
CONFIGS = {"sasrec": {}, "asasrec": dict(adversarial=True, eps=0.5, reg_adv=1.0)}


def window_batch(t, seed, num_items=NUM_ITEMS, b=B):
    """(users, window [b, T+1], neg [b, T]): row 0 left-padded, row 1 all
    padding but its last (target) item, negatives 0 on pad positions."""
    rng = np.random.default_rng(seed)
    window = rng.integers(1, num_items, (b, t + 1)).astype(np.int32)
    window[0, : t // 2] = 0
    window[1, :t] = 0
    neg = rng.integers(1, num_items, (b, t)).astype(np.int32)
    neg[window[:, 1:] == 0] = 0
    return np.arange(b, dtype=np.int32), window, neg


def step_matches(jm, tm, t, seed, num_items=NUM_ITEMS):
    """One ``loss_window`` step of the JAX model and of the port from the
    same params, batch and dropout draws: the loss, the aux values and every
    gradient leaf."""
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    batch = window_batch(t, seed, num_items)
    key = jax.random.PRNGKey(seed + 1)
    (jl, jaux), jg = jax.value_and_grad(jm.loss_window, has_aux=True)(jp, batch, key)
    k_enc, _ = jax.random.split(key)
    masks = params_from_numpy(jax.tree.map(np.asarray, jm._dropout_masks(k_enc, B, t)),
                              device=CPU)
    prm = tree_map(lambda x: x.detach().requires_grad_(True), tp)
    loss, aux = tm.loss_window(prm, tuple(torch.from_numpy(x) for x in batch), masks=masks)
    grads = torch.autograd.grad(loss, tree_leaves(prm), allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **LOSS_TOL)
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **LOSS_TOL, err_msg=k)
    ref = jax_named(jg)
    got = {n: np.zeros(x.shape, np.float32) if g is None else g.numpy()
           for (n, x), g in zip(_flatten_with_names(tp), grads)}
    assert ref.keys() == got.keys()
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("d,t", [(10, 8), (18, 8), (16, 96), (16, 130)])
def test_loss_and_every_grad_match_jax(d, t, config):
    """Two blocks, one head, dropout 0.3, B = 3, at the new widths and
    windows."""
    kw = dict(maxlen=t, dropout_rate=0.3, num_blocks=2, **CONFIGS[config])
    jm = JaxSASRec(10, NUM_ITEMS, d, fused="never", **kw)
    tm = SASRec(10, NUM_ITEMS, d, **kw)
    step_matches(jm, tm, t, seed=d + t)


def test_max_train_window_is_max_window_at_every_width():
    """Training takes every window serving takes, at every width the kernels
    take."""
    for d in range(1, MAX_D + 1):
        assert max_train_window(d) == max_window(d) >= 1, d
    assert max_window(50) == MAX_T and max_window(128) == 108


@pytest.mark.parametrize("d", [1, 3, 10, 18, 50, 100, 127])
def test_check_supported_takes_any_width_to_128(d):
    """Widths that are not multiples of 4, in serving and in training, up to
    the widest window."""
    for train in (False, True):
        check_supported(1, d, 1, 2, train=train)
        check_supported(max_window(d), d, 1, 2, train=train)


@pytest.mark.parametrize("kw,match", [
    (dict(t=8, d=64, num_heads=2), "single-head"),
    (dict(t=201, d=64, num_heads=1), "1 to 200 items at d=64; got t=201"),
    (dict(t=8, d=132, num_heads=1), "1 <= d <= 128; got d=132"),
    (dict(t=8, d=0, num_heads=1), "1 <= d <= 128; got d=0"),
    (dict(t=8, d=64, num_heads=1, num_blocks=9), "at most 8 blocks"),
])
def test_check_supported_still_raises(kw, match):
    """What stays refused: several heads, a window past max_window(d), d past
    128 (or 0) and more than 8 blocks, in serving and in training alike."""
    for train in (False, True):
        with pytest.raises(ValueError, match=match):
            check_supported(train=train, **kw)


def test_k2b_form_follows_shape_and_alignment():
    """The tile form keeps every window it took (1..79 at d = 64, 1..44 at
    d = 128) where its 16-byte copies take the rows; everything else goes to
    the wide form, whose cluster's CTAs fit every window K2a takes."""
    assert [t for t in range(1, 201) if _bwd_form(t, 64) == "tile"] == list(range(1, 80))
    assert [t for t in range(1, 109) if _bwd_form(t, 128) == "tile"] == list(range(1, 45))
    assert _bwd_form(50, 64, aligned=False) == "wide"
    assert all(_bwd_form(t, d) == "wide" for d in (10, 18, 50) for t in (1, 8, 50))
    for d in range(1, MAX_D + 1):
        for t in (1, max_window(d)):
            cluster, ks, threads, smem = _bwd_wide_layout(t, d)
            assert threads == 512 and smem <= SMEM_LIMIT and cluster in (1, 2, 4) and ks >= 4
        assert _layout(max_window(d), d)[2] <= SMEM_LIMIT
    assert _bwd_fits(79, 64) and _bwd_layout(79, 64)[2] <= SMEM_LIMIT < _bwd_layout(80, 64)[2]


CLI_ARGS = ["--data", "test", "--path", "data/", "--d", "10", "--maxlen", "96", "--bs", "64",
            "--model", "asasrec"]


def test_cli_asasrec_d10_maxlen96_runs_and_matches_jax_on_one_step(tmp_path):
    """``--model asasrec --d 10 --maxlen 96`` through the port's command line
    on the CPU (one clean and one adversarial epoch, an evaluation after
    each), then the models both command lines build for it: the same
    hyperparameters, and one injected step of the adversarial model equal
    to JAX's."""
    best = cli.main(CLI_ARGS + ["--epochs", "2", "--adv_epoch", "1", "--device", "cpu",
                                "--opath", str(tmp_path) + "/"])
    assert np.isfinite(best["ndcg"]) and best["epoch"] >= 0
    lines = next(tmp_path.glob("*.out")).read_text().splitlines()
    assert len([x for x in lines if x.startswith("Epoch ") and "HR =" in x]) == 2
    args = cli.build_parser().parse_args(CLI_ARGS + ["--device", "cpu"])
    port = cli.make_model("asasrec", load_dataset("test", "data/"), args)[0]
    jm = jax_make_model("asasrec", jax_load_dataset("test", "data/"),
                        jax_build_parser().parse_args(CLI_ARGS))[0]
    assert (port.dim, port.maxlen, port.num_heads, port.adversarial) == (10, 96, 1, True)
    assert (jm.dim, jm.maxlen, jm.num_heads, jm.eps, jm.reg_adv, jm.dropout_rate) == (
        port.dim, port.maxlen, port.num_heads, port.eps, port.reg_adv, port.dropout_rate)
    assert jm.fused == "auto"  # the XLA path: "auto" means never
    step_matches(jm, port, 96, seed=3, num_items=port.num_items)
