"""The port's sparse row-space step (``acf_tpu_torch/ops/sparse_step.py``) on
the CPU against the JAX package's (``acf_tpu/ops/sparse_step.py``, modelled
on ``tests/test_sparse_step.py``): whole epochs with the JAX epoch's draws
injected, both dedup programs, clean and APR; against the port's dense pair
trainer; the pad row; the dedup programs; ``fit_two_phase``; snapshots.

Tolerances:

* epochs against JAX: params rtol 1e-5 and atol 1e-8 clean. Under APR,
  atol 1e-5 of the table's largest entry after the first epoch
  (``APR_PARAM_ATOL``, as ``tests/test_torch_apr.py``: FGSM normalizes each
  row's summed gradient, so an ulp of a small row turns its delta by
  ulp/|g|) and 1e-4 of it after the second and third (``APR_DRIFT_ATOL``):
  the drift compounds, and the JAX package's own two dedup programs end
  three epochs 1.1e-5 of that scale apart on these sets, the port 2.0e-5
  from JAX (with XLA's ``rsqrt`` an ulp off ``torch.rsqrt`` on top of the
  sums' order). The Adagrad slots rtol 1e-5 (XLA's CPU ``rsqrt`` differs
  from ``torch.rsqrt`` by an ulp for a third of the inputs); the loss rtol
  1e-5, the accuracies within 1e-6.
* against the dense trainer: ``tests/test_sparse_step.py``'s rtol 2e-4,
  atol 2e-6 on the params and rtol 1e-3 on the loss (the dense step sums
  the same gradients through autograd's table scatter).
* the dedup programs: slots exact, sums rtol 1e-6 (the same f32 adds in
  another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.ops.sparse_step import SparseMFBPR as JaxSparseMFBPR
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.models.mf import MFBPR
from acf_tpu_torch.ops import sparse_step
from acf_tpu_torch.ops.ranking import rank_positions_dot
from acf_tpu_torch.ops.sparse_step import SparseMFBPR, dedup_matmul, dedup_sort
from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, fit_two_phase
from acf_tpu_torch.utils.io import OutputWriter
from tests.test_torch_pair_trainer import config, jax_pair_draws, port_data
from tests.test_trainer import synthetic_data

CPU = "cpu"
APR_PARAM_ATOL = 1e-5
APR_DRIFT_ATOL = 1e-4
KW = dict(reg=0.01, eps=0.5, reg_adv=1.0)


def pair(seed, adversarial, dedup, **kw):
    """A JAX and a port trainer of SparseMFBPR on the same data, the port's
    params copied from the JAX trainer's init."""
    jd = synthetic_data(seed=seed)
    args = dict(KW, adversarial=adversarial, lr=0.05, dedup=dedup, **kw)
    jt = JaxTrainer(JaxSparseMFBPR(jd.num_users, jd.num_items, 8, **args), jd,
                    optax.adagrad(0.05), JaxConfig(batch_size=32, verbose=10 ** 9))
    td = port_data(seed)
    tt = Trainer(SparseMFBPR(td.num_users, td.num_items, 8, **args), td, adagrad(0.05),
                 config())
    tt.params = params_from_numpy(jax.tree.map(np.asarray, jt.params), device=CPU)
    return jt, tt


@pytest.mark.parametrize("adversarial", [False, True], ids=["clean", "apr"])
@pytest.mark.parametrize("dedup", ["matmul", "sort"])
def test_epochs_match_jax(adversarial, dedup):
    """Three epochs, each with the JAX epoch's draws injected: params, the
    Adagrad slots and the epoch's stats after each."""
    jt, tt = pair(41, adversarial, dedup)
    assert tt.num_batches == jt.num_batches
    for name in ("accP", "accQ"):
        np.testing.assert_array_equal(tt.opt_state[name].numpy(), np.asarray(jt.opt_state[name]))
    for epoch in range(3):
        draws = jax_pair_draws(jt)
        js = jt.run_epoch()
        tt.params, tt.opt_state, ts = tt.epoch_fn(tt.params, tt.opt_state, tt.dev, tt.generator,
                                                  *draws)
        keys = {"loss", "acc"} | ({"acc_adv"} if adversarial else set())
        assert set(ts) == set(js) == keys
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
        for k in keys - {"loss"}:
            assert ts[k] == pytest.approx(js[k], abs=1e-6), k
        for name in ("P", "Q"):
            want = np.asarray(jt.params[name])
            if adversarial:
                atol = (APR_DRIFT_ATOL if epoch else APR_PARAM_ATOL) * np.abs(want).max()
            else:
                atol = 1e-8
            np.testing.assert_allclose(tt.params[name].numpy(), want, rtol=1e-5, atol=atol,
                                       err_msg=f"epoch {epoch} {name}")
            np.testing.assert_allclose(tt.opt_state["acc" + name].numpy(),
                                       np.asarray(jt.opt_state["acc" + name]), rtol=1e-5,
                                       err_msg=f"epoch {epoch} acc{name}")


@pytest.mark.parametrize("adversarial", [False, True], ids=["clean", "apr"])
@pytest.mark.parametrize("dedup", ["matmul", "sort"])
def test_sparse_matches_the_dense_trainer(adversarial, dedup):
    """``tests/test_sparse_step.py::test_sparse_matches_dense_epoch`` in the
    port: the same seed gives both trainers the same draws (the sparse
    epoch draws in the pair epoch's order), three epochs."""
    data = port_data(41)
    kw = dict(KW, adversarial=adversarial)
    dense = Trainer(MFBPR(data.num_users, data.num_items, 8, **kw), data,
                    adagrad(0.05, initial_accumulator_value=0.1), config(seed=5))
    sparse = Trainer(SparseMFBPR(data.num_users, data.num_items, 8, lr=0.05, dedup=dedup, **kw),
                     data, adagrad(0.05, initial_accumulator_value=0.1), config(seed=5))
    for name in ("P", "Q"):
        assert torch.equal(dense.params[name], sparse.params[name])
    for _ in range(3):
        sd, ss = dense.run_epoch(), sparse.run_epoch()
    for name in ("P", "Q"):
        np.testing.assert_allclose(sparse.params[name].numpy(), dense.params[name].numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=name)
    np.testing.assert_allclose(ss["loss"], sd["loss"], rtol=1e-3)


@pytest.mark.parametrize("dedup", ["matmul", "sort"])
def test_pad_row_and_its_slot_stay_bit_identical(dedup):
    """``tests/test_sparse_step.py::test_sparse_untouched_rows_stay_put``:
    row 0 is never a real id, so its rows and slots in both tables keep
    their bits after an APR epoch, while the touched rows move."""
    data = port_data(42)
    tr = Trainer(SparseMFBPR(data.num_users, data.num_items, 8, adversarial=True, dedup=dedup),
                 data, adagrad(0.05), config(seed=1))
    before = {k: v.clone() for k, v in (*tr.params.items(), *tr.opt_state.items())}
    tr.run_epoch()
    after = {**tr.params, **tr.opt_state}
    for k, v in before.items():
        assert torch.equal(after[k][0], v[0]), k
        assert not torch.equal(after[k][1:], v[1:]), k
    assert before["P"].data_ptr() != after["P"].data_ptr()  # the caller's tables untouched


def test_auto_takes_matmul_up_to_4096(monkeypatch):
    model = SparseMFBPR(10, 10, 4)
    assert model.dedup_mode(4096) == "matmul" and model.dedup_mode(4097) == "sort"
    assert SparseMFBPR(10, 10, 4, dedup="sort").dedup_mode(8) == "sort"
    with pytest.raises(ValueError, match="dedup"):
        SparseMFBPR(10, 10, 4, dedup="hash").dedup_mode(8)
    calls = []
    for name in ("dedup_matmul", "dedup_sort"):
        real = getattr(sparse_step, name)
        monkeypatch.setattr(sparse_step, name,
                            lambda ids, real=real, name=name: calls.append(name) or real(ids))
    data = port_data(3)
    tr = Trainer(SparseMFBPR(data.num_users, data.num_items, 8), data, adagrad(0.05), config())
    tr.run_epoch()
    assert set(calls) == {"dedup_matmul"} and len(calls) == 2 * tr.num_batches


@pytest.mark.parametrize("program", [dedup_matmul, dedup_sort])
def test_dedup_programs_sum_each_id_once(program):
    """Slots: every id once (matmul: at its first occurrence, the rest 0;
    sort: ascending, padded with 0); agg: each id's rows summed into its
    slot, zeros elsewhere; delta_rows: each example's id's normalized sum."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 7, 24).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((24, 5)).astype(np.float32))
    slots, agg, delta_rows = program(ids)
    uniq = np.unique(ids.numpy())
    s = slots.numpy()
    assert sorted(s[s != 0].tolist()) == uniq.tolist() and s.shape == (24,)
    if program is dedup_sort:
        np.testing.assert_array_equal(s[:len(uniq)], uniq)
    else:
        first = [int(np.argmax(ids.numpy() == i)) for i in uniq]
        np.testing.assert_array_equal(np.nonzero(s)[0], sorted(first))
    want = {i: g.numpy()[ids.numpy() == i].sum(0) for i in uniq}
    a = agg(g).numpy()
    for slot, i in enumerate(s):
        np.testing.assert_allclose(a[slot], want[i] if i else 0.0, rtol=1e-6, atol=1e-7)
    d = delta_rows(g, 0.5).numpy()
    for n, i in enumerate(ids.numpy()):
        np.testing.assert_allclose(d[n], 0.5 * want[i] / np.linalg.norm(want[i]), rtol=1e-6,
                                   atol=1e-7)


def test_fit_two_phase_with_sparse_models(tmp_path):
    """``apr --sparse`` as the JAX CLI runs it: a clean and an adversarial
    SparseMFBPR in ``fit_two_phase``, the slots reset at the switch, an
    evaluation after each epoch (K1's plain version on the CPU: no launch)."""
    data = port_data(7)
    U, I = data.num_users, data.num_items
    clean = SparseMFBPR(U, I, 8)
    adv = SparseMFBPR(U, I, 8, adversarial=True, eps=0.5, reg_adv=1.0)
    seen = {}
    real_switch = Trainer.switch_model

    def switch(self, model, reset_opt=True):
        seen["before"] = float(self.opt_state["accP"].max())
        real_switch(self, model, reset_opt)
        seen["after"] = {k: float(v.max()) for k, v in self.opt_state.items()}
        seen["trainer"] = self

    Trainer.switch_model = switch
    try:
        best = fit_two_phase(clean, adv, data, adagrad(0.05), TrainConfig(batch_size=32, epochs=3, device=CPU),
                             adv_epoch=1, writer=OutputWriter(str(tmp_path) + "/", "sp"))
    finally:
        Trainer.switch_model = real_switch
    assert seen["before"] > 0.1 and seen["after"] == {"accP": pytest.approx(0.1),
                                                      "accQ": pytest.approx(0.1)}
    assert seen["trainer"].model is adv and np.isfinite(best["ndcg"]) and best["epoch"] >= 1
    lines = (tmp_path / "sp.out").read_text().splitlines()
    assert len([x for x in lines if x.startswith("Epoch ") and "HR =" in x]) == 3
    assert rank_positions_dot.launches == 0


def test_snapshot_names_match_the_jax_package(tmp_path):
    """A full-state snapshot keeps the slots as ``opt/accP`` and
    ``opt/accQ``, as the JAX trainer's does: the port restores the JAX
    package's, and writes those names."""
    jt, tt = pair(9, True, "matmul")
    jt.run_epoch()
    jt.save_checkpoint(str(tmp_path / "jax"))
    tt.restore_checkpoint(str(tmp_path / "jax"))
    for name in ("accP", "accQ"):
        np.testing.assert_array_equal(tt.opt_state[name].numpy(), np.asarray(jt.opt_state[name]))
    np.testing.assert_array_equal(tt.params["Q"].numpy(), np.asarray(jt.params["Q"]))
    tt.run_epoch()
    tt.save_checkpoint(str(tmp_path / "port"))
    with np.load(tmp_path / "port.npz") as f:
        assert {"params/P", "params/Q", "opt/accP", "opt/accQ", "rng"} == set(f.files)
        np.testing.assert_array_equal(f["opt/accQ"], tt.opt_state["accQ"].numpy())
