"""The port's data-parallel pair epochs and the sparse step's mesh epoch on
CPU ranks against the JAX package's mesh trainer (``TrainConfig.mesh``, and
``acf_tpu/ops/sparse_step.py::_make_mesh_epoch_fn`` for the sparse step) on
conftest's virtual CPU devices, a mesh of the same shape on each side.

Each JAX trainer runs first. The draws of each of its epochs (the pair
batches and the negative candidates, ``tests/test_torch_apr.py::
jax_pair_draws``) and its initial params go to the port's ranks, which
inject them into the port's mesh epochs (``tests/torch_rank_cases.py::
train``): both sides then train on the same examples, and only the order of
the sums differs. One launch a mesh runs:

* APR two-phase: one clean MF-BPR epoch, then one APR epoch on the closed
  form, the Adagrad slots reset between them;
* DNS (three candidates) with APR, one epoch;
* the sparse row-space APR step, two epochs.

Tolerances, those that hold the port's single-device epochs to the JAX
package's (``tests/test_torch_apr.py``, ``tests/test_torch_sparse_step.py``),
all tighter than JAX's own mesh bars (``tests/test_parallel.py``: rtol 2e-4
for the pair trainer, 1e-6 for the sparse step): the params rtol 1e-5 and,
under APR, atol 1e-5 of the table's largest entry after its first APR epoch
and 1e-4 after the second (FGSM normalizes each row's gradient, so an ulp of
a small row's gradient turns its delta by ulp/|g|); the clean epoch's params
and every Adagrad slot rtol 1e-5, atol 1e-8; the losses rtol 1e-5; the
accuracies within 1e-6. Every rank's state is equal bit for bit.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest

from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.ops.sparse_step import SparseMFBPR as JaxSparseMFBPR
from acf_tpu.parallel.mesh import make_mesh
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu.train.checkpoint import _flatten_with_names
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.mf import MFBPR
from acf_tpu_torch.ops.sparse_step import SparseMFBPR
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.parallel.mesh import parse_spec
from acf_tpu_torch.train import adagrad
from tests.test_torch_apr import jax_pair_draws
from tests.test_trainer import synthetic_data

CASES = "tests.torch_rank_cases"
SPECS = ("1x2", "2x1", "2x2")
TIMEOUT = 120.0
BATCH = 32
SEED = 41
APR = dict(adversarial=True, eps=0.5, reg_adv=1.0)
# (rtol, atol) of the params after an epoch of each kind: a clean epoch, the
# first APR epoch and any later one (atol as a share of the table's scale)
CLEAN_TOL = (1e-5, 1e-8)
APR_ATOL = (1e-5, 1e-4)
SLOT_TOL = (1e-5, 1e-8)


def runs(U, I):
    """name -> (JAX models, port models, epochs of each, DNS candidates)."""
    sparse = dict(APR, reg=0.01, lr=0.05)
    return {
        "apr": ([JaxMFBPR(U, I, 8, reg=0.01), JaxMFBPR(U, I, 8, reg=0.01, **APR)],
                [MFBPR(U, I, 8, reg=0.01), MFBPR(U, I, 8, reg=0.01, **APR)], [1, 1], 1),
        "dns": ([JaxMFBPR(U, I, 8, dns=3, **APR)], [MFBPR(U, I, 8, dns=3, **APR)], [1], 3),
        "sparse": ([JaxSparseMFBPR(U, I, 8, **sparse)], [SparseMFBPR(U, I, 8, **sparse)],
                   [2], 1),
    }


NAMES = ("apr", "dns", "sparse")


def optimizers(name):
    """(JAX's, the port's): the sparse step's own Adagrad reads neither."""
    if name == "sparse":
        return optax.adagrad(0.05), adagrad(0.05)
    return (optax.adagrad(0.05, initial_accumulator_value=0.1),
            adagrad(0.05, initial_accumulator_value=0.1))


def jax_run(spec, name, jax_models, epochs, dns):
    """The JAX mesh trainer's run: (initial params, the draws of each epoch,
    [(state by snapshot name, stats)] after each epoch)."""
    dp, m = parse_spec(spec)
    mesh = make_mesh(dp, m, devices=jax.devices()[:dp * m])
    jt = JaxTrainer(jax_models[0], synthetic_data(seed=SEED), optimizers(name)[0],
                    JaxConfig(batch_size=BATCH, verbose=10 ** 9, mesh=mesh))
    init = jax.tree.map(np.asarray, jax.device_get(jt.params))
    draws, after = [], []
    for i, (model, n) in enumerate(zip(jax_models, epochs)):
        if i:
            jt.switch_model(model, reset_opt=True)
        for _ in range(n):
            draws.append([x.numpy() for x in jax_pair_draws(jt, dns)])
            stats = jt.run_epoch()
            state = _flatten_with_names({"params": jax.device_get(jt.params),
                                         "opt": jax.device_get(jt.opt_state)})
            after.append((state, {k: float(v) for k, v in stats.items()}))
    return init, draws, after


@pytest.fixture(scope="module", params=SPECS)
def both(request):
    """(spec, {run: JAX's run}, each rank's results by run name): the JAX
    trainers, then one launch of the port's ranks."""
    spec = request.param
    data = Interactions(**dataclasses.asdict(synthetic_data(seed=SEED)))
    want, calls = {}, []
    for name, (jm, pm, epochs, dns) in runs(data.num_users, data.num_items).items():
        init, draws, after = jax_run(spec, name, jm, epochs, dns)
        want[name] = after
        calls.append(("train", (pm, optimizers(name)[1], data, epochs, None, SEED, BATCH, True,
                                init, draws)))
    dp, m = parse_spec(spec)
    got = launch.run(f"{CASES}:several", dp * m, spec, "cpu", calls, device="cpu",
                     timeout=TIMEOUT)
    return spec, want, [dict(zip(NAMES, r)) for r in got]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_epochs_match_the_jax_mesh_trainer(both, name):
    spec, want, res = both
    _, models, epochs, _ = runs(2, 2)[name]
    adv_epochs = sum(n for m, n in zip(models, epochs) if m.adversarial)
    state = want[name][-1][0]
    for r, x in enumerate(res):
        got = x[name]
        assert set(got["state"]) == set(state), (spec, name)
        for k, w in state.items():
            if k.startswith("params/"):
                rtol, atol = CLEAN_TOL if not adv_epochs else (
                    CLEAN_TOL[0], APR_ATOL[min(adv_epochs, 2) - 1] * np.abs(w).max())
            else:
                rtol, atol = SLOT_TOL
            np.testing.assert_allclose(got["state"][k], w, rtol=rtol, atol=atol,
                                       err_msg=f"{spec} rank {r} {name} {k}")
        assert len(got["stats"]) == len(want[name])
        for epoch, (s, (_, w)) in enumerate(zip(got["stats"], want[name])):
            assert set(s) == set(w), (spec, name, epoch)
            np.testing.assert_allclose(s["loss"], w["loss"], rtol=1e-5)
            for k in set(w) - {"loss", "loss_adv"}:
                assert s[k] == pytest.approx(w[k], abs=1e-6), (spec, name, epoch, k)
            if "loss_adv" in w:
                np.testing.assert_allclose(s["loss_adv"], w["loss_adv"], rtol=1e-5)
        assert ("acc_adv" in got["stats"][-1]) == models[-1].adversarial
    for x in res[1:]:  # every rank applied the same updates
        for k in state:
            np.testing.assert_array_equal(x[name]["state"][k], res[0][name]["state"][k])
