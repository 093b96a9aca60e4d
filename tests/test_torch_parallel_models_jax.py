"""APL, IRGAN, AMF and Caser under the port's mesh on CPU ranks against the
JAX package's mesh trainer (``TrainConfig.mesh``) on conftest's virtual
CPU devices, a mesh of the same shape on each side (2x1 and 2x2: with one
data rank the port's epochs are their single-device selves, which their
own tests hold to the JAX package, and
``tests/test_torch_parallel_models.py`` holds 1x2 to one device).

Each JAX trainer runs first. Its initial params and the draws of each of
its epochs (the batches and the noise: ``jax_epoch_draws`` of
``tests/test_torch_apl.py``, ``tests/test_torch_irgan.py`` and
``tests/test_torch_caser.py``, ``jax_pop_draws`` of
``tests/test_torch_popularity.py``) go to the port's ranks, which inject
them into the models' own epochs (``tests/torch_rank_cases.py::train``):
every rank holds the global draws and takes its data rank's rows, as JAX's
``data_constrainer`` shards them. The runs are those of
``tests/test_torch_parallel_models.py``: APL with ``reg_g`` 0.1, whose
whole-table term must be added once; IRGAN with both players' L2, whose
batch factors must be the global batch's; AMF's two players; Caser, whose
loss divides by the global count of its positives.

Tolerances (rtol, atol) of every param and optimizer slot, ``TOL`` below,
each the one that holds the port's single-device epochs to the JAX
package's or tighter, and within the JAX package's own bars for its mesh
trainer against one device (``tests/test_parallel.py:500-592``: rtol 1e-3,
atol 5e-4 for APL, AMF and Caser, rtol 1e-4, atol 1e-5 for IRGAN):

* APL rtol 2e-4, atol 2e-6 (``tests/test_torch_apl.py``; the JAX mesh path
  takes autodiff through the [B, I] chain, the port its closed form);
* IRGAN rtol 1e-5, atol 1e-7 (``tests/test_torch_irgan.py``);
* AMF and Caser rtol 1e-5, atol 1e-5 of the largest entry of the leaf's
  tree (``tests/test_torch_popularity.py``, ``tests/test_torch_caser.py``:
  Adam's steps are ~lr whatever the gradient's size).

The epoch losses to rtol 1e-4 (IRGAN's G loss, a mean that cancels, to atol
1e-8), the accuracies within one row of the batch. Every rank's state is
equal bit for bit.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest

from acf_tpu.adversarial.popularity import PopularityAdversarial as JaxPop
from acf_tpu.models.apl import APL as JaxAPL
from acf_tpu.models.caser import Caser as JaxCaser
from acf_tpu.models.irgan import IRGAN as JaxIRGAN
from acf_tpu.models.mf import PointwiseMF as JaxPointwiseMF
from acf_tpu.parallel.mesh import make_mesh
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu.train.checkpoint import _flatten_with_names
from acf_tpu_torch.adversarial.popularity import PopularityAdversarial
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.apl import APL
from acf_tpu_torch.models.caser import Caser
from acf_tpu_torch.models.irgan import IRGAN
from acf_tpu_torch.models.mf import PointwiseMF
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.parallel.mesh import parse_spec
from acf_tpu_torch.train import adam, sgd
from tests import test_torch_apl, test_torch_caser, test_torch_irgan
from tests.test_sasrec import seq_data
from tests.test_torch_popularity import jax_pop_draws
from tests.test_trainer import synthetic_data

CASES = "tests.torch_rank_cases"
SPECS = ("2x1", "2x2")
TIMEOUT = 180.0
PAIR_BATCH = 32
SEQ_BATCH = 16
SEED = 41
# (rtol, atol, whether atol is a share of the leaf's tree's largest entry)
TOL = {"apl": (2e-4, 2e-6, False), "irgan": (1e-5, 1e-7, False), "amf": (1e-5, 1e-5, True),
       "caser": (1e-5, 1e-5, True)}
NAMES = tuple(TOL)


def caser_draws(jt):
    """The draws of the JAX Caser trainer's next epoch."""
    _, k = jax.random.split(jt.key)
    n_windows = int(jt.dev["win_seq"].shape[0])
    b = jt.cfg.batch_size
    return test_torch_caser.jax_epoch_draws(jt.model, k, n_windows, b, max(n_windows // b, 1))


def runs(pair, seq):
    """name -> (JAX model, port model, JAX optimizer, port optimizer, data,
    batch, epochs, the JAX trainer's draws of its next epoch)."""
    U, I = pair.num_users, pair.num_items
    sU, sI = seq.num_users, seq.num_items
    irgan = dict(d_lr=0.05, g_lr=0.05, lamda_d=0.5, lamda_g=0.1)
    pop = dict(weight=0.1, pop_percent=0.2)
    return {
        "apl": (JaxAPL(U, I, 8, reg_g=0.1), APL(U, I, 8, reg_g=0.1), optax.sgd(0.05), sgd(0.05),
                pair, PAIR_BATCH, 2, test_torch_apl.jax_epoch_draws),
        "irgan": (JaxIRGAN(U, I, 8, **irgan), IRGAN(U, I, 8, **irgan), optax.sgd(0.05),
                  sgd(0.05), pair, PAIR_BATCH, 2, test_torch_irgan.jax_epoch_draws),
        "amf": (JaxPop(U, I, 8, base=JaxPointwiseMF(U, I, 8), **pop),
                PopularityAdversarial(U, I, 8, base=PointwiseMF(U, I, 8), **pop),
                optax.adam(0.01), adam(0.01), pair, PAIR_BATCH, 1, jax_pop_draws),
        "caser": (JaxCaser(sU, sI, 16, maxlen=5), Caser(sU, sI, 16, maxlen=5), optax.adam(0.01),
                  adam(0.01), seq, SEQ_BATCH, 2, caser_draws),
    }


def jax_run(spec, run):
    """The JAX mesh trainer's run: (initial params, the draws of each epoch,
    [(state by snapshot name, stats)] after each epoch)."""
    jm, _, jopt, _, data, batch, epochs, draw = run
    dp, m = parse_spec(spec)
    mesh = make_mesh(dp, m, devices=jax.devices()[:dp * m])
    jt = JaxTrainer(jm, data, jopt, JaxConfig(batch_size=batch, verbose=10 ** 9, mesh=mesh))
    init = jax.tree.map(np.asarray, jax.device_get(jt.params))
    draws, after = [], []
    for _ in range(epochs):
        drawn = draw(jt)
        draws.append(jax.tree.map(lambda x: x.numpy(), drawn))
        stats = jt.run_epoch()
        state = _flatten_with_names({"params": jax.device_get(jt.params),
                                     "opt": jax.device_get(jt.opt_state)})
        after.append(({k: np.asarray(v) for k, v in state.items()},
                      {k: float(v) for k, v in stats.items()}))
    return init, draws, after


@pytest.fixture(scope="module", params=SPECS)
def both(request):
    """(spec, {run: JAX's run}, each rank's results by run name): the JAX
    trainers, then one launch of the port's ranks."""
    spec = request.param
    pair = synthetic_data(seed=SEED)
    seq = seq_data(seed=5)
    want, calls = {}, []
    for name, run in runs(pair, seq).items():
        init, draws, after = jax_run(spec, run)
        want[name] = after
        _, pm, _, popt, data, batch, epochs, _ = run
        calls.append(("train", ([pm], popt, Interactions(**dataclasses.asdict(data)), [epochs],
                                None, SEED, batch, True, init, draws)))
    dp, m = parse_spec(spec)
    got = launch.run(f"{CASES}:several", dp * m, spec, "cpu", calls, device="cpu",
                     timeout=TIMEOUT)
    return spec, want, [dict(zip(NAMES, r)) for r in got]


def tree_scales(state):
    """The largest |entry| of each leaf's tree (its name less the last
    part)."""
    out = {}
    for k, w in state.items():
        tree = k.rsplit("/", 1)[0]
        out[tree] = max(out.get(tree, 0.0), float(np.abs(w).max()) if w.size else 0.0)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_mesh_epochs_match_the_jax_mesh_trainer(both, name):
    spec, want, res = both
    rtol, atol, of_tree = TOL[name]
    batch = SEQ_BATCH if name == "caser" else PAIR_BATCH
    state = want[name][-1][0]
    scales = tree_scales(state)
    for r, x in enumerate(res):
        got = x[name]
        assert set(got["state"]) == set(state), (spec, name)
        for k, w in state.items():
            tol = atol * scales[k.rsplit("/", 1)[0]] if of_tree else atol
            np.testing.assert_allclose(got["state"][k], w, rtol=rtol, atol=tol,
                                       err_msg=f"{spec} rank {r} {name} {k}")
        assert len(got["stats"]) == len(want[name])
        for epoch, (s, (_, w)) in enumerate(zip(got["stats"], want[name])):
            assert set(s) == set(w), (spec, name, epoch)
            for k in w:
                if k.startswith("acc"):
                    assert abs(s[k] - w[k]) <= 1.0 / batch + 1e-6, (spec, name, epoch, k)
                elif name == "irgan" and k == "loss":
                    assert abs(s[k] - w[k]) <= 1e-8, (spec, name, epoch, s[k], w[k])
                else:
                    np.testing.assert_allclose(s[k], w[k], rtol=1e-4,
                                               err_msg=f"{spec} {name} {epoch} {k}")
    for x in res[1:]:  # every rank applied the same updates
        for k in state:
            np.testing.assert_array_equal(x[name]["state"][k], res[0][name]["state"][k])
