"""The port's data-parallel sequence steps on CPU ranks against the JAX
package's mesh trainer (``TrainConfig.mesh``) on conftest's virtual CPU
devices, a mesh of the same shape on each side (2x1 and 2x2: with one data
rank the port's trainer is its single-device one): an ASASRec epoch and an
ASASRec2 epoch.

The JAX trainer runs first. Its initial params and the draws of each of its
steps (the window batch and the dropout masks its loss draws from the
step's key) go to the port's ranks, which step
:func:`~acf_tpu_torch.train.trainer.seq_train_step` on the data-parallel
copy of the model with them, each data rank on its rows and the gradients
summed over "data", as the port's mesh epoch does
(``tests/torch_rank_cases.py::seq_steps``). The epoch's own draws and row
split are held against the port's single-device epoch in
``tests/test_torch_parallel_train.py``.

Tolerances: the attention's key bias (``wk/b``) and its Adam slots rtol
1e-3, atol 5e-4, JAX's own bar for its mesh sequence trainer against one
device (``tests/test_parallel.py:327``): its gradient is zero but for
rounding, which Adam scales up to steps of ~lr (3.1e-4 at 2x1 here). Every
other leaf rtol 1e-4, atol 1e-6 (params move by ~1e-3 a step). Every rank's
state is equal bit for bit.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest

from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.parallel.mesh import make_mesh
from acf_tpu.sampling.negatives import sample_seq_window_batch as jax_window_batch
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu.train.checkpoint import _flatten_with_names
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.parallel.mesh import parse_spec
from acf_tpu_torch.train import adam
from tests.test_sasrec import seq_data

CASES = "tests.torch_rank_cases"
SPECS = ("2x1", "2x2")
TIMEOUT = 120.0
BATCH = 16
SEED = 5
KEY_BIAS_TOL = dict(rtol=1e-3, atol=5e-4)
TOL = dict(rtol=1e-4, atol=1e-6)
NAMES = ("asasrec", "asasrec2")


def runs(U, I):
    """name -> (JAX model, port model), one epoch each."""
    kw = dict(maxlen=8, num_blocks=1, dropout_rate=0.3)
    adv2 = dict(adv_mode="asasrec2", eps_dense=0.1, l2_emb=1e-3)
    jax_kw = dict(fused="never", train_dtype="float32")
    return {name: (JaxSASRec(U, I, 16, adversarial=True, **extra, **kw, **jax_kw),
                   SASRec(U, I, 16, adversarial=True, **extra, **kw))
            for name, extra in (("asasrec", {}), ("asasrec2", adv2))}


def np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def jax_seq_draws(jt, model):
    """The draws of the JAX trainer's next sequence epoch
    (acf_tpu/train/trainer.py:173-190): per step the window batch of ``ks``
    and the dropout masks the loss draws from ``kl`` (its training pass
    from the first half of ``split(kl)``; asasrec2's adversarial pass from
    the second)."""
    _, k = jax.random.split(jt.key)
    b, t = jt.cfg.batch_size, model.maxlen
    batches, masks = [], []
    for kk in jax.random.split(k, jt.num_batches):
        ks, kl = jax.random.split(kk)
        batches.append(np_tree(jax_window_batch(ks, jt.dev["hist"], jt.dev["eligible"], t,
                                                model.num_items, b)))
        k_enc, k_adv = jax.random.split(kl)
        adv = model.adversarial and model.adv_mode == "asasrec2"
        masks.append((np_tree(model._dropout_masks(k_enc, b, t)),
                      np_tree(model._dropout_masks(k_adv, b, t)) if adv else None))
    return batches, masks


def jax_run(spec, model):
    """The JAX mesh trainer's epoch: (initial params, its batches, their
    masks, the final state by snapshot name)."""
    dp, m = parse_spec(spec)
    mesh = make_mesh(dp, m, devices=jax.devices()[:dp * m])
    jt = JaxTrainer(model, seq_data(seed=SEED), optax.adam(1e-3, b2=0.98),
                    JaxConfig(batch_size=BATCH, verbose=10 ** 9, mesh=mesh))
    init = np_tree(jt.params)
    batches, masks = jax_seq_draws(jt, model)
    jt.run_epoch()
    return init, batches, masks, _flatten_with_names({"params": np_tree(jt.params),
                                                      "opt": np_tree(jt.opt_state)})


@pytest.fixture(scope="module", params=SPECS)
def both(request):
    """(spec, {run: JAX's final state}, each rank's results by run name)."""
    spec = request.param
    data = Interactions(**dataclasses.asdict(seq_data(seed=SEED)))
    want, calls = {}, []
    for name, (jm, pm) in runs(data.num_users, data.num_items).items():
        init, batches, masks, want[name] = jax_run(spec, jm)
        calls.append(("seq_steps", (pm, adam(1e-3, b2=0.98), init, batches, masks)))
    dp, m = parse_spec(spec)
    got = launch.run(f"{CASES}:several", dp * m, spec, "cpu", calls, device="cpu",
                     timeout=TIMEOUT)
    return spec, want, [dict(zip(NAMES, r)) for r in got]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_seq_steps_match_the_jax_mesh_trainer(both, name):
    spec, want, res = both
    state = want[name]
    for r, x in enumerate(res):
        got = x[name]["state"]
        assert set(got) == set(state), (spec, name, sorted(set(got) ^ set(state)))
        for k, w in state.items():
            tol = KEY_BIAS_TOL if "/wk/b" in k else TOL
            np.testing.assert_allclose(got[k], w, **tol, err_msg=f"{spec} rank {r} {name} {k}")
    for x in res[1:]:  # every rank applied the same updates
        for k in state:
            np.testing.assert_array_equal(x[name]["state"][k], res[0][name]["state"][k])
