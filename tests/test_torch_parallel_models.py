"""Every model of the port under a mesh on CPU ranks, against the port's
single-device trainer from the same seed: APL (its generator step through
K3a–K3e's plain versions on each data rank's rows), IRGAN, the popularity
adversaries AMF, ABPR and ANeuMF, NeuMF, Caser, the sequence zoo (GRU4Rec
with each of its losses, DREAM, DRCF, DSIN), a naive baseline and the FGSM
wrapper over MF-BPR and over Caser, each under 1x2, 2x1 and 2x2.

The port runs 2 or 4 gloo ranks through ``parallel/launch.py``, one launch
a mesh for every case (``tests/torch_rank_cases.py::train``); the
single-device runs are the same function without a mesh. Every rank draws
the global batch and all of its noise from the seeded generator, as one
device does, so the runs differ only in the order of the sums over the data
ranks. The runs are set where a term that spans a whole table or the whole
batch shows: APL with ``reg_g`` 0.1, IRGAN with both players' L2 and SGD at
0.05, DSIN with ``l2_emb`` 1e-3.

Tolerances (rtol, atol) of every param and optimizer slot against one
device, all within the JAX package's own bars for its mesh trainer
(``tests/test_parallel.py:500-592``: rtol 1e-3, atol 5e-4 for the
popularity adversaries, APL and Caser; rtol 1e-4, atol 1e-5 for IRGAN's
SGD): rtol 1e-4 everywhere; atol 1e-6 for the SGD and Adagrad runs (APL,
IRGAN, the wrapper over MF-BPR, the baseline), 1e-5 for the Adam runs
(Adam divides each step by the root of its second moment, so a rounding
of the gradient's order moves a param by more: the largest seen on this
CPU 3.8e-7, DRCF's ``l2/w``), and 5e-5 for DSIN, whose attention key bias
``wk/b`` has a gradient that is zero but for rounding (3.9e-6 seen), as
SASRec's has. The epoch stats: losses to rtol 1e-5, accuracies within one
row of the batch. Every rank's state is equal bit for bit to every other
rank's.
"""

import dataclasses

import numpy as np
import pytest

from acf_tpu_torch.adversarial import FGSMAdversarial
from acf_tpu_torch.adversarial.popularity import PopularityAdversarial
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.apl import APL
from acf_tpu_torch.models.caser import Caser
from acf_tpu_torch.models.drcf import DRCF
from acf_tpu_torch.models.dream import DREAM
from acf_tpu_torch.models.dsin import DSIN
from acf_tpu_torch.models.gru4rec import GRU4Rec
from acf_tpu_torch.models.irgan import IRGAN
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.models.naive import MostPopular
from acf_tpu_torch.models.neumf import NeuMF
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.parallel.mesh import parse_spec
from acf_tpu_torch.train import adagrad, adam, sgd
from tests import torch_rank_cases as rank_cases
from tests.test_sasrec import seq_data
from tests.test_trainer import synthetic_data

CASES = "tests.torch_rank_cases"
SPECS = ("1x2", "2x1", "2x2")
TIMEOUT = 240.0
PAIR_BATCH = 32
SEQ_BATCH = 16
SEED = 13
TOL = (1e-4, 1e-6)
ADAM_TOL = (1e-4, 1e-5)
KEY_BIAS_TOL = (1e-4, 5e-5)


def runs(pair, seq):
    """name -> (models, optimizer, data, batch, epochs of each, (rtol, atol))."""
    U, I = pair.num_users, pair.num_items
    sU, sI = seq.num_users, seq.num_items
    pop = dict(weight=0.1, pop_percent=0.2)

    def popularity(base):
        return PopularityAdversarial(U, I, 8, base=base, **pop)

    def caser():
        return Caser(sU, sI, 16, maxlen=5)

    p, s = (pair, PAIR_BATCH), (seq, SEQ_BATCH)
    return {
        "apl": ([APL(U, I, 8, reg_g=0.1)], sgd(0.05), *p, [2], TOL),
        "apl_wgan": ([APL(U, I, 8, loss_function="wgan", reg_g=0.1)], sgd(0.05), *p, [1], TOL),
        "irgan": ([IRGAN(U, I, 8, d_lr=0.05, g_lr=0.05, lamda_d=0.5, lamda_g=0.1)],
                  sgd(0.05), *p, [2], TOL),
        "amf": ([popularity(PointwiseMF(U, I, 8))], adam(0.01), *p, [1], ADAM_TOL),
        "abpr": ([popularity(MFBPR(U, I, 8))], adam(0.01), *p, [1], ADAM_TOL),
        "aneumf": ([popularity(NeuMF(U, I, 8))], adam(0.01), *p, [1], ADAM_TOL),
        "neumf": ([NeuMF(U, I, 8)], adam(0.01), *p, [1], ADAM_TOL),
        "caser": ([caser()], adam(0.01), *s, [2], ADAM_TOL),
        "gru4rec": ([GRU4Rec(sU, sI, 16, maxlen=8)], adam(0.01), *s, [2], ADAM_TOL),
        "gru4rec_top1": ([GRU4Rec(sU, sI, 16, maxlen=8, loss_type="top1")], adam(0.01), *s,
                         [1], ADAM_TOL),
        "gru4rec_ce": ([GRU4Rec(sU, sI, 16, maxlen=8, loss_type="ce")], adam(0.01), *s, [1],
                       ADAM_TOL),
        "dream": ([DREAM(sU, sI, 16, maxlen=8)], adam(0.01), *s, [2], ADAM_TOL),
        "drcf": ([DRCF(sU, sI, 16, maxlen=5)], adam(0.01), *s, [1], ADAM_TOL),
        "dsin": ([DSIN(sU, sI, 16, sess_count=2, sess_len=4, l2_emb=1e-3)], adam(0.01), *s,
                 [2], KEY_BIAS_TOL),
        "naive": ([MostPopular(U, I, 8, data=pair)], adam(0.01), *p, [1], TOL),
        "fgsm_mf": ([MFBPR(U, I, 8), FGSMAdversarial(U, I, 8, base=MFBPR(U, I, 8))],
                    adagrad(0.05, initial_accumulator_value=0.1), *p, [1, 1], TOL),
        "fgsm_caser": ([caser(), FGSMAdversarial(sU, sI, 16, base=caser())], adam(0.01), *s,
                       [1, 1], ADAM_TOL),
    }


def call(run):
    models, opt, data, batch, epochs, _ = run
    return ("train", (models, opt, data, epochs, None, SEED, batch, True))


@pytest.fixture(scope="module")
def inputs():
    """The runs and each one's single-device result."""
    pair = Interactions(**dataclasses.asdict(synthetic_data(seed=41)))
    seq = Interactions(**dataclasses.asdict(seq_data(seed=5)))
    x = runs(pair, seq)
    one = {}
    for name, run in x.items():
        fn, args = call(run)
        one[name] = getattr(rank_cases, fn)(None, "cpu", *args)
    return x, one


NAMES = tuple(runs(Interactions(**dataclasses.asdict(synthetic_data(seed=41))),
                   Interactions(**dataclasses.asdict(seq_data(seed=5)))))


@pytest.fixture(scope="module", params=SPECS)
def ranks(request, inputs):
    """(spec, each rank's results by run name): one launch a mesh."""
    spec = request.param
    dp, m = parse_spec(spec)
    got = launch.run(f"{CASES}:several", dp * m, spec, "cpu",
                     [call(run) for run in inputs[0].values()], device="cpu", timeout=TIMEOUT)
    return spec, [dict(zip(inputs[0], r)) for r in got]


@pytest.mark.parametrize("name", NAMES)
def test_every_model_under_a_mesh_tracks_one_device(ranks, inputs, name):
    spec, res = ranks
    runs_, one = inputs
    want = one[name]
    rtol, atol = runs_[name][-1]
    batch = runs_[name][3]
    for r, x in enumerate(res):
        got = x[name]
        assert set(got["state"]) == set(want["state"]), (spec, name)
        for k, w in want["state"].items():
            np.testing.assert_allclose(got["state"][k], w, rtol=rtol, atol=atol,
                                       err_msg=f"{spec} rank {r} {name} {k}")
        assert len(got["stats"]) == len(want["stats"])
        for s, w in zip(got["stats"], want["stats"]):
            assert set(s) == set(w), (spec, name)
            for k in w:
                tol = 1.0 / batch + 1e-6 if k.startswith("acc") else 1e-5 * abs(w[k]) + 1e-7
                assert abs(s[k] - w[k]) <= tol, (spec, name, k, s[k], w[k])
    for x in res[1:]:  # every rank applied the same updates
        for k, w in res[0][name]["state"].items():
            np.testing.assert_array_equal(x[name]["state"][k], w, err_msg=f"{spec} {name} {k}")
