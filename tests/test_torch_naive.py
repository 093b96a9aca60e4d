"""The port's naive baselines (``acf_tpu_torch/models/naive.py``) on the CPU
against the JAX package's (``acf_tpu/models/naive.py``, modelled on
``tests/test_gan_models.py::test_naive_baselines``): ``score_all`` and
``score_some``, and the evaluation's rank positions and metrics through the
trainer, all equal exactly (the scores are small integers, exact in
float32, so ties fall alike)."""

import jax
import numpy as np
import pytest
import torch

from acf_tpu.eval.full_rank import FullRankEvaluator as JaxEvaluator
from acf_tpu.models import naive as jax_naive
from acf_tpu_torch.eval import FullRankEvaluator
from acf_tpu_torch.models import naive
from acf_tpu_torch.train import Trainer, adam
from tests.test_torch_apl import config, port_data
from tests.test_trainer import synthetic_data

CPU = "cpu"
NAMES = ("MostPopular", "MostRecentlyVisit", "MostFrequentlyVisit", "AlreadyVisit")


def models(name, seed=14, item_count=True):
    jd = synthetic_data(seed=seed)
    if not item_count:
        jd.item_count = None
    td = port_data(jd)
    jm = getattr(jax_naive, name)(jd.num_users, jd.num_items, 8, data=jd)
    tm = getattr(naive, name)(td.num_users, td.num_items, 8, data=td)
    return jd, td, jm, tm


@pytest.mark.parametrize("name", NAMES)
def test_scores_equal_jax(name):
    """Every user's full-catalog and sampled scores (a user with no history
    included: the last row of the draw is user 0, the pad)."""
    jd, td, jm, tm = models(name)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0), device=CPU)
    users = np.arange(jd.num_users, dtype=np.int32)
    hists = jd.hist[users]
    items = np.random.default_rng(0).integers(0, jd.num_items, (len(users), 7)).astype(np.int32)
    items[:, 0] = hists[:, -1]  # the last visit, scored 1 by MostRecentlyVisit
    got = tm.score_all(tp, torch.from_numpy(users), torch.from_numpy(hists))
    want = np.asarray(jm.score_all(jp, users, hists))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and got.shape == (jd.num_users, jd.num_items)
    got = tm.score_some(tp, torch.from_numpy(users), torch.from_numpy(hists),
                        torch.from_numpy(items))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.score_some(jp, users, hists, items)))
    assert float(got.max()) >= 1.0


@pytest.mark.parametrize("name", NAMES)
def test_trainer_epoch_and_evaluation_equal_jax(name):
    """The no-op epoch, then the dense evaluation through the trainer:
    positions, HR, NDCG and AUC equal to the JAX evaluator's."""
    jd, td, jm, tm = models(name)
    tr = Trainer(tm, td, adam(1e-3), config())
    before = {k: v.clone() for k, v in tr.params.items()}
    stats = tr.run_epoch()
    assert stats == {"loss": 0.0, "acc": 0.0} and tr.opt_state == ()
    assert all(torch.equal(tr.params[k], v) for k, v in before.items())
    assert tm.factored_scorer() is None
    jp = jm.init_params(jax.random.PRNGKey(0))
    ev, jev = FullRankEvaluator(td, device=CPU), JaxEvaluator(jd)
    np.testing.assert_array_equal(ev.positions(tm.score_all, tr.params),
                                  jev.positions(jm.score_all, jp))
    got, want = tr.evaluate(), jev.evaluate_model(jm, jp)
    for field in ("hr", "ndcg", "auc"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    hr, _, _ = got.at_k(10)
    assert 0.0 <= hr <= 1.0


def test_most_popular_counts_every_visit():
    """``MostPopular`` scores the raw interaction counts with duplicate
    visits (``Interactions.item_count``), and a bincount of the unique
    pairs when the dataset carries none, as the JAX package does."""
    for item_count in (True, False):
        jd, td, jm, tm = models("MostPopular", item_count=item_count)
        tp = tm.init_params(torch.Generator(), device=CPU)
        np.testing.assert_array_equal(tp["counts"].numpy(),
                                      np.asarray(jm.init_params(jax.random.PRNGKey(0))["counts"]))
        want = jd.item_count if item_count else np.bincount(jd.pairs_i, minlength=jd.num_items)
        np.testing.assert_array_equal(tp["counts"].numpy(), want)
    jd, td, _, tm = models("MostPopular")
    assert (jd.item_count != np.bincount(jd.pairs_i, minlength=jd.num_items)).any()
    loss, aux = tm.loss(tp, (torch.tensor([1]), torch.tensor([2]), torch.tensor([3])))
    assert float(loss) == 0.0 and set(aux) == {"loss", "acc"}
