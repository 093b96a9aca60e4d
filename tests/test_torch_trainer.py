"""The port's sequence trainer (on the CPU) against the JAX package's:
one training step against JAX's step composed from the same split keys,
and the trainer's behaviour (modelled on ``tests/test_sasrec.py`` and
``tests/test_trainer.py``): NDCG rises, the NaN abort, ``switch_model``,
``fit_two_phase``, snapshots and the pretrain handoff.

Step tolerance: the Adam moments as gradients are compared (rtol 1e-4,
atol 1e-5 times the largest entry); the new params to atol 1e-6, except
the key biases: their gradient is analytically zero (softmax ignores a
per-row constant), so both sides hold rounding noise of ~1e-12 there, which
Adam's first step divides by |noise| + eps; for them the test asserts only
what Adam's first step guarantees, that neither side moved them by as much
as the learning rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.sampling.negatives import sample_seq_window_batch as jax_sample_window
from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
from acf_tpu.train.checkpoint import save_params as jax_save_params
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.sampling import seq_window_from_draws
from acf_tpu_torch.train import TrainConfig, Trainer, adam, fit_two_phase
from acf_tpu_torch.train.checkpoint import _flatten_with_names, save_params
from acf_tpu_torch.train.trainer import make_seq_epoch_fn, seq_train_step
from acf_tpu_torch.utils.io import OutputWriter
from tests.test_sasrec import seq_data

CPU = "cpu"
LR = 1e-3


def port_data(seed=0):
    import dataclasses

    return Interactions(**dataclasses.asdict(seq_data(seed=seed)))


def sasrec(data, **kw):
    return SASRec(data.num_users, data.num_items, 16, maxlen=8, dropout_rate=0.2, **kw)


def config(**kw):
    return TrainConfig(batch_size=16, verbose=10 ** 9, device=CPU, **kw)


@pytest.mark.parametrize("adversarial", [False, True])
def test_one_step_matches_the_jax_step(adversarial):
    """make_seq_epoch_fn's step: ks, kl = split(step key); the batch from
    ks, loss_window's gradient with the masks of kl, optax.adam's update."""
    data = seq_data()
    jm = JaxSASRec(data.num_users, data.num_items, 16, maxlen=8, dropout_rate=0.2,
                   fused="never", adversarial=adversarial)
    tm = sasrec(data, adversarial=adversarial)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    jopt, topt = optax.adam(LR, b2=0.98), adam(LR, b2=0.98)
    eligible = np.nonzero(data.hist_len >= 2)[0].astype(np.int32)
    ks, kl = jax.random.split(jax.random.PRNGKey(9))
    batch = jax_sample_window(ks, jnp.asarray(data.hist), jnp.asarray(eligible), 8,
                              data.num_items, 16)
    (jl, jaux), jg = jax.value_and_grad(jm.loss_window, has_aux=True)(jp, batch, kl)
    js = jopt.init(jp)
    upd, js = jopt.update(jg, js, jp)
    jp = optax.apply_updates(jp, upd)

    k_u, k_n = jax.random.split(ks)
    idx = np.asarray(jax.random.randint(k_u, (16,), 0, len(eligible)))
    cand = np.asarray(jax.random.randint(k_n, (8, 16, 8), 1, data.num_items, dtype=jnp.int32))
    tb = seq_window_from_draws(torch.from_numpy(data.hist), torch.from_numpy(eligible),
                               torch.from_numpy(idx), torch.from_numpy(cand), 8)
    for a, b in zip(tb, batch):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    masks = params_from_numpy(jax.tree.map(np.asarray, jm._dropout_masks(
        jax.random.split(kl)[0], 16, 8)), device=CPU)
    tp2, ts, aux = seq_train_step(tm, topt, tp, topt.init(tp), tb, masks=masks)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    mu = jax_named(js[0].mu)
    scale = max(float(np.abs(v).max()) for v in mu.values())
    got_mu = dict(_flatten_with_names(ts["mu"]))
    new = dict(_flatten_with_names(tp2))
    old = dict(_flatten_with_names(tp))
    for name, ref in jax_named(jp).items():
        np.testing.assert_allclose(got_mu[name].numpy(), mu[name], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
        if name.endswith("wk/b"):
            assert np.abs(ref - old[name].numpy()).max() < LR
            assert np.abs(new[name].numpy() - old[name].numpy()).max() < LR
        else:
            np.testing.assert_allclose(new[name].numpy(), ref, rtol=0, atol=1e-6, err_msg=name)
    assert int(ts["count"]) == 1


def test_training_improves_ranking():
    """As tests/test_sasrec.py::test_sasrec_training_improves: the sequences
    are strongly next-item predictable, so NDCG@10 rises by more than 0.1."""
    data = port_data()
    tr = Trainer(sasrec(data), data, adam(1e-2, b2=0.98), config())
    before = tr.evaluate().at_k(10)
    for _ in range(30):
        stats = tr.run_epoch()
    after = tr.evaluate().at_k(10)
    assert after[1] > before[1] + 0.1, (before, after)
    assert set(stats) == {"acc", "loss"} and stats["acc"] > 0.6


def test_fit_tracks_the_best_epoch_and_writes_the_reference_lines(tmp_path):
    data = port_data(seed=1)
    tr = Trainer(sasrec(data), data, adam(1e-2, b2=0.98),
                 TrainConfig(batch_size=16, epochs=12, verbose=4, device=CPU,
                             save_model_path=str(tmp_path / "m")),
                 writer=OutputWriter(str(tmp_path), "run"))
    initial = tr.evaluate().at_k(10)[1]
    best = tr.fit(tag="")
    assert best["epoch"] in (0, 4, 8) and best["ndcg"] > initial + 0.05
    lines = (tmp_path / "run.out").read_text().splitlines()
    epochs = [ln for ln in lines if ln.startswith("Epoch ") and "HR =" in ln]
    assert [ln.split()[1] for ln in epochs] == ["0", "4", "8"]
    assert "ACC_adv" in epochs[0] and "|Q|=" in epochs[0]
    assert f"Epoch {best['epoch']} is the best epoch" in lines
    assert sum(ln.startswith("K = ") for ln in lines) == 100
    assert len((tmp_path / "run.hr").read_text().splitlines()) == len(tr.evaluator.users)
    assert (tmp_path / "m.best.npz").exists() and (tmp_path / "m.last.npz").exists()


def test_sampled_evaluation_matches_the_jax_trainer(tmp_path):
    """``eval_sampled=True`` (reference ``--eval_mode sample``): with the
    same params and the same sampled negatives, ``Trainer.evaluate`` ranks
    each held-out item exactly as the JAX trainer does (integer positions,
    so HR, NDCG and AUC are equal); ``fit`` dumps the @topk column and
    writes the K = 1..10 sweep."""
    import dataclasses

    from acf_tpu.train.trainer import TrainConfig as JaxConfig
    from acf_tpu.train.trainer import Trainer as JaxTrainer

    jdata = seq_data(seed=9)
    rng = np.random.default_rng(9)  # 20 distinct negatives other than the held-out item
    negs = np.stack([rng.choice(np.setdiff1d(np.arange(1, jdata.num_items), [gt]), 20,
                                replace=False) for gt in jdata.test_item])
    jdata = dataclasses.replace(jdata, test_negatives=negs.astype(np.int32))
    data = Interactions(**dataclasses.asdict(jdata))
    jm = JaxSASRec(data.num_users, data.num_items, 16, maxlen=8, dropout_rate=0.2,
                   fused="never")
    jt = JaxTrainer(jm, jdata, optax.adam(LR, b2=0.98),
                    JaxConfig(batch_size=16, verbose=1, eval_sampled=True))
    tr = Trainer(sasrec(data), data, adam(LR, b2=0.98), config(eval_sampled=True),
                 writer=OutputWriter(str(tmp_path), "s", quiet=True))
    tr.params = params_from_numpy(jax.tree.map(np.asarray, jt.params), device=CPU)
    want, got = jt.evaluate(), tr.evaluate()
    for name in ("hr", "ndcg", "auc"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.hr.shape[0] == len(tr.evaluator.users) and 0 < got.at_k(10)[0] < 1
    best = tr.fit(epochs=1)
    lines = (tmp_path / "s.out").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines if ln.startswith("K = ")] == [
        f"K = {k}" for k in range(1, 11)]
    dumped = np.loadtxt(tmp_path / "s.hr")
    np.testing.assert_array_equal(dumped, best["result"].hr[:, 9])


def test_nan_abort(tmp_path):
    data = port_data(seed=2)
    tr = Trainer(sasrec(data), data, adam(1e-3), config(epochs=5),
                 writer=OutputWriter(str(tmp_path), "nan", quiet=True))
    tr.params["item_emb"] = tr.params["item_emb"] * float("nan")
    best = tr.fit(epochs=3)
    assert best["epoch"] == -1 and best["result"] is None
    assert (tmp_path / "nan.out").read_text().splitlines() == ["Epoch 0: NaN loss, aborting"]


def test_switch_model_resets_best_and_carries_or_resets_adam():
    data = port_data(seed=3)
    clean, adv = sasrec(data), sasrec(data, adversarial=True)
    opt = adam(1e-2, b2=0.98)
    tr = Trainer(clean, data, opt, config())
    for _ in range(2):
        tr.run_epoch()
    assert int(tr.opt_state["count"]) == 2 * tr.num_batches
    tr.best = {"ndcg": 0.9, "epoch": 3, "result": object()}
    ev = tr.evaluator
    carried = {n: x.clone() for n, x in _flatten_with_names(tr.opt_state)}
    tr.switch_model(adv, reset_opt=False)
    assert tr.best["ndcg"] == -1.0 and tr.best["result"] is None
    assert tr.evaluator is ev and tr.model is adv
    for n, x in _flatten_with_names(tr.opt_state):
        torch.testing.assert_close(x, carried[n], rtol=0, atol=0)
    stats = tr.run_epoch()
    assert {"loss_adv", "acc_adv"} <= set(stats)
    tr.switch_model(adv)  # reset (the default)
    assert int(tr.opt_state["count"]) == 0
    assert not any(bool(x.any()) for _, x in _flatten_with_names(tr.opt_state["mu"]))
    # a pair model is taken too (the pair trainer's epoch): APR trains on
    # tables of its own, since switch_model keeps the params
    apr = MFBPR(data.num_users, data.num_items, 8, adversarial=True)
    tr.switch_model(apr)
    tr.params = apr.init_params(torch.Generator().manual_seed(0), device=CPU)
    tr.opt_state = tr.optimizer.init(tr.params)
    stats = tr.run_epoch()
    assert {"loss_adv", "acc_adv"} <= set(stats) and np.isfinite(stats["loss_adv"])


def test_fit_two_phase_runs_clean_then_asasrec(tmp_path):
    """The ASASRec protocol: clean epochs, then asasrec with the Adam slots
    carried, an evaluation after each epoch, snapshots at the handoff and
    the end."""
    data = port_data(seed=4)
    cfg = TrainConfig(batch_size=16, epochs=4, verbose=1, device=CPU,
                      ckpt_path=str(tmp_path / "ck"))
    best = fit_two_phase(sasrec(data), sasrec(data, adversarial=True), data,
                         adam(1e-2, b2=0.98), cfg, adv_epoch=2,
                         writer=OutputWriter(str(tmp_path), "two", quiet=True), reset_opt=False)
    lines = (tmp_path / "two.out").read_text().splitlines()
    epochs = [ln for ln in lines if ln.startswith("Epoch ") and "HR =" in ln]
    assert [ln.split()[1] for ln in epochs] == ["0", "1", "2", "3"]

    def accs(line):
        part = line.split("ACC = ")[1]
        return float(part.split()[0]), float(part.split("ACC_adv = ")[1].split()[0])

    assert all(a == b for a, b in map(accs, epochs[:2]))     # clean: no adversarial term
    assert all(a != b for a, b in map(accs, epochs[2:]))     # asasrec: its own accuracy
    assert best["epoch"] in (2, 3)  # best tracking restarted at the switch
    assert (tmp_path / "ck-pretrain.npz").exists() and (tmp_path / "ck-final.npz").exists()


def test_snapshot_resumes_exactly_and_reads_jax_snapshots(tmp_path):
    data = port_data(seed=5)
    model = sasrec(data)
    tr = Trainer(model, data, adam(1e-2, b2=0.98), config())
    tr.run_epoch()
    tr.save_checkpoint(str(tmp_path / "s"))
    tr.run_epoch()
    again = Trainer(model, data, adam(1e-2, b2=0.98), config(seed=7))
    again.restore_checkpoint(str(tmp_path / "s"))
    again.run_epoch()
    for (n, a), (_, b) in zip(_flatten_with_names(tr.params), _flatten_with_names(again.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    with np.load(tmp_path / "s.npz") as f:
        names = set(f.files)
    assert {"params/item_emb", "params/blocks/1/ln3/beta", "opt/0/.count", "opt/0/.mu/pos_emb",
            "opt/0/.nu/blocks/0/wq/w", "rng"} <= names

    # a JAX package snapshot (params, optax.adam state, key) restores into the port
    jm = JaxSASRec(data.num_users, data.num_items, 16, maxlen=8)
    jp = jm.init_params(jax.random.PRNGKey(2))
    js = optax.adam(1e-3).init(jp)
    js = (js[0]._replace(count=jnp.asarray(3, jnp.int32)), js[1])
    jax_save_params(str(tmp_path / "j"), {"params": jp, "opt": js, "key": jax.random.PRNGKey(0)})
    state_before = again.generator.get_state()
    again.restore_checkpoint(str(tmp_path / "j"))
    assert int(again.opt_state["count"]) == 3
    np.testing.assert_array_equal(again.params["blocks"][0]["wq"]["w"].numpy(),
                                  np.asarray(jp["blocks"][0]["wq"]["w"]))
    torch.testing.assert_close(again.generator.get_state(), state_before, rtol=0, atol=0)


def test_load_pretrain_copies_matching_leaves(tmp_path):
    data = port_data(seed=6)
    src = Trainer(sasrec(data), data, adam(1e-3), config(seed=1))
    save_params(str(tmp_path / "p"), {k: v for k, v in src.params.items() if k != "ln_f"})
    dst = Trainer(sasrec(data), data, adam(1e-3), config(seed=2))
    ln_f = dst.params["ln_f"]["gamma"].clone()
    loaded = dst.load_pretrain(str(tmp_path / "p"))
    assert "item_emb" in loaded and "blocks/1/conv2/w" in loaded and "ln_f/gamma" not in loaded
    torch.testing.assert_close(dst.params["item_emb"], src.params["item_emb"], rtol=0, atol=0)
    torch.testing.assert_close(dst.params["ln_f"]["gamma"], ln_f, rtol=0, atol=0)
    src.save_checkpoint(str(tmp_path / "full"))  # full snapshots' params/ names count too
    assert len(dst.load_pretrain(str(tmp_path / "full"))) == len(_flatten_with_names(dst.params))


def test_epoch_fn_runs_num_batches_steps_and_run_epochs_stacks():
    data = port_data(seed=7)
    tr = Trainer(sasrec(data), data, adam(1e-3), config())
    assert tr.num_batches == int((data.hist_len >= 1).sum()) // 16
    epoch = make_seq_epoch_fn(tr.model, tr.optimizer, 16, 3)
    _, state, stats = epoch(tr.params, tr.opt_state, tr.dev, tr.generator)
    assert int(state["count"]) == 3 and set(stats) == {"loss", "acc"}
    stacked = tr.run_epochs(2)
    assert stacked["loss"].shape == (2,) and np.isfinite(stacked["loss"]).all()


def test_pair_models_are_not_trained_yet():
    """The name predates APR's port. The pair trainer now trains every pair
    model of the port: MF-BPR's clean loss, APR (``adversarial=True``, its
    closed form), DNS (``dns > 1``) and ``PointwiseMF``
    (``tests/test_torch_apr.py`` holds them against the JAX package)."""
    data = port_data()
    tr = Trainer(MFBPR(data.num_users, data.num_items, 8), data, adam(1e-3), config())
    assert set(tr.run_epoch()) == {"acc", "loss"}
    apr = MFBPR(data.num_users, data.num_items, 8, adversarial=True)
    assert set(Trainer(apr, data, adam(1e-3), config()).run_epoch()) == {
        "acc", "loss", "acc_adv", "loss_adv"}
    for model in (MFBPR(data.num_users, data.num_items, 8, dns=3),
                  PointwiseMF(data.num_users, data.num_items, 8)):
        stats = Trainer(model, data, adam(1e-3), config()).run_epoch()
        assert set(stats) == {"acc", "loss"} and np.isfinite(stats["loss"])


def test_profile_epoch_writes_a_trace(tmp_path):
    """``Trainer.profile_epoch`` (``acf_tpu/train/trainer.py:323-331``): one
    epoch and one evaluation under torch.profiler, a Chrome trace in the
    directory holding the epoch's ops; the stats and the evaluation as
    ``run_epoch`` and ``evaluate`` give them."""
    import json

    data = port_data(seed=3)
    tr = Trainer(MFBPR(data.num_users, data.num_items, 8), data, adam(1e-3), config())
    stats, res = tr.profile_epoch(str(tmp_path / "trace"))
    assert set(stats) == {"loss", "acc"} and np.isfinite(stats["loss"])
    assert res.hr.shape == (len(data.eval_users()), 100)
    trace = tmp_path / "trace" / "acf_tpu_torch.pt.trace.json"
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"aten::index_add_", "aten::mm"} & names, sorted(names)[:20]


def test_fit_two_phase_resumes_and_takes_a_pretrain(tmp_path):
    """``restore=(path, epoch)`` resumes in the phase ``epoch`` falls in from
    the snapshot written after epoch - 1, so a run cut there ends with the
    params of the run that was not cut (in phase 1 and in phase 2);
    ``pretrain`` loads matching leaves first."""
    data = port_data(seed=8)
    opt = adam(1e-2, b2=0.98)

    def run(**kw):
        cfg = TrainConfig(batch_size=16, epochs=3, verbose=1, device=CPU, ckpt_every=1,
                          ckpt_path=str(tmp_path / kw.pop("name")))
        fit_two_phase(sasrec(data), sasrec(data, adversarial=True), data, opt, cfg,
                      adv_epoch=2, writer=OutputWriter(None, None, quiet=True),
                      reset_opt=False, **kw)
        with np.load(cfg.ckpt_path + "-final.npz") as f:
            return {k: f[k] for k in f.files}

    full = run(name="a")
    for name, restore in (("b", ("a-0", 1)), ("c", ("a-1", 2))):  # phase 1, phase 2
        resumed = run(name=name, restore=(str(tmp_path / restore[0]), restore[1]))
        for k, v in full.items():
            np.testing.assert_array_equal(resumed[k], v, err_msg=f"{name} {k}")
    with np.load(tmp_path / "a-pretrain.npz") as f:
        assert "item_emb" in f.files
    warm = run(name="d", pretrain=str(tmp_path / "a-final"))
    assert not np.array_equal(warm["item_emb"], full["item_emb"])  # trained further from it
