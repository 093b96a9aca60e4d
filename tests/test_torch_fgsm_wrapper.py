"""The generic FGSM wrapper (``acf_tpu_torch/adversarial/fgsm.py``) on the
CPU against the JAX package's (``acf_tpu/adversarial/fgsm.py``; modelled on
``tests/test_fgsm_wrapper.py``): the same numpy params and batches through
both wrappers around MF-BPR, pointwise MF and SASRec, against the port's
built-in APR, and one wrapper step of the sequence epoch against JAX's step
composed from the same draws.

Tolerances:

* MF losses, aux and gradients: rtol 1e-5, atol 1e-7 (``TOL``), as
  ``tests/test_torch_apr.py``: the same f32 operations, sums in another
  order. The FGSM deltas: atol 1e-6 on rows of norm ε.
* SASRec: the loss and aux to rtol 1e-5; every gradient leaf to rtol 1e-4
  and atol 1e-5 of the tree's largest entry (``SEQ_GRAD``), the step
  tolerance of ``tests/test_torch_trainer.py``: the encoder's 8-wide sums,
  softmax and LayerNorm moments round in another order, and the key biases'
  gradient is analytically zero, so both sides hold rounding noise there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acf_tpu.adversarial import FGSMAdversarial as JaxFGSM
from acf_tpu.models.mf import MFBPR as JaxMFBPR
from acf_tpu.models.mf import PointwiseMF as JaxPointwiseMF
from acf_tpu.models.sasrec import SASRec as JaxSASRec
from acf_tpu.sampling.negatives import sample_seq_window_batch as jax_sample_window
from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
from acf_tpu_torch.adversarial import FGSMAdversarial
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.models.apl import APL
from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
from acf_tpu_torch.models.sasrec import SASRec
from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder
from acf_tpu_torch.sampling import sample_seq_window_batch, seq_window_from_draws
from acf_tpu_torch.train import Trainer, adam, adagrad
from acf_tpu_torch.train.checkpoint import _flatten_with_names
from acf_tpu_torch.train.trainer import seq_train_step, window_loss
from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from tests.test_sasrec import seq_data
from tests.test_torch_apr import TOL
from tests.test_torch_pair_trainer import config as pair_config
from tests.test_torch_pair_trainer import port_data as pair_data
from tests.test_torch_trainer import config as seq_config
from tests.test_torch_trainer import port_data as seq_port_data
from tests.test_trainer import synthetic_data

CPU = "cpu"
DELTA_ATOL = 1e-6
SEQ_GRAD = dict(rtol=1e-4, atol=1e-5)
MAXLEN = 5


def mf_batch(num_users, num_items, seed=0, b=16):
    """(users, pos, neg) with a duplicate user and one row's positive as
    another row's negative. No row's negative is its own positive, as the
    pair sampler guarantees (a positive is a train item, which it rejects):
    at such a row the pointwise gradient is the cancellation (σ(l) - 1) + σ(l)
    of two terms near 0.5, and its FGSM direction is f32 rounding in both
    packages."""
    rng = np.random.default_rng(seed)
    u = rng.integers(1, num_users, b, dtype=np.int32)
    i = rng.integers(1, num_items, b, dtype=np.int32)
    j = rng.integers(1, num_items, b, dtype=np.int32)
    j = np.where(j == i, i % (num_items - 1) + 1, j).astype(np.int32)
    u[5] = u[0]
    j[3] = i[2]
    assert (i != j).all()
    return (u, i, j)


def seq_batch(data, seed=0, b=16):
    """(users, seq, pos, neg) from the JAX sampler's window batch."""
    eligible = np.nonzero(data.hist_len >= 2)[0].astype(np.int32)
    users, window, neg = jax_sample_window(jax.random.PRNGKey(seed), jnp.asarray(data.hist),
                                           jnp.asarray(eligible), MAXLEN, data.num_items, b)
    window = np.asarray(window)
    return (np.asarray(users), window[:, :-1], window[:, 1:], np.asarray(neg))


def port_value_and_grads(model, params, batch, **kw):
    prm = tree_map(lambda x: x.clone().requires_grad_(True), params)
    loss, aux = model.loss(prm, batch, **kw)
    grads = torch.autograd.grad(loss, tree_leaves(prm), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(tree_leaves(prm), grads)]
    return (float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()},
            tree_unflatten(params, grads))


def wrappers(kind, adv_steps=1):
    """(JAX wrapper, port wrapper, JAX params, port params, JAX batch,
    port batch) around ``kind``."""
    if kind == "sasrec":
        data = seq_data(seed=3)
        kw = dict(maxlen=MAXLEN, num_blocks=1, dropout_rate=0.0)
        jbase = JaxSASRec(data.num_users, data.num_items, 8, fused="never", **kw)
        tbase = SASRec(data.num_users, data.num_items, 8, **kw)
        batch = seq_batch(data)
    else:
        data = synthetic_data(seed=21)
        jcls, tcls = {"mfbpr": (JaxMFBPR, MFBPR), "pointwise": (JaxPointwiseMF, PointwiseMF)}[kind]
        jbase, tbase = jcls(data.num_users, data.num_items, 8), tcls(data.num_users,
                                                                     data.num_items, 8)
        batch = mf_batch(data.num_users, data.num_items)
    U, I = data.num_users, data.num_items
    jw = JaxFGSM(U, I, 8, base=jbase, eps=0.5, reg_adv=1.0, adv_steps=adv_steps)
    tw = FGSMAdversarial(U, I, 8, base=tbase, eps=0.5, reg_adv=1.0, adv_steps=adv_steps)
    jp = jw.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return (jw, tw, jp, tp, tuple(map(jnp.asarray, batch)),
            tuple(torch.from_numpy(np.array(x)) for x in batch))


@pytest.mark.parametrize("adv_steps", [1, 2])
@pytest.mark.parametrize("kind", ["mfbpr", "pointwise", "sasrec"])
def test_wrapper_matches_the_jax_wrapper(kind, adv_steps):
    """The loss, every aux value, the deltas and every gradient leaf."""
    jw, tw, jp, tp, jb, tb = wrappers(kind, adv_steps)
    (jl, jaux), jg = jax.value_and_grad(jw.loss, has_aux=True)(jp, jb, jax.random.PRNGKey(1))
    tl, taux, tg = port_value_and_grads(tw, tp, tb)
    assert set(taux) == set(jaux) and {"loss_adv", "acc_adv"} <= set(taux)
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(taux[k], float(jaux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    jd, td = jw.deltas(jp, jb, jax.random.PRNGKey(1)), tw.deltas(tp, tb)
    assert set(td) == set(jd) == set(tw._leaf_names(tp))
    for k in jd:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=0, atol=DELTA_ATOL,
                                   err_msg=k)
    want = jax_named(jg)
    scale = max(float(np.abs(v).max()) for v in want.values())
    got = dict(_flatten_with_names(tg))
    assert set(got) == set(want)
    for name, ref in want.items():
        if kind == "sasrec":
            np.testing.assert_allclose(got[name].numpy(), ref, rtol=SEQ_GRAD["rtol"],
                                       atol=SEQ_GRAD["atol"] * scale, err_msg=name)
        else:
            np.testing.assert_allclose(got[name].numpy(), ref, **TOL, err_msg=name)


def test_matches_apr_on_mfbpr():
    """Wrapping clean MF-BPR gives the built-in APR's objective and
    gradients at reg = 0 (``tests/test_fgsm_wrapper.py:28``)."""
    data = synthetic_data(seed=21)
    U, I = data.num_users, data.num_items
    apr = MFBPR(U, I, 8, adversarial=True, eps=0.5, reg_adv=1.0)
    wrap = FGSMAdversarial(U, I, 8, base=MFBPR(U, I, 8), eps=0.5, reg_adv=1.0)
    params = apr.init_params(torch.Generator().manual_seed(0), device=CPU)
    batch = tuple(map(torch.from_numpy, mf_batch(U, I, seed=1)))
    la, aux_a, ga = port_value_and_grads(apr, params, batch)
    lw, aux_w, gw = port_value_and_grads(wrap, params, batch)
    np.testing.assert_allclose(lw, la, rtol=1e-6)
    for k in aux_a:
        np.testing.assert_allclose(aux_w[k], aux_a[k], rtol=1e-6, err_msg=k)
    manual, _ = apr.manual_grads(params, batch)
    for k in ("P", "Q"):
        np.testing.assert_allclose(gw[k].numpy(), ga[k].numpy(), **TOL, err_msg=k)
        np.testing.assert_allclose(gw[k].numpy(), manual[k].numpy(), **TOL, err_msg=k)


def test_linearizes_on_unregularized_loss():
    """With reg != 0 the wrapper's deltas equal the built-in APR's: both
    linearize on the raw BPR loss (``tests/test_fgsm_wrapper.py:46``), and
    both equal the JAX wrapper's."""
    data = synthetic_data(seed=23)
    U, I = data.num_users, data.num_items
    apr = MFBPR(U, I, 8, adversarial=True, eps=0.5, reg=0.05)
    wrap = FGSMAdversarial(U, I, 8, base=MFBPR(U, I, 8, reg=0.05), eps=0.5)
    jw = JaxFGSM(U, I, 8, base=JaxMFBPR(U, I, 8, reg=0.05), eps=0.5)
    jp = jw.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    u, i, j = mf_batch(U, I, seed=2)
    dP, dQ = apr.fgsm_deltas(params, *map(torch.from_numpy, (u, i, j)))
    dw = wrap.deltas(params, tuple(map(torch.from_numpy, (u, i, j))))
    jd = jw.deltas(jp, tuple(map(jnp.asarray, (u, i, j))), jax.random.PRNGKey(1))
    np.testing.assert_allclose(dP.numpy(), dw["P"].numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(dQ.numpy(), dw["Q"].numpy(), rtol=0, atol=1e-7)
    for k in ("P", "Q"):
        np.testing.assert_allclose(dw[k].numpy(), np.asarray(jd[k]), rtol=0, atol=DELTA_ATOL)


def test_leaf_autodetect():
    """Top-level 2-D leaves with a user- or item-count leading dimension: the
    item table of the port's SASRec (not ``pos_emb`` or a block's weights),
    both MF tables; none found raises."""
    data = seq_data(seed=20)
    U, I = data.num_users, data.num_items
    w = FGSMAdversarial(U, I, 8, base=SASRec(U, I, 8, maxlen=MAXLEN))
    params = w.init_params(torch.Generator().manual_seed(0), device=CPU)
    assert w._leaf_names(params) == ("item_emb",)
    assert w.batch_kind == "seq" and w.maxlen == MAXLEN
    jw = JaxFGSM(U, I, 8, base=JaxSASRec(U, I, 8, maxlen=MAXLEN, fused="never"))
    assert jw._leaf_names(jw.init_params(jax.random.PRNGKey(0))) == ("item_emb",)
    mf = FGSMAdversarial(U, I, 8, base=MFBPR(U, I, 8, dns=3))
    mp = mf.init_params(torch.Generator().manual_seed(0), device=CPU)
    assert mf._leaf_names(mp) == ("P", "Q") and mf.batch_kind == "pair" and mf.dns == 3
    with pytest.raises(ValueError, match="no embedding-like"):
        mf._leaf_names({"w": torch.zeros(3, 3), "b": torch.zeros(U)})


def test_refuses_adversarial_and_apl_bases():
    """What is already adversarial, or brings its own epoch, is refused
    (``acf_tpu/cli/main.py:296-302``)."""
    U, I = 10, 12
    for base in (MFBPR(U, I, 4, adversarial=True), SASRec(U, I, 4, adversarial=True),
                 APL(U, I, 4), FGSMAdversarial(U, I, 4, base=MFBPR(U, I, 4))):
        with pytest.raises(ValueError, match="does not wrap"):
            FGSMAdversarial(U, I, 4, base=base)


def test_wrapper_step_of_the_sequence_epoch_matches_jax():
    """One step of the sequence epoch for ``FGSMAdversarial(SASRec)``
    (dropout 0.2): the port has no ``loss_window`` for it, so the step runs
    ``loss`` on the expanded batch, as the JAX epoch does; against JAX's step
    composed from the same split keys (``tests/test_torch_trainer.py``'s
    step test), the dropout masks of the clean and perturbed passes
    injected."""
    data = seq_data()
    kw = dict(maxlen=8, dropout_rate=0.2)
    jbase = JaxSASRec(data.num_users, data.num_items, 16, fused="never", **kw)
    jw = JaxFGSM(data.num_users, data.num_items, 16, base=jbase)
    tw = FGSMAdversarial(data.num_users, data.num_items, 16,
                         base=SASRec(data.num_users, data.num_items, 16, **kw))
    assert not hasattr(tw, "loss_window")
    jp = jw.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    eligible = np.nonzero(data.hist_len >= 2)[0].astype(np.int32)
    ks, kl = jax.random.split(jax.random.PRNGKey(9))
    batch = jax_sample_window(ks, jnp.asarray(data.hist), jnp.asarray(eligible), 8,
                              data.num_items, 16)

    def expanded(prm, b, k):
        return jw.loss(prm, (b[0], b[1][:, :-1], b[1][:, 1:], b[2]), k)

    (jl, jaux), jg = jax.value_and_grad(expanded, has_aux=True)(jp, batch, kl)
    jopt = optax.adam(1e-3, b2=0.98)
    js = jopt.init(jp)
    upd, js = jopt.update(jg, js, jp)
    jp2 = optax.apply_updates(jp, upd)

    k_u, k_n = jax.random.split(ks)
    idx = np.asarray(jax.random.randint(k_u, (16,), 0, len(eligible)))
    cand = np.asarray(jax.random.randint(k_n, (8, 16, 8), 1, data.num_items, dtype=jnp.int32))
    tb = seq_window_from_draws(torch.from_numpy(data.hist), torch.from_numpy(eligible),
                               torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(cand)), 8)

    def masks(key):  # SASRec.loss: k_enc, _ = split(key); the masks of k_enc
        return params_from_numpy(jax.tree.map(np.asarray, jbase._dropout_masks(
            jax.random.split(key)[0], 16, 8)), device=CPU)

    k_clean, k_adv = jax.random.split(kl)
    topt = adam(1e-3, b2=0.98)
    tp2, ts, aux = seq_train_step(tw, topt, tp, topt.init(tp), tb, masks=masks(k_clean),
                                  adv_masks=masks(k_adv))
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-5, err_msg=k)
    mu = jax_named(js[0].mu)
    scale = max(float(np.abs(v).max()) for v in mu.values())
    got_mu = dict(_flatten_with_names(ts["mu"]))
    new, old = dict(_flatten_with_names(tp2)), dict(_flatten_with_names(tp))
    for name, ref in jax_named(jp2).items():
        np.testing.assert_allclose(got_mu[name].numpy(), mu[name], rtol=SEQ_GRAD["rtol"],
                                   atol=SEQ_GRAD["atol"] * scale, err_msg=name)
        if name.endswith("wk/b"):  # zero gradient: Adam's first step moves it < lr
            assert np.abs(new[name].numpy() - old[name].numpy()).max() < 1e-3
        else:
            np.testing.assert_allclose(new[name].numpy(), ref, rtol=0, atol=1e-6, err_msg=name)


def test_wrapper_trains_through_the_trainer():
    """``Trainer`` takes the wrapper around a sequence model (the sequence
    epoch on the expanded batch, the evaluation on the base's scorer) and
    around a pair model (the pair epoch by autograd, DNS delegated); on the
    CPU no kernel launch is counted."""
    data = seq_port_data(seed=2)
    before = (fused_encoder.launches, encoder_bwd.launches)
    w = FGSMAdversarial(data.num_users, data.num_items, 16,
                        base=SASRec(data.num_users, data.num_items, 16, maxlen=8,
                                    dropout_rate=0.2), eps=0.5)
    tr = Trainer(w, data, adam(1e-3), seq_config())
    assert tr.num_batches == int((data.hist_len >= 1).sum()) // 16
    stats = tr.run_epoch()
    assert set(stats) == {"loss", "acc", "loss_adv", "acc_adv"}
    assert all(np.isfinite(v) for v in stats.values())
    assert np.isfinite(tr.evaluate().at_k(10)[1])
    assert (fused_encoder.launches, encoder_bwd.launches) == before == (0, 0)
    pdata = pair_data(4)
    for base in (MFBPR(pdata.num_users, pdata.num_items, 8, dns=2),
                 PointwiseMF(pdata.num_users, pdata.num_items, 8)):
        tr = Trainer(FGSMAdversarial(pdata.num_users, pdata.num_items, 8, base=base,
                                     adv_steps=2), pdata, adagrad(0.1), pair_config())
        stats = tr.run_epoch()
        assert {"loss_adv", "acc_adv"} <= set(stats) and np.isfinite(stats["loss_adv"])


def test_expanded_batch_fallback_matches_loss_window():
    """The wrapper has no ``loss_window``, so the sequence step takes its
    ``loss`` on the expanded batch; at ``reg_adv = 0`` that is the base's
    loss there, with the value and gradients of the base's
    ``loss_window``."""
    data = seq_port_data(seed=5)
    model = SASRec(data.num_users, data.num_items, 16, maxlen=8, dropout_rate=0.0)
    wrap = FGSMAdversarial(data.num_users, data.num_items, 16, base=model, reg_adv=0.0)
    params = model.init_params(torch.Generator().manual_seed(0), device=CPU)
    tr = Trainer(model, data, adam(1e-3), seq_config())
    batch = sample_seq_window_batch(torch.Generator().manual_seed(1), tr.dev["hist"],
                                    tr.dev["eligible"], 8, data.num_items, 16)
    assert window_loss(model) == model.loss_window
    expanded = window_loss(wrap)
    assert not hasattr(wrap, "loss_window")
    out = {}
    for name, fn in (("window", model.loss_window), ("expanded", expanded)):
        prm = tree_map(lambda x: x.clone().requires_grad_(True), params)
        loss, _ = fn(prm, batch)
        out[name] = [float(loss)] + list(torch.autograd.grad(loss, tree_leaves(prm)))
    np.testing.assert_allclose(out["expanded"][0], out["window"][0], rtol=1e-6)
    for a, b in zip(out["expanded"][1:], out["window"][1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
