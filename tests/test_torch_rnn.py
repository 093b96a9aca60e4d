"""The port's recurrent cells and dropout (``acf_tpu_torch/nn/rnn.py``,
``acf_tpu_torch/nn/layers.py::dropout``) on the CPU against the JAX
package's (``acf_tpu/nn/rnn.py``, ``acf_tpu/nn/layers.py``), and the
helpers the sequence-zoo tests share: params carried from the JAX
``init_params`` through numpy, the JAX sampler's window batches, the JAX
sequence epoch's draws, and gradient comparison on a tree's scale.

Tolerances: cell outputs and states to atol 1e-6 (f32 products of width
<= 32 summed in another order); loss values to rtol ``LOSS_RTOL`` (1e-5:
a loss is a mean over up to T·B² ≈ 2,000 f32 terms, summed in another
order, which rounds to ~sqrt(n) ulps); gradients to ``GRAD_TOL`` (1e-6) of
the largest entry of the JAX gradient tree, the scale of the summands the
leaves are made of (a bias leaf's gradient is a sum that cancels, so its
own size is no scale); under the FGSM wrapper to ``FGSM_TOL`` (1e-5) of
it, since the perturbed pass starts from the clean gradient's
row-normalized direction, which carries the clean pass's rounding there
scaled by ε over the row's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acf_tpu.nn import layers as jax_layers
from acf_tpu.nn import rnn as jax_rnn
from acf_tpu.sampling.negatives import sample_seq_window_batch as jax_sample_window
from acf_tpu.train.checkpoint import _flatten_with_names as jax_named
from acf_tpu_torch.compat.jax_params import params_from_numpy
from acf_tpu_torch.nn import layers, rnn
from acf_tpu_torch.sampling import seq_window_from_draws
from acf_tpu_torch.train.checkpoint import _flatten_with_names
from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

CPU = "cpu"
ATOL = 1e-6
GRAD_TOL = 1e-6
LOSS_RTOL = 1e-5
FGSM_TOL = 1e-5
ROUNDS = 8


# --- shared helpers -----------------------------------------------------------

def carry(jmodel, seed=0):
    """(JAX params, the port's params on the CPU from the same numpy)."""
    jp = jmodel.init_params(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def t(x):
    return torch.from_numpy(np.array(x))


def window_draws(key, data, maxlen, b):
    """The draws of JAX's ``sample_seq_window_batch(key, ...)``: user
    indices [B] and negative candidates [R, B, maxlen]."""
    eligible = np.nonzero(data.hist_len >= 2)[0].astype(np.int32)
    k_u, k_n = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_u, (b,), 0, len(eligible)))
    cand = np.asarray(jax.random.randint(k_n, (ROUNDS, b, maxlen), 1, data.num_items,
                                         dtype=jnp.int32))
    return eligible, idx, cand


def seq_batch(data, maxlen, b=16, seed=0):
    """(users, seq, pos, neg) numpy arrays of JAX's window sampler; checks
    that the port's sampler gives the same batch from the same draws."""
    key = jax.random.PRNGKey(seed)
    eligible, idx, cand = window_draws(key, data, maxlen, b)
    users, window, neg = (np.asarray(x) for x in jax_sample_window(
        key, jnp.asarray(data.hist), jnp.asarray(eligible), maxlen, data.num_items, b))
    ours = seq_window_from_draws(t(data.hist), t(eligible), t(idx), t(cand), maxlen)
    for a, r in zip(ours, (users, window, neg)):
        np.testing.assert_array_equal(a.numpy(), r)
    return users, window[:, :-1], window[:, 1:], neg


def jax_value_and_grad(jmodel, jp, batch, key=jax.random.PRNGKey(1)):
    (loss, aux), g = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jp, tuple(map(jnp.asarray, batch)), key)
    return float(loss), {k: float(v) for k, v in aux.items()}, g


def port_value_and_grad(model, params, batch, **kw):
    """(loss, aux floats, gradient tree) of ``model.loss`` at ``params``."""
    prm = tree_map(lambda x: x.clone().requires_grad_(True), params)
    loss, aux = model.loss(prm, tuple(t(x) for x in batch), **kw)
    leaves = tree_leaves(prm)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return (float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()},
            tree_unflatten(params, grads))


def assert_trees_close(got, want, tol=GRAD_TOL, what="gradient"):
    """Every leaf of the port's tree within ``tol`` of the JAX tree's
    largest entry; the same names on both sides."""
    want = {k: np.asarray(v) for k, v in jax_named(want).items()}
    got = dict(_flatten_with_names(got))
    assert set(got) == set(want), set(got) ^ set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert scale > 0
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), ref, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {name}")
    return scale


def assert_loss_and_grads(jmodel, jp, tmodel, tp, batch, key=jax.random.PRNGKey(1),
                          grad_tol=GRAD_TOL, **kw):
    jl, jaux, jg = jax_value_and_grad(jmodel, jp, batch, key)
    tl, taux, tg = port_value_and_grad(tmodel, tp, batch, **kw)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k], jaux[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert_trees_close(tg, jg, grad_tol)
    return tl


def assert_positions_match(jmodel, jp, tmodel, tp, jdata, batch_users=8):
    """Rank positions of every eval user through ``evaluate_model``: the
    factored path (JAX's Pallas kernel in interpret mode) or the dense one,
    as the model routes; equal, ±1 only at near ties
    (``tests/test_torch_sasrec.py``), the factored ones equal to the port's
    own dense positions. Returns the number of users that differ."""
    import dataclasses

    from acf_tpu.eval import FullRankEvaluator as JaxEvaluator
    from acf_tpu_torch.data import Interactions
    from acf_tpu_torch.eval import FullRankEvaluator
    from tests.test_torch_sasrec import assert_positions_agree

    tdata = Interactions(**dataclasses.asdict(jdata))
    jev = JaxEvaluator(jdata, batch_users=batch_users)
    tev = FullRankEvaluator(tdata, batch_users=batch_users, device=CPU)
    jfs, tfs = jmodel.factored_scorer(), tmodel.factored_scorer()
    assert (jfs is None) == (tfs is None)
    if tfs is None:
        ref = jev.positions(jmodel.score_all, jp)
        pos = tev.positions(tmodel.score_all, tp)
    else:
        ref = jev.positions_factored(jfs[0], jfs[1], jp, interpret=True)
        pos = tev.positions_factored(tfs[0], tfs[1], tp)
        np.testing.assert_array_equal(pos, tev.positions(tmodel.score_all, tp))
    res = tev.evaluate_model(tmodel, tp)
    assert res.hr.shape == (len(tev.users), 100) and np.isfinite(res.auc).all()
    return assert_positions_agree(pos, ref, tmodel, tp, tev)


def assert_scores_match(jmodel, jp, tmodel, tp, data, n=12, m=7, seed=0):
    """``score_all``, ``score_some`` and, where the model factors, its
    ``user_repr`` and table on the last ``n`` users' histories."""
    rng = np.random.default_rng(seed)
    users = np.arange(data.num_users - n, data.num_users, dtype=np.int32)
    hists = data.hist[users]
    items = rng.integers(0, data.num_items, (n, m)).astype(np.int32)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmodel.score_all(tp, t(users), t(hists)).numpy(),
                               np.asarray(jmodel.score_all(jp, users, hists)), **tol)
    np.testing.assert_allclose(tmodel.score_some(tp, t(users), t(hists), t(items)).numpy(),
                               np.asarray(jmodel.score_some(jp, users, hists, items)), **tol)
    jfs, tfs = jmodel.factored_scorer(), tmodel.factored_scorer()
    if tfs is not None:
        assert tfs is tmodel.factored_scorer()  # cached
        np.testing.assert_allclose(tfs[0](tp, t(users), t(hists)).numpy(),
                                   np.asarray(jfs[0](jp, users, hists)), **tol)
        for a, b in zip(tfs[1](tp), jfs[1](jp)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def assert_two_seq_epochs_match(jmodel, tmodel, data, maxlen, b=16, seed=0, lr=1e-2):
    """Two epochs of JAX's ``make_seq_epoch_fn`` against the port's
    ``seq_train_step`` on the same draws (per step ``ks, kl = split(step
    key)``, the batch from ``ks``; the zoo models here draw nothing else):
    the stats, and params and Adam moments within 1e-5 of each tree's
    scale."""
    import optax

    from acf_tpu.train.trainer import make_seq_epoch_fn
    from acf_tpu_torch.train import adam
    from acf_tpu_torch.train.trainer import _add_stats, _mean_stats, seq_train_step

    jp, tp = carry(jmodel, seed)
    jopt, topt = optax.adam(lr), adam(lr)
    js, ts = jopt.init(jp), topt.init(tp)
    nb = 3
    eligible = np.nonzero(data.hist_len >= 2)[0].astype(np.int32)
    dev = {"hist": jnp.asarray(data.hist), "eligible": jnp.asarray(eligible)}
    epoch = make_seq_epoch_fn(jmodel, jopt, b, nb)
    key = jax.random.PRNGKey(seed + 10)
    for _ in range(2):
        key, k = jax.random.split(key)
        (jp, js), jstats = epoch((jp, js), dev, k)
        sums = {}
        for kk in jax.random.split(k, nb):
            ks, _ = jax.random.split(kk)
            _, idx, cand = window_draws(ks, data, maxlen, b)
            batch = seq_window_from_draws(t(data.hist), t(eligible), t(idx), t(cand), maxlen)
            tp, ts, aux = seq_train_step(tmodel, topt, tp, ts, batch)
            _add_stats(sums, aux)
        stats = _mean_stats(sums, nb)
        for k_ in jstats:
            np.testing.assert_allclose(stats[k_], float(jstats[k_]), rtol=1e-5, atol=1e-6,
                                       err_msg=k_)
    assert_trees_close(tp, jp, 1e-5, "params")
    assert_trees_close(ts["mu"], js[0].mu, 1e-5, "mu")
    assert_trees_close(ts["nu"], js[0].nu, 1e-5, "nu")
    assert int(ts["count"]) == int(js[0].count) == 2 * nb


def assert_fgsm_matches(jbase, tbase, batch, seed=0, adv_steps=1, key=jax.random.PRNGKey(1),
                        **kw):
    """``FGSMAdversarial`` around ``jbase`` / ``tbase``: the loss, every aux
    value, the deltas of the auto-detected leaves and every gradient leaf
    (``kw``: the port's injected masks). Returns the detected leaves."""
    from acf_tpu.adversarial import FGSMAdversarial as JaxFGSM
    from acf_tpu_torch.adversarial import FGSMAdversarial

    U, I, d = jbase.num_users, jbase.num_items, jbase.dim
    jw = JaxFGSM(U, I, d, base=jbase, eps=0.5, reg_adv=1.0, adv_steps=adv_steps)
    tw = FGSMAdversarial(U, I, d, base=tbase, eps=0.5, reg_adv=1.0, adv_steps=adv_steps)
    jp, tp = carry(jw, seed)
    assert_loss_and_grads(jw, jp, tw, tp, batch, key, FGSM_TOL, **kw)
    names = tuple(sorted(tw._leaf_names(tp)))
    assert names == tuple(sorted(jw._leaf_names(jp)))
    if not kw:  # no dropout: the deltas alone are comparable
        jd = jw.deltas(jp, tuple(map(jnp.asarray, batch)), jax.random.split(key)[0])
        td = tw.deltas(tp, tuple(t(x) for x in batch))
        for k in names:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    return names


# --- cells --------------------------------------------------------------------

def _inputs(b=6, t_=5, d_in=12, d_h=8, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, t_, d_in)).astype(np.float32)
    mask = rng.random((b, t_)) < 0.7
    mask[0] = False  # an all-pad row
    mask[1] = True
    mask[2, :2] = False  # right-aligned: pads first
    h0 = np.zeros((b, d_h), np.float32)
    return xs, mask, h0


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_gru_cell_matches_jax(act):
    jp = jax_rnn.init_gru(jax.random.PRNGKey(0), 12, 8)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    h = rng.standard_normal((5, 8)).astype(np.float32)
    jact, tact = (jnp.tanh, torch.tanh) if act == "tanh" else (jax.nn.relu, torch.relu)
    ref = jax_rnn.gru_cell(jp, x, h, activation=jact)
    got = rnn.gru_cell(tp, t(x), t(h), activation=tact)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_simple_rnn_cell_matches_jax():
    jp = jax_rnn.init_simple_rnn(jax.random.PRNGKey(2), 12, 8)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    h = rng.standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_allclose(rnn.simple_rnn_cell(tp, t(x), t(h)).numpy(),
                               np.asarray(jax_rnn.simple_rnn_cell(jp, x, h)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("cell", ["gru", "simple"])
def test_run_rnn_matches_jax_and_freezes_pads(cell):
    """States after every step equal JAX's; a pad step keeps the state,
    and an all-pad row stays at the zero state. The gradient of a function
    of the states matches too."""
    init, fn = ((jax_rnn.init_gru, "gru_cell") if cell == "gru"
                else (jax_rnn.init_simple_rnn, "simple_rnn_cell"))
    jp = init(jax.random.PRNGKey(4), 12, 8)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    xs, mask, h0 = _inputs()
    jh, jhs = jax_rnn.run_rnn(getattr(jax_rnn, fn), jp, xs, mask, h0)
    th, ths = rnn.run_rnn(getattr(rnn, fn), tp, t(xs), t(mask), t(h0))
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), rtol=0, atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=ATOL)
    hs = ths.numpy()
    assert (hs[0] == 0).all() and (th.numpy()[0] == 0).all()
    assert (hs[2, :2] == 0).all() and not (hs[2, 2] == 0).all()
    for b, s in zip(*np.nonzero(~mask[:, 1:])):
        np.testing.assert_array_equal(hs[b, s + 1], hs[b, s])

    w = np.random.default_rng(5).standard_normal(hs.shape).astype(np.float32)

    def jloss(p):
        return jnp.sum(jax_rnn.run_rnn(getattr(jax_rnn, fn), p, xs, mask, h0)[1] * w)

    jg = jax.grad(jloss)(jp)
    prm = tree_map(lambda x: x.clone().requires_grad_(True), tp)
    out = torch.sum(rnn.run_rnn(getattr(rnn, fn), prm, t(xs), t(mask), t(h0))[1] * t(w))
    tg = tree_unflatten(tp, list(torch.autograd.grad(out, tree_leaves(prm))))
    assert_trees_close(tg, jg)


def test_initialisers_follow_the_jax_layouts():
    """TF GRUCell's layout with gate bias 1; SimpleRNN's recurrent kernel
    orthogonal with Keras' sign fix (Q times the signs of R's diagonal,
    from the draw after the glorot input kernel's), zero bias."""
    g = torch.Generator().manual_seed(0)
    gru = rnn.init_gru(g, 12, 8)
    ref = jax_rnn.init_gru(jax.random.PRNGKey(0), 12, 8)
    assert {k: tuple(v.shape) for k, v in gru.items()} == {k: v.shape for k, v in ref.items()}
    assert (gru["b_gates"] == 1).all() and (gru["b_cand"] == 0).all()
    limit = np.sqrt(6.0 / (20 + 16))
    assert float(gru["w_gates"].abs().max()) <= limit
    s = rnn.init_simple_rnn(g, 12, 8)
    w = s["w_rec"].double()
    torch.testing.assert_close(w.T @ w, torch.eye(8, dtype=torch.float64), atol=1e-6, rtol=0)
    g2 = torch.Generator().manual_seed(7)
    torch.empty(12, 8).uniform_(generator=g2)  # the glorot draw comes first
    q, r = torch.linalg.qr(torch.randn(8, 8, generator=g2))
    again = rnn.init_simple_rnn(torch.Generator().manual_seed(7), 12, 8)["w_rec"]
    torch.testing.assert_close(again, q * torch.sign(torch.diagonal(r))[None, :])
    assert (s["b"] == 0).all() and tuple(s["w_in"].shape) == (12, 8)


# --- dropout --------------------------------------------------------------------

def test_dropout_with_an_injected_mask_is_jax_dropout():
    """The JAX package's keep-mask handed over: the same output."""
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(0).standard_normal((6, 10)).astype(np.float32)
    ref = jax_layers.dropout(key, x, 0.3, True)
    mask = np.asarray(jax.random.bernoulli(key, 0.7, x.shape))
    got = layers.dropout(t(x), 0.3, True, mask=t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-7, atol=0)


def test_dropout_draws_identity_and_refusal():
    x = torch.ones(400, 50)
    assert layers.dropout(x, 0.5, False) is x and layers.dropout(x, 0.0, True) is x
    out = layers.dropout(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(out[kept], torch.full((int(kept.sum()),), 1 / 0.75))
    with pytest.raises(ValueError, match="Generator"):
        layers.dropout(x, 0.5, True)
