"""SASRec's bfloat16 training path at T = 32, where the attention's
products take bfloat16 operands too, and at d = 10 (a width with
d % 4 != 0), against the JAX package's kernel form in interpret mode, and
beside the JAX XLA path's bfloat16 form. The helpers, tolerances and their
reasons are those of ``tests/test_torch_sasrec_bf16.py`` (T = 8).

``python -m tests.test_torch_sasrec_bf16_t32`` prints how far the JAX
package's two bf16 encoders lie apart and from f32 (``forms_distance``)."""

import jax
import numpy as np
import pytest

from tests.test_torch_sasrec_bf16 import (
    CONFIGS, XLA_RTOL, check_forward, check_step, jax_masks, jittered, models,
    port_value_and_grad, window_batch,
)

T, D = 32, 10


@pytest.mark.parametrize("d,dropout", [(16, True), (D, False)], ids=["d16-dropout", "d10"])
def test_plain_forward_matches_jax_kernel(d, dropout):
    check_forward(d, T, dropout, seed=d + T)


@pytest.mark.parametrize("config", ["asasrec", "sasrec"])
def test_loss_and_every_grad_match_jax_kernel(config):
    check_step(D, T, config, seed=len(config))


def test_close_to_float32_and_to_the_xla_form():
    """The port's bfloat16 loss and JAX's XLA-path bfloat16 loss
    (``fused="never"``: activations and residuals in bfloat16 too) both
    within rtol 2e-2 of the float32 loss; the port's gradients finite and
    float32."""
    kw = CONFIGS["asasrec"]
    jm32 = models(D, T, fused="never", train_dtype="float32", **kw)[0]
    jxla = models(D, T, fused="never", **kw)[0]
    _, tm = models(D, T, **kw)
    jp, tp = jittered(jm32, 7)
    users, window, neg = window_batch(T, 8)
    batch = (users, window[:, :-1], window[:, 1:], neg)
    key = jax.random.PRNGKey(9)
    l32 = float(jax.jit(jm32.loss)(jp, batch, key)[0])
    lxla = float(jax.jit(jxla.loss)(jp, batch, key)[0])
    loss, _, grads = port_value_and_grad(tm.loss, tp, batch, *jax_masks(jm32, key, T))
    np.testing.assert_allclose(float(loss.detach()), l32, rtol=XLA_RTOL)
    np.testing.assert_allclose(lxla, l32, rtol=XLA_RTOL)
    assert float(loss.detach()) != l32  # the bfloat16 form ran
    for name, v in grads.items():
        assert v.dtype == np.float32 and np.isfinite(v).all(), name


def forms_distance(t, d=16, seed=5):
    """How far the JAX package's two bf16 encoders lie apart and from f32:
    the kernel form (``fused="always"``, what the port computes) and the XLA
    path's (``fused="never"``, activations and residuals in bf16 too, the
    JAX CLI's default), on one batch of a clean SASRec at window ``t``.
    Returns the three losses and, for each pair of forms, the largest
    difference of ``blocks/0/wq/w``'s gradient and of any leaf's (the key
    biases aside) as a share of that leaf's largest entry in the second."""
    from acf_tpu.train.checkpoint import _flatten_with_names as named

    kernel = models(d, t)[0]
    xla = models(d, t, fused="never")[0]
    f32 = models(d, t, fused="never", train_dtype="float32")[0]
    jp, _ = jittered(f32, seed)
    users, window, neg = window_batch(t, seed + 1)
    batch = (users, window[:, :-1], window[:, 1:], neg)
    key = jax.random.PRNGKey(seed + 2)
    out = {}
    for name, jm in (("kernel", kernel), ("xla", xla), ("f32", f32)):
        (loss, _), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, batch, key)
        out[name] = float(loss), dict(named(jax.tree.map(np.asarray, g)))

    def share(a, b, leaf):
        return float(np.abs(a[leaf] - b[leaf]).max() / np.abs(b[leaf]).max())

    dist = {}
    for a, b in (("kernel", "xla"), ("kernel", "f32"), ("xla", "f32")):
        ga, gb = out[a][1], out[b][1]
        dist[a, b] = (share(ga, gb, "blocks/0/wq/w"),
                      max(share(ga, gb, n) for n in gb if not n.endswith("/wk/b")))
    return {k: v[0] for k, v in out.items()}, dist


if __name__ == "__main__":  # python -m tests.test_torch_sasrec_bf16_t32
    jax.config.update("jax_platforms", "cpu")
    for t in (8, 32):
        losses, dist = forms_distance(t)
        print(f"T={t}: losses " + ", ".join(f"{k} {v:.7f}" for k, v in losses.items()) + "; "
              + "; ".join(f"{a} vs {b}: wq/w {w:.4f}, worst leaf {m:.4f}"
                          for (a, b), (w, m) in dist.items()))
