"""ASASRec2 (``eps_pos``, ``eps_dense`` and ``eps_conv`` non-zero) on the
bfloat16 training path: its loss and every gradient leaf against the JAX
package's kernel form in interpret mode at T = 8, d = 16 and at T = 32,
d = 10. Its JAX references (~25-30 s each: the delta tree's backward and
the adversarial pass beside the clean one) have a file of their own; the
helpers, tolerances and their reasons are those of
``tests/test_torch_sasrec_bf16.py``."""

import pytest

from tests.test_torch_sasrec_bf16 import check_step


@pytest.mark.parametrize("t,d", [(8, 16), (32, 10)], ids=["t8-d16", "t32-d10"])
def test_loss_and_every_grad_match_jax_kernel(t, d):
    check_step(d, t, "asasrec2", seed=t + d)
