"""Whether K2a's and K2b's float32 forms give the same bits as another
checkout's: both libraries run the same inputs through this checkout's
wrappers, and every output (K2a's inference and training forms with the
saved block inputs; K2b's dx and flat weight gradient, and its dx-only
mode) must be equal bit for bit. A change that must leave the float32 path
as it was (a new form beside it, a refactor) is held to that here.

Run on a machine with a CUDA card, from the repo root, with the other
checkout's kernel sources unpacked somewhere, e.g.::

    mkdir -p parent && git archive HEAD~1 acf_tpu_torch/csrc | tar -x -C parent
    python -m acf_tpu_torch.tools.k2_identity parent/acf_tpu_torch/csrc

Cases: B = 512 with dropout masks and padded windows, d = 64 at T = 8 and
T = 50 (K2b's tile form). K2b's wide form has no case: its cluster sums dV,
dK and the weight gradients by rank, in another order than the workspace
form of commits ff82a88 to f5941ac (``chip_smoke.py`` phase 12 holds it to
its plain versions and to its own bits over two calls). Prints a line a
case; exits non-zero at the first difference.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

from acf_tpu_torch.ops import _build, sasrec_fused

CASES = ((64, 8), (64, 50))  # (d, T)
B = 512


def inputs(dev, d, t, seed):
    """SASRec params (2 blocks, biases and LayerNorms off their init
    values), windows with a left-padded and an all-padding row, masks and a
    cotangent, from ``seed``."""
    from acf_tpu_torch.models.sasrec import SASRec

    model = SASRec(100, 1000, d, maxlen=t)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init_params(g, device=dev)
    for p in params["blocks"] + [params]:
        for name, leaf in p.items():
            for key in ("gamma", "beta", "b"):
                if name != "item_emb" and isinstance(leaf, dict) and key in leaf:
                    leaf[key] += 0.1 * torch.randn(d, generator=g, device=dev)
    seq = torch.randint(1, 1000, (B, t), generator=g, device=dev)
    seq[0, : t // 2] = 0
    seq[-1] = 0
    x = params["item_emb"][seq] * math.sqrt(d)
    masks = model._dropout_masks(g, B, t)
    cot = torch.randn(B, t, d, generator=g, device=dev)
    return params, x, seq != 0, masks, 1.0 - model.dropout_rate, cot


def outputs(params, x, mask, masks, keep, cot):
    """Every float32 output of K2a and K2b on these inputs, by name."""
    inf = sasrec_fused.encoder_fwd(params, x, mask)[0]
    out, saved = sasrec_fused.encoder_fwd(params, x, mask, masks, keep, save=True)
    dx, grads = sasrec_fused.encoder_bwd(params, x, mask, cot, saved, masks, keep)
    dx_only, _ = sasrec_fused.encoder_bwd(params, x, mask, cot, saved, masks, keep,
                                          weight_grads=False)
    flat = torch.cat([grads["pos_emb"].flatten()]
                     + [v.flatten() for v in sasrec_fused._flat_leaves(grads)])
    torch.cuda.synchronize()
    return {"K2a inference": inf, "K2a training": out, "saved block inputs": saved,
            "K2b dx": dx, "K2b gradients": flat, "K2b dx-only": dx_only}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", help="the other checkout's acf_tpu_torch/csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_identity needs a CUDA card")
    dev = torch.device("cuda", 0)
    libs = {"this checkout": _build.library(),
            args.csrc: _build.load(_build.build(Path(args.csrc).resolve()))}
    real = sasrec_fused.library
    try:
        for n, (d, t) in enumerate(CASES):
            params, x, mask, masks, keep, cot = inputs(dev, d, t, seed=n)
            got = {}
            for label, lib in libs.items():
                sasrec_fused.library = lambda lib=lib: lib
                got[label] = outputs(params, x, mask, masks, keep, cot)
            mine, theirs = got.values()
            differ = [k for k in mine if not torch.equal(mine[k], theirs[k])]
            form = sasrec_fused._bwd_form(t, d)
            print(f"K2 float32 d={d} T={t} B={B} (K2b {form} form): "
                  + ("every output bit-identical" if not differ else f"differ: {differ}"))
            if differ:
                sys.exit(1)
    finally:
        sasrec_fused.library = real


if __name__ == "__main__":
    main()
