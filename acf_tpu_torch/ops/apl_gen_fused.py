"""APL's generator chain: five passes over the catalog, as plain PyTorch and
as the K3a–K3e kernels (counterpart of ``acf_tpu/ops/apl_gen_fused.py``).

The generator step differentiates a scalar loss through a full-catalog
chain (closed form in ``acf_tpu/models/apl.py::gen_step_manual``):

  logits = P_g[u] Q_gᵀ               [B, I], column 0 (the pad id) at -1e30
  probs  = softmax(logits)
  mixed  = (1-w)·probs + w·member/nuniq
  z      = (log(mixed + 1e-20) + gumbel) / T
  s      = softmax(z),  c = P_c[u] Q_cᵀ,  fake = Σ_i s·c
  r      = (1-w)/T · s·a(c − fake) / (mixed + 1e-20),  a = ∂L/∂fake
  dlogits = probs∘(r − ⟨probs, r⟩);  dQ = dlogitsᵀ P_g[u];  dP = dlogits Q_g

in five passes, each recomputing the [B, d]×[d, I] products it needs:

  K3a  :func:`apl_stats1`  m1, l1: row max and Σexp of the logits
  K3b  :func:`apl_z`       z [B, I] (column 0 live, as in the XLA softmax),
                           m2, l2: row max and Σexp of z
  K3c  :func:`apl_fake`    fake [B]
  (the caller: a = ∂L/∂fake through the [B] loss head)
  K3d  :func:`apl_bigr`    R = ⟨probs, r⟩ [B]
  K3e  :func:`apl_grad`    dQ [I, d], dP [B, d]

:func:`apl_gen_forward` runs K3a–K3c and :func:`apl_gen_backward` K3d–K3e.
On CPU tensors each pass runs its plain version (``*_plain``, whole [B, I]
tensors, the JAX kernels' formulas); on CUDA tensors it launches its
kernel in ``csrc/apl_gen.cu`` and adds one to its ``launches`` counter, or
raises ``ValueError`` (:func:`check_supported`). The kernels take every
width d >= 1 at any float32 alignment, as the TPU kernels do. Only ``z`` is
a [B, I] output; nothing is padded or copied wider (the kernels mask the
ragged tail and zero the rows' tails in shared memory themselves).

Rounding note: the kernels sum the products, the softmax denominators and
the gradients in their own order (in a fixed order, with no atomics: two
calls give bit-identical outputs), so they agree with the plain versions to
f32 rounding, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from acf_tpu_torch.ops._build import library

EPS = 1e-20
NEG = -1e30

# Kernel geometry (csrc/apl_gen.cu): 64-user x 64-item tiles; K3a-K3d give
# each block a chunk of CHUNK_TILES item tiles, K3e one item tile. Up to
# MAX_WHOLE_D a staged tile holds whole rows (K3e's register tile: 8 columns a
# thread); past it, one k slice of SLICE columns at a time (every width).
TILE = 64
CHUNK_TILES = 4
MAX_WHOLE_D = 128
SLICE = 64
SMEM_LIMIT = 232_448           # shared memory one Hopper block may use (227 KB)

# expected shape (in B, I, d) and dtype of every tensor a pass reads
_SPECS = {
    "pu_g": (("B", "d"), torch.float32), "Qg": (("I", "d"), torch.float32),
    "pu_c": (("B", "d"), torch.float32), "Qc": (("I", "d"), torch.float32),
    "member": (("B", "I"), torch.uint8), "gnoise": (("B", "I"), torch.float32),
    "z": (("B", "I"), torch.float32),
    **{name: (("B",), torch.float32)
       for name in ("nuniq", "m1", "l1", "m2", "l2", "a", "fake", "R")},
}


# --- plain versions ---------------------------------------------------------------

def _logits(pu_g, Qg):
    logits = pu_g @ Qg.T
    logits[:, 0] = NEG  # the pad item gets no probability mass
    return logits


def _probs_mixed(pu_g, Qg, member, nuniq, m1, l1, w):
    probs = torch.exp(_logits(pu_g, Qg) - m1[:, None]) / l1[:, None]
    mixed = (1.0 - w) * probs + w * member.to(torch.float32) / nuniq[:, None]
    return probs, mixed


def _row_stats(x):
    """(row max, Σ exp(x − max)): a softmax's two statistics."""
    m = x.max(dim=1).values
    return m, torch.exp(x - m[:, None]).sum(dim=1)


def _r(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake, w, temperature):
    """(probs, r) of every item, as the JAX kernels' ``_r_tile``."""
    probs, mixed = _probs_mixed(pu_g, Qg, member, nuniq, m1, l1, w)
    c = pu_c @ Qc.T
    s = torch.exp(z - m2[:, None]) / l2[:, None]
    t = a[:, None] * (c - fake[:, None])
    r = ((1.0 - w) / temperature) * s * t / (mixed + EPS)
    return probs, r


def apl_stats1_plain(pu_g, Qg):
    """K3a's plain version: (m1, l1) [B] of the masked logits."""
    return _row_stats(_logits(pu_g, Qg))


def apl_z_plain(pu_g, Qg, member, nuniq, gnoise, m1, l1, *, w, temperature):
    """K3b's plain version: (z [B, I], m2, l2). Column 0's z is
    (log(1e-20) + gumbel) / T: tiny, but live in the statistics."""
    _, mixed = _probs_mixed(pu_g, Qg, member, nuniq, m1, l1, w)
    z = (torch.log(mixed + EPS) + gnoise) / temperature
    return (z, *_row_stats(z))


def apl_fake_plain(pu_c, Qc, z, m2, l2):
    """K3c's plain version: fake [B] = Σ_i softmax(z)·(P_c[u]·Q_cᵀ)."""
    s = torch.exp(z - m2[:, None]) / l2[:, None]
    return torch.sum(s * (pu_c @ Qc.T), dim=1)


def apl_bigr_plain(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake, *,
                   w, temperature):
    """K3d's plain version: R [B] = ⟨probs, r⟩."""
    probs, r = _r(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake, w,
                  temperature)
    return torch.sum(probs * r, dim=1)


def apl_grad_plain(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake, R, *,
                   w, temperature):
    """K3e's plain version: (dQ [I, d], dP [B, d]) of dlogits =
    probs∘(r − R)."""
    probs, r = _r(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake, w,
                  temperature)
    dlogits = probs * (r - R[:, None])
    return dlogits.T @ pu_g, dlogits @ Qg


# --- limits ---------------------------------------------------------------------

def _ld(d: int) -> int:
    """Row stride (floats) of a staged [64, ld] tile at width d: an odd
    number of 16-byte units holding d rounded up to 4 (a zero tail), or past
    MAX_WHOLE_D one k slice of SLICE columns."""
    cols = SLICE if d > MAX_WHOLE_D else (d + 3) // 4 * 4
    return 4 * ((cols // 4) | 1)


def smem_footprints(d: int) -> dict[str, int]:
    """Shared-memory bytes of each kernel's block at width d, as the C
    entries compute them: K3a a user tile and two item tiles; K3b those,
    two [64, 80] noise tiles and two [64, 68]-byte member tiles; K3c a user
    tile, two item tiles and two [64, 80] z tiles; K3d two user tiles, one
    Q_g/Q_c pair of item tiles, one [64, 80] z tile, [64, 8] row scalars and
    one [64, 68]-byte member tile; K3e K3d's four tiles, z tile and member
    tile, [64, 12] row scalars and its [64, 65] dlogits tile. Past
    MAX_WHOLE_D every [64, ld] tile holds one k slice, so the footprints are
    those of d = SLICE, whatever d."""
    tile = TILE * _ld(d)
    z = TILE * (TILE + 16)  # one z (or noise) tile
    zm = z + TILE * (TILE + 4) // 4  # one z and one member tile
    floats = {"apl_stats1": 3 * tile, "apl_fake": 3 * tile + 2 * z,
              "apl_z": 3 * tile + 2 * zm,
              "apl_bigr": 4 * tile + zm + TILE * 8,
              "apl_grad": 4 * tile + zm + TILE * 12 + TILE * (TILE + 1)}
    return {name: 4 * n for name, n in floats.items()}


def smem_bytes(d: int) -> int:
    """The largest shared-memory footprint of the five kernels at width d."""
    return max(smem_footprints(d).values())


def check_supported(**tensors):
    """Raise ``ValueError`` unless the kernels take these named tensors (the
    names of :func:`apl_gen_forward`'s and :func:`apl_gen_backward`'s
    arguments): every one on the same CUDA device (:func:`check_operands`
    for the rest)."""
    users = tensors.get("pu_g", tensors.get("pu_c"))
    if users is not None and users.device.type != "cuda":
        raise ValueError(f"the APL kernels run on CUDA tensors, not {users.device}")
    check_operands(**tensors)


def check_operands(**tensors):
    """Raise ``ValueError`` unless every named tensor is on the user rows'
    device, contiguous, aligned to its element, of its dtype (``member``
    uint8, the rest float32) and of its shape in B, I and d, with d >= 1, B >=
    1 and I >= 2. Any width and alignment is taken (4-byte copies where d % 4
    != 0 or a row is not 16-byte aligned; k slices past MAX_WHOLE_D)."""
    users = tensors.get("pu_g", tensors.get("pu_c"))
    table = tensors.get("Qg", tensors.get("Qc"))
    if users is None or table is None or users.dim() != 2 or table.dim() != 2:
        raise ValueError("the APL kernels need [B, d] user rows and an [I, d] table")
    dims = {"B": users.shape[0], "d": users.shape[1], "I": table.shape[0]}
    b, d, num_items = dims["B"], dims["d"], dims["I"]
    if b < 1 or num_items < 2 or d < 1:
        raise ValueError(f"the APL kernels need B >= 1, I >= 2 (item 0 is the pad) and "
                         f"d >= 1; got B={b}, I={num_items}, d={d}")
    for name, x in tensors.items():
        shape, dtype = _SPECS[name]
        shape = tuple(dims[s] for s in shape)
        if x.device != users.device:
            raise ValueError(f"{name} is on {x.device}, the user rows on {users.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % x.element_size():
            raise ValueError(f"{name} must be contiguous and aligned to its elements")


# --- kernel wrappers --------------------------------------------------------------

def chunks(num_items: int) -> int:
    """Item chunks of K3a–K3d: one partial statistic per chunk and user."""
    return math.ceil(num_items / (TILE * CHUNK_TILES))


def _launch(name, *args):
    lib = library()
    dev = args[0].device
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args]
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _cuda(x):
    return x.device.type != "cpu"


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def apl_stats1(pu_g, Qg):
    """K3a: (m1, l1) [B]. CPU tensors take :func:`apl_stats1_plain`."""
    if not _cuda(pu_g):
        return apl_stats1_plain(pu_g, Qg)
    check_supported(pu_g=pu_g, Qg=Qg)
    (b, d), num_items = pu_g.shape, Qg.shape[0]
    m1, l1 = _empty(pu_g.device, b), _empty(pu_g.device, b)
    part = _empty(pu_g.device, 2, chunks(num_items), b)
    _launch("acf_apl_stats1", pu_g, Qg, m1, l1, part, b, num_items, d)
    apl_stats1.launches += 1
    return m1, l1


def apl_z(pu_g, Qg, member, nuniq, gnoise, m1, l1, *, w, temperature):
    """K3b: (z [B, I], m2, l2). CPU tensors take :func:`apl_z_plain`."""
    if not _cuda(pu_g):
        return apl_z_plain(pu_g, Qg, member, nuniq, gnoise, m1, l1, w=w,
                           temperature=temperature)
    check_supported(pu_g=pu_g, Qg=Qg, member=member, nuniq=nuniq, gnoise=gnoise, m1=m1,
                    l1=l1)
    (b, d), num_items = pu_g.shape, Qg.shape[0]
    z = _empty(pu_g.device, b, num_items)
    m2, l2 = _empty(pu_g.device, b), _empty(pu_g.device, b)
    part = _empty(pu_g.device, 2, chunks(num_items), b)
    _launch("acf_apl_z", pu_g, Qg, member, nuniq, gnoise, m1, l1, z, m2, l2, part, b,
            num_items, d, 1.0 - w, w, temperature)
    apl_z.launches += 1
    return z, m2, l2


def apl_fake(pu_c, Qc, z, m2, l2):
    """K3c: fake [B]. CPU tensors take :func:`apl_fake_plain`."""
    if not _cuda(pu_c):
        return apl_fake_plain(pu_c, Qc, z, m2, l2)
    check_supported(pu_c=pu_c, Qc=Qc, z=z, m2=m2, l2=l2)
    (b, d), num_items = pu_c.shape, Qc.shape[0]
    fake = _empty(pu_c.device, b)
    part = _empty(pu_c.device, chunks(num_items), b)
    _launch("acf_apl_fake", pu_c, Qc, z, m2, l2, fake, part, b, num_items, d)
    apl_fake.launches += 1
    return fake


def _chain_args(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake):
    return dict(pu_g=pu_g, Qg=Qg, pu_c=pu_c, Qc=Qc, member=member, nuniq=nuniq, z=z,
                m1=m1, l1=l1, m2=m2, l2=l2, a=a, fake=fake)


def apl_bigr(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake, *, w,
             temperature):
    """K3d: R [B]. CPU tensors take :func:`apl_bigr_plain`."""
    chain = _chain_args(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake)
    if not _cuda(pu_g):
        return apl_bigr_plain(**chain, w=w, temperature=temperature)
    check_supported(**chain)
    (b, d), num_items = pu_g.shape, Qg.shape[0]
    R = _empty(pu_g.device, b)
    part = _empty(pu_g.device, chunks(num_items), b)
    _launch("acf_apl_bigr", *chain.values(), R, part, b, num_items, d, 1.0 - w, w,
            (1.0 - w) / temperature)
    apl_bigr.launches += 1
    return R


def apl_grad(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake, R, *, w,
             temperature):
    """K3e: (dQ [I, d], dP [B, d]). CPU tensors take :func:`apl_grad_plain`."""
    chain = _chain_args(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake)
    if not _cuda(pu_g):
        return apl_grad_plain(**chain, R=R, w=w, temperature=temperature)
    check_supported(**chain, R=R)
    (b, d), num_items = pu_g.shape, Qg.shape[0]
    dQ, dP = _empty(pu_g.device, num_items, d), _empty(pu_g.device, b, d)
    part = _empty(pu_g.device, math.ceil(num_items / TILE), b, d)
    _launch("acf_apl_grad", *chain.values(), R, dQ, dP, part, b, num_items, d, 1.0 - w,
            w, (1.0 - w) / temperature)
    apl_grad.launches += 1
    return dQ, dP


for _k in (apl_stats1, apl_z, apl_fake, apl_bigr, apl_grad):
    _k.launches = 0
KERNELS = (apl_stats1, apl_z, apl_fake, apl_bigr, apl_grad)


# --- the chain --------------------------------------------------------------------

def apl_gen_forward(pu_g, Qg, pu_c, Qc, member, nuniq, gnoise, *, w: float,
                    temperature: float):
    """K3a–K3c.

    Args:
      pu_g/pu_c: [B, d] gathered generator/critic user rows.
      Qg/Qc: [I, d] generator/critic item tables.
      member: [B, I] uint8, 1 where the item is one of the user's unique
        positives (the pad column 0 is 0).
      nuniq: [B] float32, each user's unique-positive count (>= 1).
      gnoise: [B, I] float32 Gumbel noise, drawn by the caller.

    Returns ``(fake [B], residuals)``; hand ``residuals`` and
    ``a = ∂L/∂fake`` to :func:`apl_gen_backward`.
    """
    if _cuda(pu_g):  # every limit before the first launch
        check_supported(pu_g=pu_g, Qg=Qg, pu_c=pu_c, Qc=Qc, member=member, nuniq=nuniq,
                        gnoise=gnoise)
    m1, l1 = apl_stats1(pu_g, Qg)
    z, m2, l2 = apl_z(pu_g, Qg, member, nuniq, gnoise, m1, l1, w=w, temperature=temperature)
    fake = apl_fake(pu_c, Qc, z, m2, l2)
    return fake, (Qg, Qc, member, z, m1, l1, m2, l2, fake)


def apl_gen_backward(pu_g, pu_c, nuniq, a, res, *, w: float, temperature: float):
    """K3d–K3e: the chain's gradients ``(dP_rows [B, d], dQ [I, d])`` with
    respect to the gathered generator user rows and the generator table
    (the regularization terms are the caller's)."""
    Qg, Qc, member, z, m1, l1, m2, l2, fake = res
    chain = _chain_args(pu_g, Qg, pu_c, Qc, member, nuniq, z, m1, l1, m2, l2, a, fake)
    R = apl_bigr(**chain, w=w, temperature=temperature)
    dQ, dP = apl_grad(**chain, R=R, w=w, temperature=temperature)
    return dP, dQ
