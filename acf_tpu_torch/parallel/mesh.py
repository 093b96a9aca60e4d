"""The ("data", "model") mesh over the ranks of a ``torch.distributed``
process group (counterpart of ``acf_tpu/parallel/mesh.py``).

The JAX package annotates shardings and lets GSPMD insert the collectives.
Here every rank is one process with one device, and the collectives are
explicit: batches are split over the "data" axis, embedding tables
row-sharded over the "model" axis, and each reduction names its axis
(:meth:`Mesh.all_reduce`). Rank = d · model + m, the row-major layout of
JAX's ``make_mesh`` (``devices.reshape(num_data, num_model)``).

Under a mesh the trainer stores a param tree as :func:`shard_params` places
it: each 2-D leaf that the JAX package's ``shard_params`` shards (at least
``max(min_rows, m)`` rows, and its rows or its columns divide the "model"
axis size m) as a row shard of ceil(R / m) rows on each model rank, padded
with zero rows; every other leaf whole on every rank. The :class:`Layout`
it returns records each sharded leaf's global row count, and every gather,
slice and snapshot reads it.

A mesh needs as many ranks as it has cells: one process a rank, started by
``torchrun --nproc_per_node N`` (or :mod:`acf_tpu_torch.parallel.launch`).
There is no fallback to virtual devices: a spec that does not equal the
world size raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.parallel.sharded_embedding import gather_table, shard_table
from acf_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Initialise the default process group once; returns this rank's device.

    The backend is NCCL for a ``cuda`` device and gloo for ``cpu``; gloo on
    CUDA tensors only when ``backend="gloo"`` is asked (several ranks on one
    card, where NCCL refuses a duplicate GPU). Rank and world size come from
    the arguments, else from ``RANK``/``WORLD_SIZE`` (as ``torchrun`` sets
    them, with ``env://``), else a single-process group of one rank. A
    ``cuda`` device without an index is the rank's ``LOCAL_RANK`` card."""
    if device is None or str(device) == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = f"cuda:{local}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if rank is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method=init_method or "env://")
    elif rank is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return dev


class Mesh:
    """A ("data", "model") mesh over every rank of the default group.

    ``shape`` maps each axis to its size; ``data_index``/``model_index``
    are this rank's coordinates. The model groups (one per data row) and the
    data groups (one per model column) are made on every rank, in one fixed
    order, as ``dist.new_group`` requires."""

    def __init__(self, num_data: int, num_model: int, device):
        world = dist.get_world_size()
        if num_data < 1 or num_model < 1 or num_data * num_model != world:
            raise ValueError(_rank_message(f"{num_data}x{num_model}", num_data * num_model,
                                           world))
        self.shape = {"data": num_data, "model": num_model}
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.data_index, self.model_index = divmod(self.rank, num_model)
        self._groups = {}
        for d in range(num_data):
            g = dist.new_group([d * num_model + m for m in range(num_model)])
            if d == self.data_index:
                self._groups["model"] = g
        for m in range(num_model):
            g = dist.new_group([d * num_model + m for d in range(num_data)])
            if m == self.model_index:
                self._groups["data"] = g

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def index(self, axis: str) -> int:
        return self.data_index if axis == "data" else self.model_index

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``x`` in place over the ranks of this rank's ``axis`` group
        ("data": the ranks that share its model column; "model": its data
        row); returns ``x``."""
        dist.all_reduce(x, group=self._groups[axis])
        return x

    def host_groups(self) -> dict:
        """gloo groups over the same ranks for host-side collectives
        (snapshots): "world", "data" and "model", made on first use, which
        every rank must reach together. The mesh's own groups may be NCCL,
        or busy with training while a snapshot is written."""
        if not hasattr(self, "_host"):
            dp, m = self.shape["data"], self.shape["model"]
            host = {"world": dist.new_group(backend="gloo")}
            for d in range(dp):
                g = dist.new_group([d * m + k for k in range(m)], backend="gloo")
                if d == self.data_index:
                    host["model"] = g
            for k in range(m):
                g = dist.new_group([d * m + k for d in range(dp)], backend="gloo")
                if k == self.model_index:
                    host["data"] = g
            self._host = host
        return self._host

    def rows(self, n: int) -> slice:
        """This data rank's rows of a global batch of ``n`` rows (the
        counterpart of ``data_constrainer``): ``n`` must divide over the data
        axis."""
        dp = self.shape["data"]
        if n % dp:
            raise ValueError(f"a batch of {n} rows does not divide over a {dp}-way data axis")
        per = n // dp
        return slice(self.data_index * per, (self.data_index + 1) * per)


def all_reduce_tree(mesh, tree, axis: str = "data"):
    """The tree of tensors summed over ``axis``, in one ``all_reduce`` of
    its leaves packed end to end (one dtype)."""
    leaves = tree_leaves(tree)
    flat = torch.cat([x.reshape(-1) for x in leaves])
    mesh.all_reduce(flat, axis)
    parts = torch.split(flat, [x.numel() for x in leaves])
    return tree_unflatten(tree, [p.reshape(x.shape) for p, x in zip(parts, leaves)])


class Layout:
    """Where each leaf of a param tree lives under ``mesh``: ``rows`` is a
    tree of the params' structure whose leaf is the global row count R of a
    leaf stored as a row shard over "model" (model rank k holds rows
    [k·ceil(R/m), (k+1)·ceil(R/m)), padded with zero rows that no step reads
    and no update moves), or None for a leaf whole on every rank."""

    def __init__(self, mesh, rows):
        self.mesh = mesh
        self.rows = rows

    @property
    def sharded(self) -> bool:
        """Whether any leaf is stored sharded."""
        return any(r is not None for r in tree_leaves(self.rows))

    def sub(self, key) -> "Layout":
        """The layout of the subtree ``key`` (a player's params)."""
        return Layout(self.mesh, self.rows[key])

    def gather(self, tree, keep=()):
        """``tree`` (stored as this layout says) with every sharded leaf
        whole but those in ``keep`` (stored leaves left as they are): one
        ``all_reduce`` over "model" a leaf, exact (each row is one rank's
        value and zeros)."""
        def whole(x, r):
            if r is None or any(x is k for k in keep):
                return x
            return gather_table(self.mesh, x, r)

        return tree_map(whole, tree, self.rows)

    def rows_of(self, tree, leaf):
        """The global row count of ``leaf`` (a stored leaf of ``tree``) if it
        is sharded, else None."""
        for x, r in zip(tree_leaves(tree), tree_leaves(self.rows)):
            if x is leaf:
                return r
        return None

    def own(self, tree):
        """``tree`` of whole leaves as this layout stores it: this rank's
        rows of every sharded leaf (fresh tensors), the rest as given."""
        return tree_map(lambda x, r: x if r is None else shard_table(self.mesh, x), tree,
                        self.rows)


def shard_params(mesh, params, min_rows: int = 1024):
    """(the params as the trainer stores them under ``mesh``, their
    :class:`Layout`): each 2-D leaf with at least ``max(min_rows, m)`` rows
    whose rows or columns divide the "model" axis size m (the leaves
    ``acf_tpu/parallel/mesh.py::shard_params`` shards) becomes this rank's
    row shard; every other leaf stays whole. JAX shards a leaf whose rows do
    not divide m by columns, to keep GSPMD's shapes; the port's collectives
    are explicit, so one row layout padded with zero rows serves every such
    leaf. With m = 1 nothing is sharded."""
    m = mesh.shape["model"]

    def place(x):
        if (m > 1 and x.dim() == 2 and x.shape[0] >= max(min_rows, m)
                and (x.shape[0] % m == 0 or x.shape[1] % m == 0)):
            return int(x.shape[0])
        return None

    layout = Layout(mesh, tree_map(place, params))
    return layout.own(params), layout


def _rank_message(spec, n, world):
    return (f"--mesh {spec} needs {n} ranks but the process group has {world}: start one "
            f"process a rank, e.g. torchrun --nproc_per_node {n} -m acf_tpu_torch.cli.main "
            f"... --mesh {spec}")


def make_mesh(num_data: Optional[int] = None, num_model: int = 1, device=None) -> Mesh:
    """A ("data", "model") mesh over the default group, initialised on
    ``device`` if it is not yet (:func:`init_distributed`). Defaults to every
    rank on the data axis."""
    dev = init_distributed(device)
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // num_model
    return Mesh(num_data, num_model, dev)


def parse_spec(spec: str):
    """``"4x2"`` → (4, 2), ``"8"`` → (8, 1); the JAX CLI's grammar and error."""
    parts = spec.lower().replace("×", "x").split("x")
    try:
        if len(parts) > 2:
            raise ValueError(spec)
        num_data = int(parts[0])
        num_model = int(parts[1]) if len(parts) > 1 else 1
        if num_data < 1 or num_model < 1:
            raise ValueError(spec)
    except (ValueError, IndexError):
        raise ValueError(
            f"--mesh expects DATAxMODEL (e.g. 4x2) or N with positive "
            f"sizes, got {spec!r}")
    return num_data, num_model


def mesh_from_spec(spec: str, device=None, backend: Optional[str] = None) -> Mesh:
    """Parse a ``--mesh`` spec and build the mesh over the process group
    (initialised here if it is not: under ``torchrun`` from its environment,
    else a group of one rank). A spec whose size is not the world size
    raises ``ValueError``; nothing moves to other devices."""
    num_data, num_model = parse_spec(spec)
    dev = init_distributed(device, backend)
    world = dist.get_world_size()
    if num_data * num_model != world:
        raise ValueError(_rank_message(spec, num_data * num_model, world))
    return Mesh(num_data, num_model, dev)
