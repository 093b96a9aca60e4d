"""Snapshots of param trees and full train states (counterpart of
``acf_tpu/train/checkpoint.py``), in two backends:

* ``npz`` (default): one ``.npz`` of the flattened tree keyed by the
  '/'-joined leaf path — the JAX package's ``path_name`` scheme (``"P"``,
  ``"Q"`` for MF; ``"a/0"`` for a list under key ``a``) — so a file written
  by either package loads in the other. A sharded trainer gathers its
  leaves whole and rank 0 writes.
* ``dcp``: a ``torch.distributed.checkpoint`` directory. Each rank writes
  its own rows: a leaf stored as a row shard goes in as a ``DTensor``
  (``Shard(0)`` over "model", replicated over "data") of the leaf's global
  shape without the padding, whose uneven split is the layout's ceil(R/m)
  with a short last shard; whole leaves are replicated and written once.
  The leaves are copied to the host first and DCP runs over gloo groups of
  its own (:meth:`acf_tpu_torch.parallel.mesh.Mesh.host_groups`), which
  serves a NCCL mesh too. A restore reads the rows of its own layout, from
  a directory written on any mesh or on one device.
  :class:`AsyncSnapshotter` writes in the background: the copy to the host
  happens at once, the write overlaps training, and :meth:`wait` raises
  what it raised (a failed save never falls back to npz).

The JAX package's third backend, ``"orbax"``, is not ported: reading or
writing an orbax directory needs JAX. ``ckpt_backend="orbax"`` raises
``ValueError`` naming ``"dcp"``.

A full train state (:func:`save_state`) holds ``params/…``, the optimizer
slots under the names optax's chained state takes in the JAX package's
snapshots (Adam's ``opt/0/.count``, ``opt/0/.mu/…``, ``opt/0/.nu/…``;
Adagrad's ``opt/0/.sum_of_squares/…``; SGD has none; a per-player state
such as APL's under ``opt/g/…`` and ``opt/c/…``; the sparse step's slots as
``opt/accP`` and ``opt/accQ``), and ``rng``, the trainer's
``torch.Generator`` state (the JAX snapshots hold a ``key`` instead, which
the port cannot use: restoring one keeps the current generator). A
``dcp`` directory holds the same names.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from acf_tpu_torch.compat.jax_params import is_opt_fields
from acf_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _flatten_with_names(tree, prefix=()):
    """[(name, leaf)] for every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, sub in items:
        out.extend(_flatten_with_names(sub, prefix + (key,)))
    return out


BACKENDS = ("npz", "dcp")


def check_backend(backend: str) -> str:
    """``backend`` if the port writes it, else ``ValueError``."""
    if backend not in BACKENDS:
        raise ValueError(f"checkpoint backend {backend!r}: the port writes 'npz' or 'dcp' "
                         "(torch.distributed.checkpoint directories, sharded and "
                         "asynchronous); orbax directories need JAX")
    return backend


def is_dcp(path: str) -> bool:
    """A directory is a ``dcp`` snapshot; a file (its ``.npz`` suffix
    optional) an npz one."""
    return os.path.isdir(path)


def save_params(path: str, params, backend: str = "npz") -> None:
    """A param tree of whole leaves, as an npz file or a ``dcp`` directory
    (one process)."""
    if check_backend(backend) == "dcp":
        _dcp_save(path, _dcp_state(_flatten_with_names(params), None, None), None)
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{name: leaf.detach().cpu().numpy()
                      for name, leaf in _flatten_with_names(params)})


def load_params(path: str, like, backend: str = "auto"):
    """Load into the structure of ``like`` (names must match); each leaf
    takes the dtype and device of its counterpart in ``like``.
    ``backend="auto"``: a directory is ``dcp``, a file npz."""
    if backend == "auto":
        backend = "dcp" if is_dcp(path) else "npz"
    if check_backend(backend) == "dcp":
        entries = _flatten_with_names(like)
        loaded = _dcp_load(path, entries, None, None)
        return tree_unflatten(like, loaded)
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        def load(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: load(v, prefix + (str(k),)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(load(v, prefix + (str(i),))
                                  for i, v in enumerate(tree))
            name = "/".join(prefix)
            arr = data[name]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"{path}: {name} has shape {arr.shape}, "
                                 f"expected {tuple(tree.shape)}")
            return torch.as_tensor(arr).to(device=tree.device, dtype=tree.dtype)

        return load(like)


def _opt_names(opt_state, prefix="opt/"):
    """[(npz name, leaf)] of an optimizer state: the first chained state's
    fields under ``<prefix>0/.<field>``; per-player states under
    ``<prefix><player>/``; a model's own slot tensor (SparseMFBPR's
    ``accP``) under its key; nothing for a model without a state (the
    naive baselines' ``()``)."""
    if isinstance(opt_state, torch.Tensor):
        return [(prefix[:-1], opt_state)]
    if not isinstance(opt_state, dict):
        return []
    if not is_opt_fields(opt_state):
        return [x for k, v in opt_state.items() for x in _opt_names(v, f"{prefix}{k}/")]
    return [(f"{prefix}0/.{field}" + (f"/{n}" if n else ""), leaf)
            for field, tree in opt_state.items() for n, leaf in _flatten_with_names(tree)]


def state_entries(params, opt_state, rng_state=None):
    """[(name, tensor)] of a full train state, in the order of the params'
    and then the slots' leaves, named as :func:`save_state` writes them."""
    out = [(f"params/{n}", leaf) for n, leaf in _flatten_with_names(params)]
    out += _opt_names(opt_state)
    if rng_state is not None:
        out.append(("rng", rng_state))
    return out


def state_arrays(params, opt_state, rng_state=None):
    """The npz arrays of a full train state, keyed as :func:`save_state`
    writes them."""
    return {n: leaf.detach().cpu().numpy()
            for n, leaf in state_entries(params, opt_state, rng_state)}


def save_state(path: str, params, opt_state, rng_state=None) -> None:
    """Params, optimizer slots and (optionally) the generator state in one
    npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **state_arrays(params, opt_state, rng_state))


def _load_tree(data, like, prefix, path):
    def load(tree, names=()):
        if isinstance(tree, dict):
            return {k: load(v, names + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(load(v, names + (str(i),)) for i, v in enumerate(tree))
        name = prefix + "/".join(names)
        arr = data[name]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"{path}: {name} has shape {arr.shape}, "
                             f"expected {tuple(tree.shape)}")
        return torch.as_tensor(arr).to(device=tree.device, dtype=tree.dtype)

    return load(like)


def load_state(path: str, params_like, opt_like):
    """(params, opt_state, rng_state or None) from a :func:`save_state` file
    or a JAX package snapshot, into the structures, dtypes and devices of
    the ``*_like`` trees."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        params = _load_tree(data, params_like, "params/", path)
        leaves = []
        for name, like in _opt_names(opt_like):
            arr = data[name]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{path}: {name} has shape {arr.shape}, "
                                 f"expected {tuple(like.shape)}")
            leaves.append(torch.as_tensor(arr).to(device=like.device, dtype=like.dtype))
        opt = tree_unflatten(opt_like, leaves)
        rng = torch.as_tensor(data["rng"]) if "rng" in data.files else None
    return params, opt, rng


# -- the "dcp" backend -------------------------------------------------------


def _state_rows(params, opt_state, layout, rng=True):
    """The global row count (or None) of each :func:`state_entries` entry
    under ``layout``, the Layout of the tree (params, opt_state) (None:
    every leaf whole)."""
    if layout is None:
        return [None] * (len(tree_leaves(params)) + len(tree_leaves(opt_state)) + int(rng))
    return tree_leaves(layout.rows) + [None] * int(rng)


def _device_mesh(mesh):
    """The 2-D ("data", "model") CPU ``DeviceMesh`` over the mesh's gloo
    host groups, made once."""
    host = mesh.host_groups()
    if "device_mesh" not in host:
        from torch.distributed.device_mesh import DeviceMesh

        dp, m = mesh.shape["data"], mesh.shape["model"]
        host["device_mesh"] = DeviceMesh.from_group(
            [host["data"], host["model"]], "cpu", mesh=torch.arange(dp * m).reshape(dp, m),
            mesh_dim_names=("data", "model"))
    return host["device_mesh"]


def _local_real(mesh, i_local: int, rows: int) -> int:
    """The rows of this model rank's shard that lie inside the leaf."""
    return max(min(i_local, rows - mesh.model_index * i_local), 0)


def _dcp_value(x, rows, mesh):
    """The host copy of a stored leaf for DCP: a ``DTensor`` of the leaf's
    global shape for a row shard (its real rows), else the tensor."""
    if rows is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    shape = (rows,) + tuple(x.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    local = x[:_local_real(mesh, x.shape[0], rows)]
    return DTensor.from_local(local, _device_mesh(mesh), [Replicate(), Shard(0)],
                              shape=torch.Size(shape), stride=stride)


def _dcp_state(entries, rows, mesh):
    """{name: value} of ``entries`` copied to the host now (what a write in
    the background reads), each row shard as a ``DTensor``."""
    rows = rows or [None] * len(entries)
    return {name: _dcp_value(x.detach().to("cpu", copy=True), r, mesh)
            for (name, x), r in zip(entries, rows)}


def _dcp_group(mesh):
    return None if mesh is None else mesh.host_groups()["world"]


def _dcp_save(path, state, mesh, asynchronous=False):
    import torch.distributed.checkpoint as dcp

    kw = dict(checkpoint_id=os.path.abspath(path), process_group=_dcp_group(mesh),
              no_dist=mesh is None)
    if asynchronous:
        return dcp.async_save(state, **kw)
    dcp.save(state, **kw)
    return None


def _dcp_load(path, entries, rows, mesh):
    """The tensors of ``entries`` (name, stored leaf) read from the ``dcp``
    directory ``path``: each sharded leaf's rows of this rank (padded with
    zero rows as stored), each whole leaf whole; on the leaves' devices and
    dtypes."""
    import torch.distributed.checkpoint as dcp

    rows = rows or [None] * len(entries)
    target = {}
    for (name, x), r in zip(entries, rows):
        host = torch.empty(tuple(x.shape), dtype=x.dtype, device="cpu")
        target[name] = _dcp_value(host, r, mesh)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no dcp snapshot")
    dcp.load(target, checkpoint_id=os.path.abspath(path), process_group=_dcp_group(mesh),
             no_dist=mesh is None)
    out = []
    for (name, x), r in zip(entries, rows):
        got = target[name]
        if r is not None:
            local = got.to_local()
            got = torch.zeros(tuple(x.shape), dtype=x.dtype)
            got[:local.shape[0]] = local
        out.append(got.to(device=x.device, dtype=x.dtype))
    return out


def save_state_dcp(path: str, params, opt_state, rng_state, mesh=None, layout=None):
    """A full train state as a ``dcp`` directory in which each rank writes
    its own rows (``layout`` the :class:`~acf_tpu_torch.parallel.mesh.Layout`
    of the tree (params, opt_state), None for whole leaves); every rank of
    ``mesh`` calls it."""
    entries = state_entries(params, opt_state, rng_state)
    _dcp_save(path, _dcp_state(entries, _state_rows(params, opt_state, layout), mesh), mesh)


def load_state_dcp(path: str, params_like, opt_like, rng_like=None, mesh=None, layout=None):
    """(params, opt_state, rng_state or None) from a ``dcp`` directory,
    stored as the ``*_like`` trees are (this rank's rows of each sharded
    leaf); ``rng_like`` the generator state whose size to read."""
    entries = state_entries(params_like, opt_like, rng_like)
    rows = _state_rows(params_like, opt_like, layout, rng=rng_like is not None)
    leaves = _dcp_load(path, entries, rows, mesh)
    n_p = len(_flatten_with_names(params_like))
    n_o = len(_opt_names(opt_like))
    params = tree_unflatten(params_like, leaves[:n_p])
    opt = tree_unflatten(opt_like, leaves[n_p:n_p + n_o])
    return params, opt, (leaves[-1] if rng_like is not None else None)


class AsyncSnapshotter:
    """Snapshots written in the background (the counterpart of the JAX
    package's orbax ``AsyncCheckpointer``): :meth:`save` copies the tree to
    the host at once and writes the ``dcp`` directory while training
    continues; the next save waits for the one before. Call :meth:`wait`
    (or use it as a context manager) before reading the files or exiting:
    it raises what a write raised. Every rank of ``mesh`` calls each
    method."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self._future = None

    def save(self, path: str, tree) -> None:
        """A tree of whole leaves (the names of :func:`save_params`)."""
        self._start(path, _dcp_state(_flatten_with_names(tree), None, None))

    def save_state(self, path: str, params, opt_state, rng_state, layout=None) -> None:
        """A full train state, as :func:`save_state_dcp` writes it."""
        entries = state_entries(params, opt_state, rng_state)
        self._start(path, _dcp_state(entries, _state_rows(params, opt_state, layout),
                                     self.mesh))

    def _start(self, path, state):
        self.wait()
        self._future = _dcp_save(path, state, self.mesh, asynchronous=True)

    def wait(self) -> None:
        future, self._future = self._future, None
        if future is not None:
            future.result()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
