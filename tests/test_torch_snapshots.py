"""The port's ``"dcp"`` snapshots (``torch.distributed.checkpoint``
directories), ported from ``tests/test_checkpoint_orbax.py``: a full-state
roundtrip and a bit-exact resume on one device, a plain tree, overlapped
saves in the background, periodic snapshots from ``fit``, the context
manager, ``"orbax"`` refused, and restores across topologies on CPU ranks:
a 2x2 save with row-sharded tables (``shard_min_rows=2``; Q's 37 rows do
not divide 2, so its last shard is padded) restored onto 2x2 (params, slots
and the generator state bit for bit, and two more epochs bit for bit), onto
one device and onto 1x2, and a one-device save restored onto 2x2, with
every user's HR and NDCG equal each way.

Every comparison is exact: a snapshot moves bits, and the evaluations of
one set of params on one device and on a mesh give the same positions
(``tests/test_torch_parallel.py``).
"""

import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.distributed.checkpoint import CheckpointException

from acf_tpu_torch.data import Interactions
from acf_tpu_torch.models.mf import MFBPR
from acf_tpu_torch.parallel import launch
from acf_tpu_torch.train import TrainConfig, Trainer, adagrad
from acf_tpu_torch.train.checkpoint import AsyncSnapshotter, load_params, save_params
from tests import torch_rank_cases as rank_cases
from tests.test_trainer import synthetic_data

CASES = "tests.torch_rank_cases"
TIMEOUT = 180.0
APR = dict(adversarial=True, eps=0.5, reg_adv=1.0)


def trees_equal(a, b):
    from acf_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def data_of(seed):
    return Interactions(**dataclasses.asdict(synthetic_data(seed=seed)))


def trainer(data, model=None, **cfg):
    model = model or MFBPR(data.num_users, data.num_items, 8, **APR)
    return Trainer(model, data, adagrad(0.05, initial_accumulator_value=0.1),
                   TrainConfig(batch_size=32, verbose=10 ** 9, device="cpu",
                               ckpt_backend="dcp", **cfg))


def test_dcp_roundtrip_and_resume(tmp_path):
    data = data_of(4)
    a = trainer(data)
    a.run_epoch()
    ck = str(tmp_path / "state")
    a.save_checkpoint(ck)
    assert os.path.isdir(ck)
    b = trainer(data)
    b.restore_checkpoint(ck)
    trees_equal(b.params, a.params)
    trees_equal(b.opt_state, a.opt_state)
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    for _ in range(2):  # bit-exact resume
        a.run_epoch()
        b.run_epoch()
    trees_equal(a.params, b.params)
    trees_equal(a.opt_state, b.opt_state)


def test_dcp_save_params_plain_tree(tmp_path):
    tree = {"P": torch.arange(6.0).reshape(2, 3), "nested": {"h": torch.ones(4)},
            "l": [torch.zeros(2, dtype=torch.int32)]}
    p = str(tmp_path / "plain")
    save_params(p, tree, backend="dcp")
    like = {"P": torch.empty(2, 3), "nested": {"h": torch.empty(4)},
            "l": [torch.empty(2, dtype=torch.int32)]}
    trees_equal(load_params(p, like), tree)  # a directory: auto-detected


def test_async_snapshots_overlap_training(tmp_path):
    data = data_of(5)
    tr = trainer(data, MFBPR(data.num_users, data.num_items, 8))
    tr.run_epoch()
    # a save in the background, then training goes on while it is written
    tr.save_checkpoint(str(tmp_path / "snap"), blocking=False)
    saved = {k: v.clone() for k, v in tr.params.items()}
    tr.run_epoch()
    tr.save_checkpoint(str(tmp_path / "snap2"), blocking=False)  # waits for the first
    after = {k: v.clone() for k, v in tr.params.items()}
    tr.run_epoch()
    tr.wait_snapshots()
    like = {k: torch.empty_like(v) for k, v in tr.params.items()}
    # each snapshot holds the state at its save, not the one after
    trees_equal(load_params(str(tmp_path / "snap"), {"params": like})["params"], saved)
    trees_equal(load_params(str(tmp_path / "snap2"), {"params": like})["params"], after)


def test_fit_writes_periodic_dcp_snapshots(tmp_path):
    data = data_of(6)
    tr = trainer(data, MFBPR(data.num_users, data.num_items, 8), epochs=4, ckpt_every=2,
                 ckpt_path=str(tmp_path / "ck"))
    tr.fit()
    assert (tmp_path / "ck-0").is_dir() and (tmp_path / "ck-2").is_dir()
    assert not (tmp_path / "ck-1").exists()
    b = trainer(data, MFBPR(data.num_users, data.num_items, 8))
    b.restore_checkpoint(str(tmp_path / "ck-2"))  # fit waited for the last write
    c = trainer(data, MFBPR(data.num_users, data.num_items, 8))
    c.run_epochs(3)
    trees_equal(b.params, c.params)


def test_async_snapshotter_context_manager(tmp_path):
    tree = {"x": torch.full((3,), 7.0)}
    with AsyncSnapshotter() as snap:
        snap.save(str(tmp_path / "cm"), tree)
    trees_equal(load_params(str(tmp_path / "cm"), {"x": torch.empty(3)}), tree)


def test_orbax_backend_is_refused(tmp_path):
    data = data_of(4)
    with pytest.raises(ValueError, match="dcp"):
        Trainer(MFBPR(data.num_users, data.num_items, 8), data, adagrad(0.05),
                TrainConfig(device="cpu", ckpt_backend="orbax"))
    with pytest.raises(ValueError, match="dcp"):
        save_params(str(tmp_path / "o"), {"x": torch.ones(1)}, backend="orbax")


def test_a_failed_save_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with pytest.raises(CheckpointException, match="Not a directory"):
        save_params(str(blocker / "under"), {"x": torch.ones(1)}, backend="dcp")
    assert not (tmp_path / "file" / "under.npz").exists()


@pytest.fixture(scope="module")
def topologies(tmp_path_factory):
    """A 2x2 trainer's snapshot after an epoch restored onto 2x2 (then two
    more epochs each), onto 1x2 and onto one device, and a one-device
    snapshot restored onto 2x2, in two launches at once (the 1x2 ranks wait
    for the 2x2 save)."""
    root = tmp_path_factory.mktemp("topo")
    data = data_of(7)
    model = MFBPR(data.num_users, data.num_items, 8, **APR)
    opt = adagrad(0.05, initial_accumulator_value=0.1)
    mesh_ck, flat_ck = str(root / "mesh_state"), str(root / "flat_state")
    flat = rank_cases.snapshots(None, "cpu", model, opt, data,
                                [("epoch",), ("save", flat_ck), ("state",), ("eval",)])
    mesh_cases = [
        ("snapshots", (model, opt, data, [("epoch",), ("save", mesh_ck), ("state",), ("eval",),
                                          ("epoch",), ("epoch",), ("state",)])),
        ("snapshots", (model, opt, data, [("restore", mesh_ck), ("state",), ("epoch",),
                                          ("epoch",), ("state",)])),
        ("snapshots", (model, opt, data, [("restore", flat_ck), ("state",), ("eval",)])),
    ]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # 1x2 waits for the 2x2 save
        two = pool.submit(launch.run, f"{CASES}:several", 2, "1x2", "cpu", [
            ("snapshots", (model, opt, data, [("await", mesh_ck, TIMEOUT), ("restore", mesh_ck),
                                              ("state",), ("eval",)]))],
            device="cpu", timeout=TIMEOUT)
        four = launch.run(f"{CASES}:several", 4, "2x2", "cpu", mesh_cases, device="cpu",
                          timeout=TIMEOUT)
        two = two.result()
    one = rank_cases.snapshots(None, "cpu", model, opt, data,
                               [("restore", mesh_ck), ("state",), ("eval",)])
    return flat, four, two, one


def test_mesh_snapshot_restores_across_topologies(topologies):
    _, four, two, one = topologies
    saved, ref, _ = four[0][0]
    assert saved["sharded"]
    for r, res in enumerate(four):
        mesh_run, same, _ = res
        # (a) same mesh: params, slots and the generator state, then two
        # more epochs, bit for bit
        restored, resumed = same
        assert restored["sharded"]
        for k, w in mesh_run[0]["state"].items():
            np.testing.assert_array_equal(restored["state"][k], w, err_msg=f"rank {r} {k}")
        for k, w in mesh_run[2]["state"].items():
            np.testing.assert_array_equal(resumed["state"][k], w, err_msg=f"rank {r} {k}")
    # (b) onto 1x2 and (c) onto one device: the same state, every user's HR
    # and NDCG equal
    for (restored, res), sharded in [(two[0][0], True), (two[1][0], True), (one, False)]:
        assert restored["sharded"] == sharded
        for k, w in saved["state"].items():
            np.testing.assert_array_equal(restored["state"][k], w, err_msg=k)
        np.testing.assert_array_equal(res["hr"], ref["hr"])
        np.testing.assert_array_equal(res["ndcg"], ref["ndcg"])


def test_single_device_snapshot_restores_onto_a_mesh(topologies):
    flat, four, _, _ = topologies
    saved, ref = flat
    assert not saved["sharded"]
    for r, res in enumerate(four):
        restored, ev = res[2]
        assert restored["sharded"]
        for k, w in saved["state"].items():
            np.testing.assert_array_equal(restored["state"][k], w, err_msg=f"rank {r} {k}")
        np.testing.assert_array_equal(ev["hr"], ref["hr"])
        np.testing.assert_array_equal(ev["ndcg"], ref["ndcg"])
