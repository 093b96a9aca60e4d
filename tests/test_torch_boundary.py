"""The port's boundary: it imports nothing of JAX or of the JAX package, its
entry points (the trainer included) default to CUDA and raise without it,
and on CPU tensors the kernel wrappers take their plain versions without
counting a launch."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from acf_tpu_torch.data import Interactions
from acf_tpu_torch.eval import FullRankEvaluator
from acf_tpu_torch.models.mf import MFBPR
from acf_tpu_torch.ops.ranking import rank_positions_dot
from acf_tpu_torch.ops.topk import recommend
from tests.test_full_rank import make_data

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "acf_tpu")


def _forbidden(module: str) -> bool:
    """Exact name or a dotted child — ``acf_tpu_torch`` is not ``acf_tpu``."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return sorted((ROOT / "acf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_forbidden_matches_exact_names_and_children_only():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("acf_tpu.ops")
    assert _forbidden("acf_tpu")
    assert not _forbidden("acf_tpu_torch") and not _forbidden("acf_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, acf_tpu_torch, acf_tpu_torch.data, acf_tpu_torch.eval, "
            "acf_tpu_torch.models.mf, acf_tpu_torch.ops.topk, acf_tpu_torch.ops._build, "
            "acf_tpu_torch.compat.jax_params, acf_tpu_torch.train.checkpoint, "
            "acf_tpu_torch.nn.layers, acf_tpu_torch.models.sasrec, "
            "acf_tpu_torch.ops.sasrec_fused, acf_tpu_torch.sampling, acf_tpu_torch.train, "
            "acf_tpu_torch.train.trainer, acf_tpu_torch.train.optim, acf_tpu_torch.utils.io, "
            "acf_tpu_torch.utils.tree, acf_tpu_torch.models.apl, "
            "acf_tpu_torch.ops.apl_gen_fused, acf_tpu_torch.adversarial, "
            "acf_tpu_torch.adversarial.fgsm, acf_tpu_torch.adversarial.popularity, "
            "acf_tpu_torch.models.neumf, acf_tpu_torch.data.native_io, acf_tpu_torch.cli, "
            "acf_tpu_torch.cli.main, acf_tpu_torch.nn.rnn, acf_tpu_torch.models.gru4rec, "
            "acf_tpu_torch.models.dream, acf_tpu_torch.models.caser, "
            "acf_tpu_torch.models.drcf, acf_tpu_torch.models.dsin, "
            "acf_tpu_torch.ops.sparse_step, acf_tpu_torch.models.irgan, "
            "acf_tpu_torch.models.naive, acf_tpu_torch.data.process, "
            "acf_tpu_torch.compat.reference_checkpoints, acf_tpu_torch.parallel.mesh, "
            "acf_tpu_torch.parallel.input_pipeline, acf_tpu_torch.parallel.sharded_embedding, "
            "acf_tpu_torch.parallel.sharded_eval, acf_tpu_torch.parallel.sharded_serve, "
            "acf_tpu_torch.parallel.launch; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'acf_tpu', 'tensorflow', 'h5py')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tensorflow_and_h5py_only_inside_the_checkpoint_loaders():
    """The reference-checkpoint loaders import tensorflow and h5py inside
    their functions (the GPU machine has neither), and nothing else of the
    port, nor ``chip_smoke.py``, imports them or that module."""
    lazy = ("tensorflow", "h5py")
    loaders = ROOT / "acf_tpu_torch" / "compat" / "reference_checkpoints.py"
    tree = ast.parse(loaders.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not [a.name for n in top if isinstance(n, ast.Import) for a in n.names
                if a.name.split(".")[0] in lazy]
    assert {m.split(".")[0] for m in _imports(loaders)} >= set(lazy)
    for path in _port_files():
        if path != loaders:
            bad = [m for m in _imports(path) if m.split(".")[0] in lazy
                   or m == "acf_tpu_torch.compat.reference_checkpoints"]
            assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_precision_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _port_data():
    import dataclasses

    return Interactions(**dataclasses.asdict(make_data(seed=1)))


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    data = _port_data()
    model = MFBPR(data.num_users, data.num_items, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        FullRankEvaluator(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(torch.Generator().manual_seed(0))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        recommend(model, params, data, data.eval_users()[:3], k=2)
    # asking for the CPU works
    assert FullRankEvaluator(data, device="cpu").evaluate_model(model, params).auc.size
    assert recommend(model, params, data, data.eval_users()[:3], k=2,
                     device="cpu")[1].shape == (3, 2)


def test_parallel_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    import torch.distributed as dist

    from acf_tpu_torch.parallel import launch
    from acf_tpu_torch.parallel.mesh import init_distributed, make_mesh, mesh_from_spec

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    for entry in (init_distributed, make_mesh, lambda: mesh_from_spec("1x1")):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run("tests.torch_rank_cases:ping", 1, "1x1", timeout=60.0)
    got = launch.run("tests.torch_rank_cases:ping", 1, "1x1", "cpu", device="cpu",
                     timeout=60.0)
    np.testing.assert_array_equal(got[0], [0.0, 0.0])


def test_cpu_rank_counter_counts_no_launch():
    before = rank_positions_dot.launches
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    E = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    out = rank_positions_dot(u, E, t)
    assert out.shape == (4,) and out.dtype == torch.float32
    assert rank_positions_dot.launches == before == 0


def test_trainer_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from tests.test_torch_trainer import port_data, sasrec
    from acf_tpu_torch.train import TrainConfig, Trainer, adam

    data = port_data()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(sasrec(data), data, adam(1e-3), TrainConfig(batch_size=16))
    tr = Trainer(sasrec(data), data, adam(1e-3), TrainConfig(batch_size=16, device="cpu"))
    assert tr.params["item_emb"].device.type == "cpu" and tr.generator.device.type == "cpu"


def test_cpu_encoder_training_counts_no_launch():
    """A CPU training step (forward and backward of the encoder) takes the
    plain versions: neither K2a's nor K2b's counter moves."""
    from acf_tpu_torch.ops.sasrec_fused import encoder_bwd, fused_encoder
    from tests.test_torch_trainer import config, port_data, sasrec
    from acf_tpu_torch.train import Trainer, adam

    data = port_data()
    before = (fused_encoder.launches, encoder_bwd.launches)
    tr = Trainer(sasrec(data, adversarial=True), data, adam(1e-3), config())
    tr.run_epoch()
    assert (fused_encoder.launches, encoder_bwd.launches) == before == (0, 0)


def test_pair_and_apl_trainers_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from acf_tpu_torch.models.apl import APL
    from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, sgd

    from acf_tpu_torch.adversarial import FGSMAdversarial

    data = _port_data()
    U, I = data.num_users, data.num_items
    for model, opt in ((MFBPR(U, I, 4), adagrad(0.1)), (APL(U, I, 4), sgd(0.05)),
                       (MFBPR(U, I, 4, adversarial=True), adagrad(0.1)),
                       (FGSMAdversarial(U, I, 4, base=MFBPR(U, I, 4)), adagrad(0.1))):
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(model, data, opt, TrainConfig(batch_size=16))
        tr = Trainer(model, data, opt, TrainConfig(batch_size=16, device="cpu"))
        assert tr.dev["pairs_u"].device.type == "cpu"


def test_sparse_irgan_and_naive_entry_points_need_cuda_unless_cpu_is_asked():
    """The sparse step's, IRGAN's and the naive baselines' trainers and
    params default to CUDA and raise without it; asked for the CPU, an
    epoch and an evaluation run there with no launch of K1 (its plain
    version for SparseMFBPR and IRGAN, the dense path for the naive ones)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from acf_tpu_torch.models.irgan import IRGAN
    from acf_tpu_torch.models.naive import MostPopular
    from acf_tpu_torch.ops.sparse_step import SparseMFBPR
    from acf_tpu_torch.train import TrainConfig, Trainer, adagrad

    data = _port_data()
    U, I = data.num_users, data.num_items
    for model in (SparseMFBPR(U, I, 4, adversarial=True), IRGAN(U, I, 4),
                  MostPopular(U, I, 4, data=data)):
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(model, data, adagrad(0.1), TrainConfig(batch_size=16))
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_params(torch.Generator().manual_seed(0))
        tr = Trainer(model, data, adagrad(0.1), TrainConfig(batch_size=16, verbose=10 ** 9,
                                                            device="cpu"))
        assert np.isfinite(tr.run_epoch()["loss"])
        assert tr.evaluate().auc.size == len(data.eval_users())
    assert rank_positions_dot.launches == 0


def test_cpu_apl_step_counts_no_launch():
    """A CPU APL epoch (critic and generator steps) runs the plain versions
    of K3a-K3e: no K3 counter moves, nor K1's in its evaluation."""
    from acf_tpu_torch.models.apl import APL
    from acf_tpu_torch.ops.apl_gen_fused import KERNELS
    from acf_tpu_torch.train import TrainConfig, Trainer, sgd

    data = _port_data()
    before = [k.launches for k in KERNELS] + [rank_positions_dot.launches]
    tr = Trainer(APL(data.num_users, data.num_items, 4), data, sgd(0.05),
                 TrainConfig(batch_size=16, verbose=10 ** 9, device="cpu"))
    stats = tr.run_epoch()
    tr.evaluate()
    assert np.isfinite(stats["loss"]) and tr.num_batches >= 1
    assert [k.launches for k in KERNELS] + [rank_positions_dot.launches] == before == [0] * 6


def test_zoo_entry_points_need_cuda_unless_cpu_is_asked():
    """The sequence zoo's trainers (Caser's own epoch, the FGSM wrapper
    around it), its session stream and its params default to CUDA and
    raise without it; asked for the CPU, an epoch and an evaluation run
    there with no kernel launch (K1's plain version for the factored
    models, the dense path for DRCF and DSIN)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from acf_tpu_torch.adversarial import FGSMAdversarial
    from acf_tpu_torch.models.caser import Caser
    from acf_tpu_torch.models.dream import DREAM
    from acf_tpu_torch.models.drcf import DRCF
    from acf_tpu_torch.models.dsin import DSIN
    from acf_tpu_torch.models.gru4rec import GRU4Rec
    from acf_tpu_torch.ops.topk import SessionStream
    from acf_tpu_torch.train import TrainConfig, Trainer, adam

    data = _port_data()
    U, I = data.num_users, data.num_items
    models = [GRU4Rec(U, I, 4, maxlen=3), DREAM(U, I, 4, maxlen=3), Caser(U, I, 4, maxlen=3),
              DRCF(U, I, 4, maxlen=3), DSIN(U, I, 4, sess_count=2, sess_len=2),
              FGSMAdversarial(U, I, 4, base=Caser(U, I, 4, maxlen=3))]
    for model in models:
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(model, data, adam(1e-3), TrainConfig(batch_size=16))
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_params(torch.Generator().manual_seed(0))
        tr = Trainer(model, data, adam(1e-3), TrainConfig(batch_size=16, verbose=10 ** 9,
                                                          device="cpu"))
        assert np.isfinite(tr.run_epoch()["loss"])
        assert tr.evaluate().auc.size == len(data.eval_users())
    with pytest.raises(RuntimeError, match="CUDA"):
        SessionStream(models[0], tr.params, batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        models[0].init_state(2)
    assert rank_positions_dot.launches == 0
