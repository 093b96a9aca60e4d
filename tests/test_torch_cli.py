"""The port's command line (``acf_tpu_torch/cli/main.py``) on the CPU
(``--device cpu``, the bundled ``data/brightkite.txt`` as ``--data test``,
d = 8), against the JAX package's (``acf_tpu/cli/main.py``): ``make_model``
builds the same classes with the same hyperparameters and optimizers for
the same command line; the runs of ``tests/test_cli.py`` write the JAX CLI's files in its format;
the combinations the JAX CLI refuses exit with its messages; ``--train_dtype
bfloat16`` trains SASRec's family and is ignored by the other models.

Optimizers are compared by what they do: three updates of the same params
by the same gradients, to rtol 1e-5 (the port's Adagrad differs from
optax's by an ulp on the CPU, ``tests/test_torch_optim.py``)."""

import dataclasses
import os
import re

import numpy as np
import optax
import pytest
import torch

from acf_tpu.cli.main import build_parser as jax_build_parser
from acf_tpu.cli.main import main as jax_main
from acf_tpu.cli.main import make_model as jax_make_model
from acf_tpu.data import load_dataset as jax_load_dataset
from acf_tpu.train import TrainConfig as JaxConfig
from acf_tpu.train import Trainer as JaxTrainer
from acf_tpu.train.checkpoint import save_params as jax_save_params
from acf_tpu_torch.cli import main as cli
from acf_tpu_torch.data import load_dataset
from acf_tpu_torch.ops.ranking import rank_positions_dot

ARGS = ["--data", "test", "--path", "data/", "--epochs", "2", "--d", "8", "--bs", "64",
        "--maxlen", "5", "--device", "cpu"]
# fields of the JAX dataclasses that only configure TPU code paths
TPU_ONLY_FIELDS = {"fused", "pack_attention", "manual_gen", "fused_gen"}
# fields of JAX dataclasses that nothing reads (DSIN's attention is
# single-head whatever its num_heads)
UNREAD_FIELDS = {"DSIN": {"num_heads"}}
TWO_PHASE = ("apr", "asasrec", "asasrec2")


@pytest.fixture(scope="module")
def datasets():
    return load_dataset("test", "data/"), jax_load_dataset("test", "data/")


def run(tmp_path, *argv, sub=""):
    """The port's CLI on ``ARGS`` + ``argv``; returns (best, the .out lines)."""
    opath = str(tmp_path / sub) + "/"
    best = cli.main(ARGS + list(argv) + ["--opath", opath])
    outs = [f for f in os.listdir(opath) if f.endswith(".out")]
    assert len(outs) == 1, outs
    return best, (tmp_path / sub / outs[0]).read_text().splitlines()


def same_fields(port, ref, path="model"):
    assert type(port).__name__ == type(ref).__name__, path
    ours = {f.name for f in dataclasses.fields(port)}
    theirs = {f.name for f in dataclasses.fields(ref)}
    unread = UNREAD_FIELDS.get(type(ref).__name__, set())
    assert ours <= theirs and theirs - ours <= TPU_ONLY_FIELDS | unread, (path, theirs ^ ours)
    for name in ours:
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(a):
            same_fields(a, b, f"{path}.{name}")
        elif isinstance(a, np.ndarray):  # the naive baselines' dataset
            np.testing.assert_array_equal(a, b, err_msg=f"{path}.{name}")
        else:
            assert a == b, (path, name, a, b)


def same_updates(port_opt, jax_opt):
    """Three updates of one param tree by random gradients agree."""
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    tp = {"w": torch.from_numpy(p["w"].copy())}
    ts, js, jp = port_opt.init(tp), jax_opt.init(p), p
    for _ in range(3):
        g = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
        tp, ts = port_opt.update({"w": torch.from_numpy(g["w"])}, ts, tp)
        up, js = jax_opt.update(g, js, jp)
        jp = optax.apply_updates(jp, up)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-5, atol=1e-7)


MAKE_CASES = [(name, []) for name in cli.PORTED_MODELS] + [
    ("bpr", ["--lr", "0.1", "--reg", "0.01", "--dns", "3"]),
    ("apr", ["--adv", "random", "--eps", "0.3", "--reg_adv", "2", "--adv_steps", "2",
             "--dns", "2", "--lr", "0.05"]),
    ("amf", ["--w", "0.05", "--pp", "0.3"]),
    ("aneumf", ["--w", "0.01", "--pp", "0.1"]),
    ("asasrec2", ["--eps_pos", "0.1", "--eps_dense", "0.2", "--eps_conv", "0.3",
                  "--maxlen", "7", "--adv_steps", "3"]),
    ("sasrec", ["--train_dtype", "bfloat16"]),
    ("asasrec", ["--train_dtype", "bfloat16"]),
    ("apl", ["--loss", "wgan"]),
    ("apl", ["--d", "50"]),
    ("gru4rec", ["--loss", "top1", "--final_act", "relu", "--hidden_act", "relu"]),
    ("caser", ["--maxlen", "7"]),
    ("dsin", ["--sess_count", "2", "--sess_len", "3", "--dsin_bi", "--loss", "bpr"]),
    ("dsin", ["--lr", "0.01"]),
    ("irgan", ["--irgan_pair"]),
    ("apr", ["--sparse"]),
    ("apr", ["--sparse", "--eps", "0.3", "--reg_adv", "2", "--reg", "0.01", "--lr", "0.1",
             "--dedup", "matmul"]),
    ("bpr", ["--sparse", "--dedup", "sort"]),
    ("bpr-tf", ["--sparse", "--reg", "0.01"]),
]


@pytest.mark.parametrize("name,extra", MAKE_CASES,
                         ids=[f"{n}{'-' + e[0] if e else ''}" for n, e in MAKE_CASES])
def test_make_model_agrees_with_the_jax_cli(datasets, name, extra):
    """For every model the port accepts, and flag variants: the model's
    class and every hyperparameter field (the wrapped base's too), the
    clean phase-1 model, and the optimizer's updates."""
    argv = ["--model", name] + extra
    args = cli.build_parser().parse_args(ARGS + argv)
    jargs = jax_build_parser().parse_args(ARGS[:-2] + argv)
    port, jax_out = cli.make_model(name, datasets[0], args), jax_make_model(name, datasets[1],
                                                                           jargs)
    same_fields(port[0], jax_out[0])
    assert (port[2] is None) == (jax_out[2] is None) == (name not in TWO_PHASE)
    if port[2] is not None:
        same_fields(port[2], jax_out[2], "clean")
    same_updates(port[1], jax_out[1])


def test_parser_takes_every_jax_flag():
    """The flag union of the JAX CLI, unchanged, plus ``--device``: every
    option string and its default."""
    ours, theirs = cli.build_parser(), jax_build_parser()
    opts = {o: a for a in ours._actions for o in a.option_strings}
    for action in theirs._actions:
        for o in action.option_strings:
            assert o in opts, o
            assert opts[o].default == action.default and opts[o].dest == action.dest, o
    assert opts["--device"].default == "cuda"
    assert set(opts) - {o for a in theirs._actions for o in a.option_strings} == {"--device"}


def test_apr_run_writes_the_jax_cli_files_and_lines(tmp_path):
    """The acceptance run (APR two-phase, 2 epochs): ``.out``/``.hr``/``.ndcg``
    files as the JAX CLI writes them, the same ``Load data done`` line, and
    every line of the same form (numbers aside) in the same order."""
    argv = ["--model", "apr", "--adv_epoch", "1"]
    best, lines = run(tmp_path, *argv, sub="port")
    assert np.isfinite(best["ndcg"]) and rank_positions_dot.launches == 0
    outs = sorted(f.rsplit(".", 1)[1] for f in os.listdir(tmp_path / "port"))
    assert outs == ["hr", "ndcg", "out"]
    from acf_tpu.cli.main import main as jax_main

    jax_main(ARGS[:-2] + argv + ["--opath", str(tmp_path / "jax") + "/"])
    jout = [f for f in os.listdir(tmp_path / "jax") if f.endswith(".out")][0]
    jlines = (tmp_path / "jax" / jout).read_text().splitlines()
    assert lines[0] == jlines[0] == "Load data done. #user=401, #item=865, #train=4987, #test=400"

    def form(line):
        return re.sub(r"-?\d+(\.\d+)?", "#", line)

    assert [form(x) for x in lines] == [form(x) for x in jlines]
    assert lines[-1].startswith("End. Best Iteration ")
    assert sum(x.startswith("K = ") for x in lines) == 100
    hr = np.loadtxt(tmp_path / "port" / [f for f in os.listdir(tmp_path / "port")
                                         if f.endswith(".hr")][0])
    assert hr.shape == (400,)


@pytest.mark.parametrize("name", [m for m in cli.PORTED_MODELS if m != "apr"])
def test_every_model_trains_through_the_cli(tmp_path, name):
    """One epoch of each model the port accepts (two-phase models one clean
    and one adversarial), an evaluation after each, the K sweep and the
    ``End.`` line."""
    extra = ["--adv_epoch", "1"] if name in TWO_PHASE else ["--epochs", "1"]
    best, lines = run(tmp_path, "--model", name, *extra)
    assert np.isfinite(best["ndcg"]) and best["epoch"] >= 0
    epochs = [x for x in lines if x.startswith("Epoch ") and "HR =" in x]
    assert len(epochs) == (2 if name in TWO_PHASE else 1)
    assert lines[-1].startswith("End. Best Iteration")


def test_sampled_eval(tmp_path):
    best, lines = run(tmp_path, "--model", "bpr", "--eval_mode", "sample")
    assert np.isfinite(best["ndcg"])
    assert sum(x.startswith("K = ") for x in lines) == 10  # K = 1..10 in sampled mode


def test_checkpoint_restore_resume(tmp_path):
    """Periodic full-state snapshots and ``--restore`` resume (reference
    --restore semantics, run_adv.py:97-120)."""
    ck = str(tmp_path / "ck")
    run(tmp_path, "--model", "bpr", "--ckpt", "1", "--ckpt_dir", ck, sub="a")
    assert os.path.exists(f"{ck}/test/bpr-1.npz")
    best, lines = run(tmp_path, "--model", "bpr", "--epochs", "3", "--restore",
                      f"{ck}/test/bpr-1", "--restore_epoch", "2", sub="b")
    assert np.isfinite(best["ndcg"]) and best["epoch"] == 2
    assert [x.split()[1] for x in lines if x.startswith("Epoch ") and "HR =" in x] == ["2"]


def test_two_phase_restore_into_adv_phase(tmp_path):
    ck = str(tmp_path / "ck")
    run(tmp_path, "--model", "apr", "--adv_epoch", "1", "--ckpt", "1", "--ckpt_dir", ck,
        sub="a")
    assert os.path.exists(f"{ck}/test/apr-pretrain.npz")
    best, lines = run(tmp_path, "--model", "apr", "--adv_epoch", "1", "--epochs", "3",
                      "--restore", f"{ck}/test/apr-1", "--restore_epoch", "2", sub="b")
    assert np.isfinite(best["ndcg"])
    epochs = [x for x in lines if x.startswith("Epoch ") and "HR =" in x]
    assert [x.split()[1] for x in epochs] == ["2"] and "ACC_adv" in epochs[0]


def test_tiny_dataset_smaller_than_batch(tmp_path):
    """num_pairs < batch_size must not crash the epoch sampler."""
    best, _ = run(tmp_path, "--model", "bpr", "--nrows", "300", "--bs", "512")
    assert np.isfinite(best["ndcg"])


def test_pre_accepts_either_packages_files(tmp_path, datasets):
    """``--pre`` reads a params npz and a full train-state snapshot, the
    port's and the JAX package's (``save_params`` and
    ``Trainer.save_checkpoint``): the leaves are loaded, not left at their
    init."""
    ck = str(tmp_path / "ck")
    run(tmp_path, "--model", "bpr", "--ckpt", "1", "--ckpt_dir", ck, sub="a")
    jt = JaxTrainer(jax_make_model("bpr", datasets[1], jax_build_parser().parse_args(
        ARGS[:-2]))[0], datasets[1], optax.adagrad(0.05), JaxConfig(batch_size=64))
    jax_save_params(str(tmp_path / "jax_params"), jt.params)
    jt.save_checkpoint(str(tmp_path / "jax_state"))
    for i, src in enumerate((f"{ck}/test/bpr-1", str(tmp_path / "jax_params"),
                             str(tmp_path / "jax_state"))):
        _, lines = run(tmp_path, "--model", "bpr", "--epochs", "1", "--pre", src, sub=f"p{i}")
        assert "Loaded pretrained leaves: ['P', 'Q']" in lines, (src, lines[:2])


def test_save_model_and_aliases(tmp_path):
    """``--save_model`` writes .best/.last param snapshots under h5/
    (reference run.py:257-272); --dataset/--adv_epochs/--eval/--verbose_eval
    alias the run_adv_ori.py flag names."""
    cwd = os.getcwd()
    root = os.path.abspath(".")
    os.chdir(tmp_path)
    try:
        best = cli.main(["--dataset", "test", "--path", os.path.join(root, "data"),
                         "--epochs", "2", "--d", "8", "--bs", "64", "--model", "bpr",
                         "--save_model", "1", "--verbose_eval", "1", "--eval", "all",
                         "--adv_epochs", "1", "--device", "cpu", "--opath", str(tmp_path) + "/"])
        assert best["epoch"] >= 0
        h5 = os.listdir(tmp_path / "h5")
        assert any(f.endswith(".best.npz") for f in h5) and any(f.endswith(".last.npz")
                                                               for f in h5), h5
    finally:
        os.chdir(cwd)


def test_fgsm_wrapper(tmp_path):
    """``--fgsm`` wraps a clean model in the FGSM adversary with two-phase
    staging (``tests/test_cli.py::test_cli_fgsm_wrapper`` on a ported
    model)."""
    best, lines = run(tmp_path, "--model", "bpr", "--fgsm", "--adv_epoch", "1", "--eps", "0.1")
    assert np.isfinite(best["ndcg"])
    epochs = [x for x in lines if x.startswith("Epoch ") and "HR =" in x]
    accs = [re.findall(r"ACC = (\S+) ACC_adv = (\S+)", x)[0] for x in epochs]
    assert accs[0][0] == accs[0][1] and accs[1][0] != accs[1][1]


@pytest.mark.parametrize("argv", [["--model", "apr", "--sparse", "--adv_epoch", "1"],
                                  ["--model", "bpr", "--sparse", "--dedup", "sort",
                                   "--epochs", "1"],
                                  ["--model", "irgan", "--irgan_pair", "--epochs", "1"],
                                  ["--model", "pop", "--epochs", "3"]],
                         ids=["apr-sparse", "bpr-sparse-sort", "irgan-pair", "pop-3"])
def test_sparse_irgan_pair_and_naive_runs(tmp_path, argv):
    """``apr --sparse`` two-phase (a clean and an APR epoch on the row-space
    step, the slots reset), ``bpr --sparse --dedup sort``, the pairwise
    IRGAN, and a naive baseline held to one epoch whatever ``--epochs``
    says (run.py:275-276)."""
    best, lines = run(tmp_path, *argv)
    assert np.isfinite(best["ndcg"]) and best["epoch"] >= 0
    epochs = [x for x in lines if x.startswith("Epoch ") and "HR =" in x]
    assert len(epochs) == (2 if argv[1] == "apr" else 1)
    if argv[1] == "apr":
        accs = [re.findall(r"ACC = (\S+) ACC_adv = (\S+)", x)[0] for x in epochs]
        assert accs[0][0] == accs[0][1] and accs[1][0] != accs[1][1]
    assert lines[-1].startswith("End. Best Iteration")


def test_fgsm_wrapper_around_caser(tmp_path):
    """``--fgsm`` around Caser: its clean phase on its own sliding-window
    epoch, the adversarial phase on the sequence epoch (the wrapper does
    not take over the base's epoch, as in the JAX package)."""
    best, lines = run(tmp_path, "--model", "caser", "--fgsm", "--adv_epoch", "1", "--eps", "0.1")
    assert np.isfinite(best["ndcg"])
    epochs = [x for x in lines if x.startswith("Epoch ") and "HR =" in x]
    accs = [re.findall(r"ACC = (\S+) ACC_adv = (\S+)", x)[0] for x in epochs]
    assert len(epochs) == 2 and accs[0][0] == accs[0][1] and accs[1][0] != accs[1][1]
    assert lines[-1].startswith("End. Best Iteration")


def jax_exit(tmp_path, argv):
    """The JAX CLI's SystemExit message for ``argv`` on the same data."""
    with pytest.raises(SystemExit) as e:
        jax_main(ARGS[:-2] + argv + ["--opath", str(tmp_path / "jax") + "/"])
    return str(e.value)


FGSM_REFUSALS = [["--model", m, "--fgsm"] for m in
                 ("apr", "amf", "aneumf", "apl", "irgan", "pop", "mrv", "mfv", "av")] + [
    ["--model", "bpr", "--sparse", "--fgsm"], ["--model", "apr", "--sparse", "--fgsm"]]


@pytest.mark.parametrize("argv", FGSM_REFUSALS,
                         ids=[a[1] + ("-sparse" if "--sparse" in a else "") for a in FGSM_REFUSALS])
def test_fgsm_refuses_adversarial_models(tmp_path, argv):
    """``--fgsm`` refuses the models that are already adversarial or have
    no embedding tables, and ``--sparse``, with the JAX CLI's messages."""
    with pytest.raises(SystemExit) as e:
        cli.main(ARGS + argv + ["--opath", str(tmp_path) + "/"])
    assert "fgsm" in str(e.value) and str(e.value) == jax_exit(tmp_path, argv)


SPARSE_REFUSALS = [["--model", "apr", "--sparse", "--adv", "random"],
                   ["--model", "bpr", "--sparse", "--dns", "2"],
                   ["--model", "apr", "--sparse", "--adv_steps", "2"]]


@pytest.mark.parametrize("argv", SPARSE_REFUSALS, ids=["adv-random", "dns-2", "adv_steps-2"])
def test_sparse_refuses_what_the_row_space_step_lacks(tmp_path, argv, datasets):
    """``_check_sparse_flags``: random deltas, DNS and multi-step PGD exit
    with the JAX CLI's messages, from ``main`` and from ``make_model``."""
    with pytest.raises(SystemExit) as e:
        cli.main(ARGS + argv + ["--opath", str(tmp_path) + "/"])
    assert str(e.value).startswith("--sparse ") and str(e.value) == jax_exit(tmp_path, argv)
    with pytest.raises(SystemExit, match=re.escape(str(e.value))):
        cli.make_model(argv[1], datasets[0], cli.build_parser().parse_args(ARGS + argv))


def test_profile_trace(tmp_path):
    trace_dir = str(tmp_path / "trace")
    best, lines = run(tmp_path, "--model", "bpr", "--epochs", "1", "--profile", trace_dir)
    assert np.isfinite(best["ndcg"])
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(trace_dir))
    assert f"Profiler trace written to {trace_dir}" in lines


def test_profile_trace_is_written_when_the_run_raises(tmp_path):
    trace_dir = str(tmp_path / "trace")
    with pytest.raises(SystemExit, match="stage2_epoch"):
        cli.main(ARGS + ["--model", "apr", "--eps_stage2", "0.8", "--stage2_epoch", "5",
                         "--profile", trace_dir, "--opath", str(tmp_path) + "/"])
    assert os.listdir(trace_dir)


def test_staged_eps_three_phase(tmp_path):
    """``--eps_stage2``: clean, then eps, then eps_stage2 (APR, its Adagrad
    slots reset at the first switch only); the epoch ordering is
    validated, and ``--restore`` refused."""
    best, lines = run(tmp_path, "--model", "apr", "--epochs", "3", "--adv_epoch", "1",
                      "--eps", "0.5", "--eps_stage2", "0.8", "--stage2_epoch", "2")
    assert best["epoch"] >= 2
    assert len([x for x in lines if x.startswith("Epoch ") and "HR =" in x]) == 3
    for bad in (["--adv_epoch", "2", "--stage2_epoch", "1"],
                ["--adv_epoch", "1", "--stage2_epoch", "2", "--restore", "x"]):
        with pytest.raises(SystemExit, match="stage2"):
            cli.main(ARGS + ["--model", "apr", "--epochs", "3", "--eps_stage2", "0.8", *bad,
                             "--opath", str(tmp_path) + "/"])


def test_staged_eps_rejects_single_phase_models(tmp_path):
    with pytest.raises(SystemExit, match="two-phase"):
        cli.main(ARGS + ["--model", "sasrec", "--eps_stage2", "0.8", "--stage2_epoch", "1",
                         "--opath", str(tmp_path) + "/"])


@pytest.mark.parametrize("name", ["asasrec", "bpr"])
def test_train_dtype_bfloat16(tmp_path, monkeypatch, name):
    """``--train_dtype bfloat16`` trains SASRec's family through the encoder's
    bfloat16 form (both phases' models carry it, the losses are finite) and
    is accepted and ignored by every other model, as the JAX CLI does."""
    built = []

    def make_model(*a):
        out = make(*a)
        built.append(out)
        return out

    make = cli.make_model
    monkeypatch.setattr(cli, "make_model", make_model)
    best, lines = run(tmp_path, "--model", name, "--train_dtype", "bfloat16", "--adv_epoch", "1")
    assert np.isfinite(best["ndcg"]) and best["epoch"] >= 0
    (model, _, clean), = built
    if name == "asasrec":
        assert model.train_dtype == clean.train_dtype == "bfloat16"
        assert model._compute_dtype() is torch.bfloat16
    else:
        assert not hasattr(model, "train_dtype")
    # the trainer stops at a NaN loss, writing a line that says so
    assert not any("NaN loss" in x for x in lines), lines
    epochs = [x for x in lines if x.startswith("Epoch ") and "HR =" in x]
    accs = [[float(v) for v in re.findall(r"ACC = (\S+) ACC_adv = (\S+)", x)[0]] for x in epochs]
    assert len(epochs) == 2 and np.isfinite(accs).all(), epochs
    if name == "asasrec":  # the second epoch is the adversarial phase's
        assert accs[0][0] == accs[0][1] and accs[1][0] != accs[1][1]


def test_the_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(ARGS[:-2] + ["--model", "bpr", "--opath", str(tmp_path) + "/"])
    assert not os.listdir(tmp_path)  # raised before writing anything
