"""The port's command line (counterpart of ``acf_tpu/cli/main.py``): one entry
point for the reference's three run scripts, training on the GPU.

It parses the JAX CLI's whole flag union (run.py:25-75, run_adv.py:15-54,
run_adv_ori.py:17-64), so every command line of ``scripts/`` and ``docs/``
parses, plus ``--device`` (default ``cuda``; ``cpu`` runs on the CPU and is
what the tests pass). It builds every model of the JAX CLI, with its
hyperparameters and optimizers:

  mf bpr bpr-tf apr amf amf2 abpr neumf aneumf sasrec asasrec asasrec2 apl
  gru4rec dream dream-tf caser drcf dsin irgan pop mrv mfv av

(``bpr``, ``bpr-tf`` and ``apr`` with ``--sparse`` on the row-space step;
``sasrec``, ``asasrec`` and ``asasrec2`` with ``--train_dtype bfloat16``,
which every other model ignores, as the JAX CLI does). Nothing falls back
to another model or to the CPU.

``--mesh DATAxMODEL`` trains any of them (``--fgsm`` and ``--sparse`` too)
data-parallel over ``torch.distributed`` ranks, one process a rank, and
evaluates factored models sharded over both axes
(:mod:`acf_tpu_torch.parallel`). Under ``torchrun`` the ranks come from its
environment; without it only ``1x1`` runs, in a group of one process. Only
rank 0 writes the ``.out``/``.hr``/``.ndcg`` files and the snapshots::

    torchrun --nproc_per_node 1 -m acf_tpu_torch.cli.main --model apr --mesh 1x1 ...

Two-phase adversarial staging (apr/asasrec/asasrec2, and any model under
``--fgsm``) follows run_adv.py:97-120: clean training until --adv_epoch,
then the adversarial objective continues from the same parameters.

Usage:
    python -m acf_tpu_torch.cli.main --model apr --data video --path data/ \\
        --epochs 200 --adv_epoch 100 --d 64
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from datetime import datetime

import torch

from acf_tpu_torch.data import load_dataset
from acf_tpu_torch.device import resolve_device
from acf_tpu_torch.train import TrainConfig, Trainer, adagrad, adam, fit_two_phase, sgd
from acf_tpu_torch.train.trainer import profiled
from acf_tpu_torch.utils.io import OutputWriter

PORTED_MODELS = ("mf", "bpr", "bpr-tf", "apr", "amf", "amf2", "abpr", "neumf", "aneumf",
                 "sasrec", "asasrec", "asasrec2", "apl", "gru4rec", "dream", "dream-tf",
                 "caser", "drcf", "dsin", "irgan", "pop", "mrv", "mfv", "av")
NAIVE_MODELS = ("pop", "mrv", "mfv", "av")
# models that --fgsm cannot wrap: already adversarial, or no embedding tables
NOT_WRAPPABLE = ("amf", "amf2", "abpr", "aneumf", "irgan", "apl") + NAIVE_MODELS


def build_parser():
    p = argparse.ArgumentParser(description="Adversarial CF on the GPU (PyTorch + CUDA)")
    p.add_argument("--path", type=str, default="", help="data directory root")
    p.add_argument("--opath", type=str, default="out/", help="output dir")
    p.add_argument("--model", type=str, default="bpr")
    p.add_argument("--data", "--dataset", dest="data", type=str, default="video")
    p.add_argument("--d", "--embed_size", dest="d", type=int, default=64)
    p.add_argument("--maxlen", type=int, default=50)
    p.add_argument("--train_dtype", default="float32", choices=["bfloat16", "float32"],
                   help="SASRec train-path encoder compute dtype (evaluation is always "
                        "float32): bfloat16 gives each product of the encoder bfloat16 "
                        "operands with float32 sums")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--adv_epoch", "--adv_epochs", dest="adv_epoch", type=int, default=50,
                   help="epoch at which the adversarial phase starts")
    p.add_argument("--bs", "--batch_size", dest="bs", type=int, default=512)
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate. Default: 0.05 for the adagrad models (reference "
                        "evaluation_adv.py:205-207); an explicit --lr always wins")
    p.add_argument("--reg", type=float, default=0.0)
    p.add_argument("--reg_adv", type=float, default=1.0)
    p.add_argument("--eps", type=float, default=0.5)
    p.add_argument("--eps_pos", type=float, default=0.0)
    p.add_argument("--eps_dense", type=float, default=0.0)
    p.add_argument("--eps_conv", type=float, default=0.0)
    p.add_argument("--eps_stage2", type=float, default=0.0,
                   help="staged-epsilon schedule for two-phase adversarial models: enter "
                        "the adversarial phase at --eps, then raise eps to THIS value at "
                        "--stage2_epoch (docs/PARITY.md)")
    p.add_argument("--stage2_epoch", type=int, default=0,
                   help="epoch at which --eps_stage2 takes over (required with "
                        "--eps_stage2; must satisfy adv_epoch < stage2_epoch < epochs)")
    p.add_argument("--adv", type=str, default="grad", choices=["grad", "random"])
    p.add_argument("--adv_steps", type=int, default=1,
                   help="PGD-style multi-step perturbation for apr (1 = the reference's "
                        "single FGSM step; MSAP arXiv:2010.01329)")
    p.add_argument("--fgsm", action="store_true",
                   help="wrap the chosen model in embedding-space FGSM/PGD adversarial "
                        "training with --adv_epoch two-phase staging")
    p.add_argument("--dns", type=int, default=1,
                   help="dynamic negative sampling: candidates per positive")
    p.add_argument("--loss", type=str, default="",
                   help="model loss variant: apl log|wgan|hinge (APL.py:62); gru4rec "
                        "bpr|top1|ce")
    p.add_argument("--final_act", type=str, default="linear",
                   choices=["linear", "relu", "tanh"], help="gru4rec output activation")
    p.add_argument("--hidden_act", type=str, default="tanh", choices=["tanh", "relu"],
                   help="gru4rec cell activation")
    p.add_argument("--sess_count", type=int, default=5, help="dsin: number of sessions S")
    p.add_argument("--dsin_bi", action="store_true",
                   help="dsin: bidirectional interest evolution")
    p.add_argument("--sess_len", type=int, default=0,
                   help="dsin: items per session (0 = maxlen // sess_count)")
    p.add_argument("--irgan_pair", action="store_true",
                   help="irgan: pairwise discriminator (DIS2, IRGAN.py:277-343)")
    p.add_argument("--sparse", action="store_true",
                   help="row-space sparse Adagrad step for bpr/apr (no dense table work "
                        "per step)")
    p.add_argument("--dedup", type=str, default="auto", choices=["auto", "matmul", "sort"],
                   help="duplicate-row aggregation program for --sparse")
    p.add_argument("--pre", type=str, default="",
                   help="npz params or full train-state snapshot to warm-start matching "
                        "params from (either package's files)")
    p.add_argument("--restore", type=str, default="",
                   help="full train-state snapshot (params+opt+RNG) to resume from "
                        "(reference --restore, run_adv.py:97-120)")
    p.add_argument("--restore_epoch", type=int, default=0,
                   help="first epoch to RUN after restoring (a snapshot named '-e' was "
                        "saved after epoch e completed, so pass e+1 to resume)")
    p.add_argument("--ckpt_dir", type=str, default="Pretrain",
                   help="directory for periodic --ckpt snapshots")
    p.add_argument("--w", type=float, default=0.001, help="popularity-discriminator weight")
    p.add_argument("--pp", type=float, default=0.2, help="popularity percent")
    p.add_argument("--eval_mode", "--eval", dest="eval_mode", type=str, default="all",
                   choices=["all", "sample"])
    p.add_argument("--verbose", "--verbose_eval", dest="verbose", type=int, default=1)
    p.add_argument("--save_model", type=int, default=0,
                   help="1 = save params on every new best NDCG (.best.npz) and after every "
                        "epoch (.last.npz) under h5/ (reference run.py:257-272)")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--ckpt", type=int, default=0)
    p.add_argument("--seed", type=int, default=2019)
    p.add_argument("--nrows", type=int, default=0, help="truncate the dataset (smoke runs)")
    p.add_argument("--profile", type=str, default="",
                   help="directory for a torch.profiler Chrome trace of the run (open with "
                        "Perfetto or chrome://tracing)")
    p.add_argument("--mesh", type=str, default="",
                   help="DATAxMODEL mesh of torch.distributed ranks (e.g. 2x1: the batch split "
                        "2-way over \"data\"; 1x2: the item table's rows 2-way over \"model\" "
                        "in evaluation, and the sparse step's tables): one process a rank, "
                        "started by torchrun; without it only 1x1. Every model, with --fgsm "
                        "and --sparse too")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train and evaluate on (default cuda; raises "
                        "without a GPU unless cpu is asked)")
    return p


def _check_sparse_flags(args):
    """The row-space sparse step supports neither random-delta FGSM nor DNS
    nor multi-step perturbations: refuse rather than train a different
    objective (the JAX CLI's messages)."""
    if args.adv != "grad":
        raise SystemExit("--sparse supports --adv grad only "
                         "(the sparse step has no random-delta branch); "
                         "drop --sparse or use --adv grad")
    if args.dns > 1:
        raise SystemExit("--sparse does not support --dns > 1 "
                         "(no DNS candidate selection in the sparse step); "
                         "drop --sparse or --dns")
    if args.adv_steps > 1:
        raise SystemExit("--sparse does not support --adv_steps > 1 "
                         "(single-step FGSM only in the sparse step); "
                         "drop --sparse or --adv_steps")


def make_model(name, data, args):
    """name → (model, optimizer, clean_model_for_phase1 | None), with the JAX
    CLI's hyperparameters and optimizers (``acf_tpu/cli/main.py:175-282``)."""
    from acf_tpu_torch.adversarial.popularity import PopularityAdversarial
    from acf_tpu_torch.models import naive
    from acf_tpu_torch.models.apl import APL
    from acf_tpu_torch.models.caser import Caser
    from acf_tpu_torch.models.dream import DREAM
    from acf_tpu_torch.models.drcf import DRCF
    from acf_tpu_torch.models.dsin import DSIN
    from acf_tpu_torch.models.gru4rec import GRU4Rec
    from acf_tpu_torch.models.irgan import IRGAN
    from acf_tpu_torch.models.mf import MFBPR, PointwiseMF
    from acf_tpu_torch.models.neumf import NeuMF
    from acf_tpu_torch.models.sasrec import SASRec
    from acf_tpu_torch.ops.sparse_step import SparseMFBPR

    U, I, d = data.num_users, data.num_items, args.d
    adam_ = adam(0.001)
    lr = 0.05 if args.lr is None else args.lr
    adagrad_ = adagrad(lr, initial_accumulator_value=0.1)

    def popularity(base, simultaneous=False):
        return PopularityAdversarial(U, I, d, base=base, weight=args.w, pop_percent=args.pp,
                                     simultaneous=simultaneous)

    if name == "mf":
        return PointwiseMF(U, I, d), adam_, None
    if name in ("bpr", "bpr-tf", "apr") and args.sparse:
        _check_sparse_flags(args)
        clean = SparseMFBPR(U, I, d, reg=args.reg, lr=lr, dedup=args.dedup)
        if name != "apr":
            return clean, adagrad_, None
        return dataclasses.replace(clean, adversarial=True, eps=args.eps,
                                   reg_adv=args.reg_adv), adagrad_, clean
    if name in ("bpr", "bpr-tf"):
        return MFBPR(U, I, d, reg=args.reg, dns=args.dns), adagrad_, None
    if name == "apr":
        clean = MFBPR(U, I, d, reg=args.reg, dns=args.dns)
        adv = MFBPR(U, I, d, reg=args.reg, adversarial=True, eps=args.eps,
                    reg_adv=args.reg_adv, adv_mode=args.adv, dns=args.dns,
                    adv_steps=args.adv_steps)
        return adv, adagrad_, clean
    if name in ("amf", "amf2"):
        # amf2 = FastAdversarialMF: simultaneous two-player updates
        # (reference FastAdversarialMF.py:64-74)
        return popularity(PointwiseMF(U, I, d), simultaneous=(name == "amf2")), adam_, None
    if name == "abpr":
        return popularity(MFBPR(U, I, d)), adam_, None
    if name == "neumf":
        return NeuMF(U, I, d), adam_, None
    if name == "aneumf":
        return popularity(NeuMF(U, I, d)), adam_, None
    if name == "sasrec":
        return SASRec(U, I, d, maxlen=args.maxlen, train_dtype=args.train_dtype), \
            adam(0.001, b2=0.98), None
    if name in ("asasrec", "asasrec2"):
        clean = SASRec(U, I, d, maxlen=args.maxlen, train_dtype=args.train_dtype)
        adv = SASRec(U, I, d, maxlen=args.maxlen, adversarial=True, adv_mode=name,
                     eps=args.eps, reg_adv=args.reg_adv, eps_pos=args.eps_pos,
                     eps_dense=args.eps_dense, eps_conv=args.eps_conv,
                     adv_steps=args.adv_steps, train_dtype=args.train_dtype)
        return adv, adam(0.001, b2=0.98), clean
    if name == "gru4rec":
        return GRU4Rec(U, I, d, maxlen=args.maxlen, loss_type=args.loss or "bpr",
                       final_act=args.final_act, hidden_act=args.hidden_act), adam_, None
    if name in ("dream", "dream-tf"):
        return DREAM(U, I, d, maxlen=args.maxlen), adam_, None
    if name == "drcf":
        return DRCF(U, I, d, maxlen=args.maxlen), adam_, None
    if name == "caser":
        return Caser(U, I, d, maxlen=args.maxlen), adam_, None
    if name == "dsin":
        # sessions sized so that sess_count * sess_len ≈ --maxlen unless
        # given; Adam(1e-4), the JAX package's tuned rate, unless --lr is
        ls = args.sess_len or max(args.maxlen // args.sess_count, 1)
        return DSIN(U, I, d, sess_count=args.sess_count, sess_len=ls,
                    loss_type=args.loss or "bce", bi_evolution=args.dsin_bi), \
            adam(1e-4 if args.lr is None else args.lr), None
    if name == "apl":
        return APL(U, I, d, loss_function=args.loss or "log"), sgd(0.05), None
    if name == "irgan":
        return IRGAN(U, I, d, pairwise_d=args.irgan_pair), sgd(0.001), None
    naive_cls = {"pop": naive.MostPopular, "mrv": naive.MostRecentlyVisit,
                 "mfv": naive.MostFrequentlyVisit, "av": naive.AlreadyVisit}
    if name in naive_cls:
        return naive_cls[name](U, I, d, data=data), adam_, None
    raise ValueError(f"unknown model {name!r}")


def main(argv=None):
    """Parse ``argv`` and run; returns the best epoch's record. With
    ``--mesh`` the process group is initialised here when it is not yet, and
    destroyed again at the end."""
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    if not args.mesh:
        return _main(args, None)
    from acf_tpu_torch.parallel.mesh import mesh_from_spec

    owned = not dist.is_initialized()
    try:
        return _main(args, mesh_from_spec(args.mesh, args.device))
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _main(args, mesh):
    device = resolve_device(args.device) if mesh is None else mesh.device
    main_rank = mesh is None or mesh.rank == 0
    data = load_dataset(args.data, args.path or "data/", eval_mode=args.eval_mode,
                        nrows=args.nrows or None)
    model, optimizer, clean = make_model(args.model, data, args)
    if args.fgsm:
        from acf_tpu_torch.adversarial import FGSMAdversarial

        if clean is not None or args.model in NOT_WRAPPABLE:
            raise SystemExit(f"--fgsm does not apply to {args.model!r} "
                             "(already adversarial, or no embedding tables)")
        if args.sparse:
            # the wrapper would take SparseMFBPR's slot dict but not its
            # epoch: the pair epoch would then update the wrong state
            raise SystemExit("--fgsm does not combine with --sparse "
                             "(the row-space step has its own fused FGSM); "
                             "use --model apr --sparse for sparse APR")
        clean = model
        model = FGSMAdversarial(data.num_users, data.num_items, args.d, base=clean,
                                eps=args.eps, reg_adv=args.reg_adv, adv_steps=args.adv_steps)

    run_name = "%s_%s_d%d_%s" % (args.data, args.model, args.d,
                                 datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
    writer = OutputWriter(args.opath, run_name) if main_rank else OutputWriter(None, None)
    writer.line("Load data done. #user=%d, #item=%d, #train=%d, #test=%d"
                % (data.num_users, data.num_items, data.num_pairs, len(data.eval_users())))
    if args.save_model and main_rank:
        os.makedirs("h5", exist_ok=True)  # reference save dir (run.py:260)
    if mesh is not None:
        import torch.distributed as dist

        writer.line("Mesh: data=%d model=%d over %d rank(s), %s on %s"
                    % (mesh.shape["data"], mesh.shape["model"], mesh.size, dist.get_backend(),
                       device))
    # the naive baselines need one pass (run.py:275-276)
    epochs = 1 if args.model in NAIVE_MODELS else args.epochs
    cfg = TrainConfig(batch_size=args.bs, epochs=epochs, verbose=args.verbose,
                      topk=args.topk, eval_sampled=(args.eval_mode == "sample"),
                      ckpt_every=args.ckpt,
                      ckpt_path=(f"{args.ckpt_dir}/{args.data}/{args.model}"
                                 if args.ckpt else None),
                      save_model_path=(f"h5/{run_name}" if args.save_model else None),
                      seed=args.seed, device=str(device), mesh=mesh)
    restore = (args.restore, args.restore_epoch) if args.restore else None
    with contextlib.ExitStack() as stack:
        if args.profile:
            stack.enter_context(profiled(args.profile, device))
        best = _run(args, data, model, clean, optimizer, cfg, writer, restore)
    if args.profile:
        writer.line(f"Profiler trace written to {args.profile}")
    writer.line("End. Best Iteration %d: HR = %.4f, NDCG = %.4f"
                % (best.get("epoch", -1), best.get("hr", 0.0), best.get("ndcg", 0.0)))
    return best


def _run(args, data, model, clean, optimizer, cfg, writer, restore):
    # asasrec carries Adam slots into phase 2 (full-variable Saver,
    # utils.py:306-315); apr resets them (embeddings-only Saver,
    # evaluation_adv.py:235)
    reset_opt = args.model not in ("asasrec", "asasrec2")
    if args.eps_stage2 > 0.0 and clean is None:
        raise SystemExit(f"--eps_stage2 only applies to two-phase adversarial models "
                         f"(apr/asasrec/asasrec2), not --model {args.model}")
    if clean is not None and args.eps_stage2 > 0.0:
        # staged-epsilon three-phase protocol:
        # clean 0..adv_epoch -> eps adv_epoch..stage2_epoch -> eps_stage2
        if restore:
            raise SystemExit("--eps_stage2 does not support --restore")
        if not (args.adv_epoch < args.stage2_epoch < cfg.epochs):
            raise SystemExit("--eps_stage2 requires --adv_epoch < --stage2_epoch < --epochs "
                             f"(got {args.adv_epoch} / {args.stage2_epoch} / {cfg.epochs})")
        adv_hi = dataclasses.replace(model, eps=args.eps_stage2)
        tr = Trainer(clean, data, optimizer, cfg, writer)
        if args.pre:
            tr.load_pretrain(args.pre)
        tr.fit(epochs=args.adv_epoch, final=False)
        if cfg.ckpt_path:  # fit_two_phase's phase-boundary saves (every rank joins)
            tr.save_params(cfg.ckpt_path + "-pretrain")
        tr.switch_model(model, reset_opt=reset_opt)
        tr.fit(epochs=args.stage2_epoch, epoch_start=args.adv_epoch, final=False)
        tr.switch_model(adv_hi, reset_opt=False)
        best = tr.fit(epochs=cfg.epochs, epoch_start=args.stage2_epoch)
        if cfg.ckpt_path:
            tr.save_params(cfg.ckpt_path + "-final")
        return best
    if clean is not None:
        return fit_two_phase(clean, model, data, optimizer, cfg, adv_epoch=args.adv_epoch,
                             writer=writer, restore=restore, pretrain=args.pre or None,
                             reset_opt=reset_opt)
    trainer = Trainer(model, data, optimizer, cfg, writer)
    if args.pre:
        loaded = trainer.load_pretrain(args.pre)
        writer.line(f"Loaded pretrained leaves: {loaded}")
    if restore:
        trainer.restore_checkpoint(restore[0])
        return trainer.fit(epoch_start=restore[1])
    return trainer.fit()


if __name__ == "__main__":
    main()
