"""SFRS training on the PyTorch port: generational self-distillation with
region similarities (the twin of examples/train_sfrs.py; all logic lives in
openibl_tpu_torch.engine.pipeline).

Usage (published Pitts30k recipe, on the card):
  python examples/train_sfrs_torch.py -d pitts --scale 30k
A hermetic run on the synthetic world, on the CPU:
  python examples/train_sfrs_torch.py -d synthetic --height 32 --width 64 \\
      --num-clusters 8 --neg-num 2 --pos-num 2 --pos-pool 3 --features 16 \\
      --epochs 1 --generations 2 --temperature 0.07 0.05 --device cpu
On N cards, one process each (NCCL; each rank trains on its rows of every
global tuple batch, the gradients averaged over the ranks, only rank 0
writes and prints; --tuple-size must be a multiple of N):
  torchrun --nproc-per-node=N examples/train_sfrs_torch.py -d pitts --scale 30k \\
      --tuple-size N --n-devices N --device-jitter
``--device-jitter`` draws every step's ColorJitter for the global batch,
so N ranks train on the pixels one process sees; the host jitter draws
per process (a warning says so). On the CPU add ``--device cpu`` (gloo
across processes). Without ``--device`` the run needs a CUDA card and
raises without one.
"""

import argparse
import os.path as osp
import sys
import warnings

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

from openibl_tpu_torch.config import DataConfig, SFRSConfig  # noqa: E402
from openibl_tpu_torch.engine.pipeline import (  # noqa: E402
    run_sfrs_training,
)
from openibl_tpu_torch.parallel.mesh import (  # noqa: E402
    get_mesh, maybe_init_distributed, run_device,
)
from openibl_tpu_torch.utils import Logger  # noqa: E402


def parse(argv=None):
    """(arguments, the run's config) from the command line."""
    p = argparse.ArgumentParser(description="SFRS training (PyTorch)")
    p.add_argument("-d", "--dataset", type=str, default="pitts")
    p.add_argument("-a", "--arch", type=str, default="vgg16")
    p.add_argument("-j", "--workers", type=int, default=2,
                   help="host-side prefetch depth per loader")
    p.add_argument("--scale", type=str, default="30k")
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--logs-dir", type=str, default="logs")
    p.add_argument("--init-dir", type=str, default="logs")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--tuple-size", type=int, default=1)
    p.add_argument("--test-batch-size", type=int, default=32)
    p.add_argument("--cache-size", type=int, default=1000)
    p.add_argument("--iters", type=int, default=0,
                   help=">0 caps train iterations per subset")
    p.add_argument("--neg-num", type=int, default=10)
    p.add_argument("--neg-pool", type=int, default=1000)
    p.add_argument("--pos-num", type=int, default=10)
    p.add_argument("--pos-pool", type=int, default=20)
    p.add_argument("--num-clusters", type=int, default=64)
    p.add_argument("--layers", type=str, default="conv5")
    p.add_argument("--loss-type", type=str, default="sare_ind",
                   choices=["triplet", "sare_ind", "sare_joint"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-3)
    p.add_argument("--step-size", type=int, default=5)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--generations", type=int, default=4)
    p.add_argument("--temperature", type=float, nargs="+",
                   default=[0.07, 0.07, 0.06, 0.05])
    p.add_argument("--soft-weight", type=float, default=0.5)
    p.add_argument("--margin", type=float, default=0.1)
    p.add_argument("--features", type=int, default=4096)
    p.add_argument("--nowhiten", action="store_true",
                   help="skip whitening in the final PCA reduction")
    p.add_argument("--vlad", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="accepted for reference CLI parity; SFRS region "
                        "similarities require the VLAD head")
    p.add_argument("--deterministic", action="store_true",
                   help="accepted for reference CLI parity; the draws are "
                        "always seeded")
    p.add_argument("--eval-step", type=int, default=1)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 backbone compute")
    p.add_argument("--device-jitter", action="store_true",
                   help="ColorJitter on the device (raw uint8 tuples, the "
                        "jitter seeded per generation, epoch, subset and "
                        "step)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="the launch's process count, checked (default: "
                        "whatever torchrun started)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default: the card)")
    args = p.parse_args(argv)
    if not args.vlad:
        p.error("SFRS region similarities require the VLAD head (--vlad)")
    cfg = SFRSConfig(
        data=DataConfig(
            dataset=args.dataset, scale=args.scale, data_dir=args.data_dir,
            height=args.height, width=args.width,
            test_batch_size=args.test_batch_size, workers=args.workers,
        ),
        arch=args.arch, whiten=not args.nowhiten,
        train_layers=args.layers, num_clusters=args.num_clusters,
        loss_type=args.loss_type, margin_sq=args.margin,
        tuple_size=args.tuple_size, neg_num=args.neg_num,
        neg_pool=args.neg_pool, pos_num=args.pos_num,
        pos_pool=args.pos_pool, cache_size=args.cache_size, iters=args.iters,
        epochs=args.epochs, generations=args.generations,
        temperature=tuple(args.temperature), soft_weight=args.soft_weight,
        lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, step_size=args.step_size,
        eval_step=args.eval_step, seed=args.seed, pca_dim=args.features,
        logs_dir=args.logs_dir, init_dir=args.init_dir, resume=args.resume,
        print_freq=args.print_freq,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        device_jitter=args.device_jitter,
    )
    return args, cfg


def main(argv=None):
    """Train as the command line says: one process, or one rank of a
    torchrun / Slurm launch (a process group, one device a rank). Returns
    what ``run_sfrs_training`` returns."""
    args, cfg = parse(argv)
    maybe_init_distributed(device=args.device)
    mesh = get_mesh(args.n_devices, device=args.device)
    device = run_device(args.device, mesh)
    if mesh.size > 1 and cfg.augment and not cfg.device_jitter:
        warnings.warn(
            "host ColorJitter draws per process: a multi-rank run jitters "
            "other pixels than one process would; pass --device-jitter to "
            "draw the global batch's jitter on every rank")
    if mesh.rank == 0:  # rank 0 logs, as the reference
        sys.stdout = Logger(osp.join(cfg.logs_dir, "log.txt"))
        print(f"config: {cfg}")
        print(f"device: {device}")
        print(f"mesh: {mesh.size} rank(s)")
    return run_sfrs_training(cfg, device=device, mesh=mesh)


if __name__ == "__main__":
    main()
