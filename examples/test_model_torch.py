"""Checkpoint evaluation on the PyTorch port (the twin of
examples/test_model.py; all logic lives in
openibl_tpu_torch.engine.pipeline.run_eval).

On the card:
  python examples/test_model_torch.py -d pitts --scale 250k --checkpoint logs/model_best.npz
  python examples/test_model_torch.py -d tokyo --checkpoint vgg16_netvlad.pth --nms
On N cards, one process each (NCCL; the extraction and the kNN are split
over the ranks, only rank 0 prints):
  torchrun --nproc-per-node=N examples/test_model_torch.py -d pitts --checkpoint logs/model_best.npz
On the CPU, add ``--device cpu`` (gloo across processes). Without
``--device`` the run needs a CUDA card and raises without one.
"""

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

from openibl_tpu_torch.config import DataConfig, EvalConfig  # noqa: E402
from openibl_tpu_torch.engine.pipeline import run_eval  # noqa: E402
from openibl_tpu_torch.parallel.mesh import (  # noqa: E402
    get_mesh, maybe_init_distributed,
)


def main(argv=None):
    p = argparse.ArgumentParser(description="model evaluation (PyTorch)")
    p.add_argument("-d", "--dataset", type=str, default="pitts")
    p.add_argument("-a", "--arch", type=str, default="vgg16",
                   help="accepted for reference CLI parity (vgg16 backbone)")
    p.add_argument("-j", "--workers", type=int, default=2,
                   help="host-side prefetch depth per loader")
    p.add_argument("--scale", type=str, default="250k")
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--checkpoint", "--resume", dest="checkpoint", type=str,
                   required=True)
    p.add_argument("--pca-params", type=str, default="")
    p.add_argument("--no-reduction", action="store_true")
    p.add_argument("--nowhiten", action="store_true",
                   help="skip whitening inside the PCA reduction")
    p.add_argument("--vlad", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-vlad evaluates the global max-pool feature")
    p.add_argument("--features", type=int, default=4096)
    p.add_argument("--num-clusters", type=int, default=64)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--test-batch-size", type=int, default=32)
    p.add_argument("--rerank", action="store_true",
                   help="k-reciprocal rerank (k1 --rr-topk, k2 1)")
    p.add_argument("--rr-topk", type=int, default=25)
    p.add_argument("--lambda-value", type=float, default=0.0)
    p.add_argument("--nms", action="store_true", help="Tokyo spatial NMS")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 backbone compute (match a bf16-trained "
                        "checkpoint; descriptor products stay f32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on (default: the card)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="the launch's process count, checked (default: "
                        "whatever torchrun started)")
    args = p.parse_args(argv)

    maybe_init_distributed(device=args.device)

    cfg = EvalConfig(
        data=DataConfig(
            dataset=args.dataset, scale=args.scale, data_dir=args.data_dir,
            height=args.height, width=args.width,
            test_batch_size=args.test_batch_size, workers=args.workers,
        ),
        checkpoint=args.checkpoint, pca_params=args.pca_params,
        reduction=not args.no_reduction, pca_dim=args.features,
        whiten=not args.nowhiten, use_vlad=args.vlad,
        rerank=args.rerank, rr_topk=args.rr_topk,
        lambda_value=args.lambda_value,
        nms=args.nms or args.dataset == "tokyo",
        num_clusters=args.num_clusters, arch=args.arch,
        compute_dtype="bfloat16" if args.bf16 else "float32",
    )
    return run_eval(cfg, device=args.device,
                    mesh=get_mesh(args.n_devices, device=args.device))


if __name__ == "__main__":
    main()
