"""Evaluate released SFRS weights on Tokyo 24/7 with spatial NMS on the
PyTorch port (the twin of examples/test_tokyo_best.py).

  python examples/test_tokyo_best_torch.py --weights vgg16_netvlad.pth --data-dir data
  torchrun --nproc-per-node=N examples/test_tokyo_best_torch.py --weights vgg16_netvlad.pth

Without ``--device`` the run needs a CUDA card and raises without one.
"""

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from test_pitts_best_torch import run  # noqa: E402

from openibl_tpu_torch.parallel.mesh import (  # noqa: E402
    get_mesh, maybe_init_distributed,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--test-batch-size", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on (default: the card)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="the launch's process count, checked (default: "
                        "whatever torchrun started)")
    args = p.parse_args(argv)
    maybe_init_distributed(device=args.device)
    return run("tokyo", args.weights, args.data_dir, nms=True,
               batch_size=args.test_batch_size, height=args.height,
               width=args.width, device=args.device,
               mesh=get_mesh(args.n_devices, device=args.device))


if __name__ == "__main__":
    main()
