"""NetVLAD centroid bootstrap on the PyTorch port (the twin of
examples/cluster.py): sample conv5 descriptors from train images, k-means
to the clusters, and write the cache that training reads (the JAX
package's hdf5, or a .npz under the same name where h5py is missing).

  python examples/cluster_torch.py -d pitts --data-dir data --logs-dir logs
  python examples/cluster_torch.py -d synthetic --height 32 --width 48 \\
      --num-clusters 8 --device cpu

The backbone is the MatConvNet VGG16 (``--logs-dir``/
vd16_offtheshelf_conv5_3_max.pth) the reference clusters; without it a
seeded random backbone, with a loud warning. Without ``--device`` the run
needs a CUDA card.
"""

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

import torch  # noqa: E402

from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.config import DataConfig, TrainConfig  # noqa: E402
from openibl_tpu_torch.engine.pipeline import (  # noqa: E402
    bootstrap_centroids, load_dataset,
)
from openibl_tpu_torch.models import convert  # noqa: E402
from openibl_tpu_torch.utils import resolve_device  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description="VLAD centroid clustering "
                                            "(PyTorch)")
    p.add_argument("-d", "--dataset", type=str, default="pitts")
    p.add_argument("-a", "--arch", type=str, default="vgg16",
                   help="backbone (also names the cache)")
    p.add_argument("-j", "--workers", type=int, default=2,
                   help="host-side prefetch depth per loader")
    p.add_argument("--scale", type=str, default="30k")
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--logs-dir", type=str, default="logs")
    p.add_argument("--num-clusters", type=int, default=64)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("-b", "--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    cfg = TrainConfig(
        data=DataConfig(dataset=args.dataset, scale=args.scale,
                        data_dir=args.data_dir, height=args.height,
                        width=args.width, test_batch_size=args.batch_size,
                        workers=args.workers),
        arch=args.arch,
        num_clusters=args.num_clusters, init_dir=args.logs_dir,
        logs_dir=args.logs_dir, seed=args.seed,
    )
    device = resolve_device(args.device)
    dataset = load_dataset(cfg)
    base = models.create(args.arch, generator=torch.Generator().manual_seed(
        args.seed))
    matconvnet = osp.join(cfg.init_dir, "vd16_offtheshelf_conv5_3_max.pth")
    if osp.isfile(matconvnet):
        state = convert.vgg16_state_from_torch(
            convert.load_torch_checkpoint(matconvnet))
        base.load_state_dict({k[len("base."):]: v for k, v in state.items()})
    else:
        # the reference always clusters pretrained conv5 descriptors;
        # random-weight centroids are meaningless for training, so say so
        # loudly
        print(
            f"WARNING: {matconvnet} not found — clustering RANDOM backbone "
            f"descriptors. The resulting centroids are only useful for "
            f"smoke tests; place the MatConvNet weights in --logs-dir for "
            f"a real NetVLAD init.",
            file=sys.stderr,
        )
    base = base.to(device, memory_format=torch.channels_last).eval()
    centroids, descs = bootstrap_centroids(cfg, dataset, base,
                                           seed=args.seed)
    print(f"centroids: {centroids.shape}, descriptors: {descs.shape}")
    return centroids, descs


if __name__ == "__main__":
    main()
