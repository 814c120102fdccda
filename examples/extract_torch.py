"""Single-image 4096-d descriptor extraction on the PyTorch port (the twin
of examples/extract.py).

  python examples/extract_torch.py image.jpg --weights vgg16_netvlad.pth
  python examples/extract_torch.py image.jpg --device cpu --out desc.npy

Without ``--device`` the model runs on the card and raises without one.
"""

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from openibl_tpu_torch.hub import DescriptorExtractor  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description="descriptor extraction (PyTorch)")
    p.add_argument("image", type=str)
    p.add_argument("--weights", type=str, default=None,
                   help="released torch .pth or a JAX .npz checkpoint "
                        "(default: random weights)")
    p.add_argument("--pca-params", type=str, default=None,
                   help="PCA-whitening .h5/.npz for trainer checkpoints")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None, help="save .npy")
    args = p.parse_args(argv)

    extractor = DescriptorExtractor(args.weights, height=args.height,
                                    width=args.width,
                                    pca_params=args.pca_params,
                                    device=args.device)
    img = Image.open(args.image).convert("RGB")
    desc = extractor(img)[0]
    print(f"descriptor: shape={desc.shape} norm={np.linalg.norm(desc):.6f}")
    print(desc[:8], "...")
    if args.out:
        np.save(args.out, desc)
    return desc


if __name__ == "__main__":
    main()
