"""Evaluate released SFRS weights on Pitts250k-test with the PyTorch port
(the twin of examples/test_pitts_best.py; pass the downloaded
vgg16_netvlad.pth explicitly).

  python examples/test_pitts_best_torch.py --weights vgg16_netvlad.pth --data-dir data
  torchrun --nproc-per-node=N examples/test_pitts_best_torch.py --weights vgg16_netvlad.pth

Without ``--device`` the run needs a CUDA card and raises without one.
"""

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

from openibl_tpu_torch import data as datasets  # noqa: E402
from openibl_tpu_torch.data.loader import (  # noqa: E402
    ImageSource, PaddedBatchLoader,
)
from openibl_tpu_torch.data.transforms import TestTransform  # noqa: E402
from openibl_tpu_torch.engine.evaluator import Evaluator  # noqa: E402
from openibl_tpu_torch.hub import vgg16_netvlad  # noqa: E402
from openibl_tpu_torch.parallel.mesh import (  # noqa: E402
    get_mesh, maybe_init_distributed,
)


def run(dataset_name, weights, data_dir, scale=None, nms=False,
        batch_size=32, height=480, width=640, device="cuda", mesh=None):
    """Recall@1/5/10 of the hub model with ``weights`` on the test split;
    Tokyo's variable-shape queries run bucket-padded and masked. With a
    ``mesh`` the model sits on its rank's device and the kNN is sharded
    over the ranks; the gallery's extraction is split over them too (and
    Pitts's queries'; Tokyo's bucket-padded queries run whole on every
    rank)."""
    model = vgg16_netvlad(weights, device=device if mesh is None
                          else mesh.device)
    root = osp.join(data_dir, dataset_name)
    kwargs = {"scale": scale} if dataset_name == "pitts" else {}
    dataset = datasets.create(dataset_name, root, **kwargs)
    tokyo = dataset_name == "tokyo"
    q_src = ImageSource(dataset.q_test, dataset.images_dir,
                        TestTransform(height, width, tokyo=tokyo,
                                      device_normalize=True))
    db_src = ImageSource(dataset.db_test, dataset.images_dir,
                         TestTransform(height, width, device_normalize=True))
    evaluator = Evaluator(
        model, masked_apply_fn=model.forward_masked if tokyo else None,
        mesh=mesh)
    pids = [it[1] for it in dataset.db_test]
    show = mesh is None or mesh.rank == 0
    if not tokyo:
        return evaluator.evaluate_sources(
            q_src, db_src, dataset.test_pos, gallery_pids=pids, nms=nms,
            batch_size=batch_size, print_results=show)
    q_feats = evaluator.extract(PaddedBatchLoader(q_src,
                                                  batch_size=batch_size))
    g_feats = evaluator.extract_sharded(db_src, batch_size=batch_size)
    return evaluator.score(q_feats, g_feats, dataset.test_pos, pids, nms=nms,
                           print_results=show)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--scale", type=str, default="250k")
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
    return run("pitts", args.weights, args.data_dir, scale=args.scale,
               batch_size=args.test_batch_size, height=args.height,
               width=args.width, device=args.device,
               mesh=get_mesh(args.n_devices, device=args.device))


if __name__ == "__main__":
    main()
