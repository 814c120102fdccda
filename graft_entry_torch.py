"""Entry points of the PyTorch port: the flagship forward and a multi-device
dry run (the twin of __graft_entry__.py, which stays the JAX package's).

  python graft_entry_torch.py            # 2 ranks on the card(s), NCCL
  python graft_entry_torch.py --device cpu --backend gloo

``entry()`` gives the hub model and one 480x640 image. ``dryrun_multichip(n)``
spawns n ranks, one process each, and runs in every rank the four checks
of ``__graft_entry__.dryrun_multichip`` on its tiny shapes: a SARE
data-parallel step, an SFRS step, sharded extraction with the sharded
Recall@N and one mining refresh (planted queries at recall@1 = 1.0), and
``pq_search_sharded`` (top-1 = the planted ids). Imports no jax.
"""

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args) for the flagship forward: one 480x640 image →
    4096-d PCA-whitened NetVLAD descriptor (the hub inference model, random
    weights, on ``device``; the card by default)."""
    from openibl_tpu_torch.hub import vgg16_netvlad

    model = vgg16_netvlad(None, device=device)
    example_args = (torch.zeros((1, 480, 640, 3), dtype=torch.float32,
                                device=model.pca_layer.w.device),)
    return model, example_args


def _backend(n_devices, device, backend):
    """NCCL when each rank has a card of its own; gloo only when asked."""
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
        if backend == "nccl" and torch.device(device).type != "cuda":
            raise ValueError("NCCL needs device='cuda'")
        return backend
    if torch.device(device).type == "cuda" and \
            n_devices <= torch.cuda.device_count():
        return "nccl"
    raise ValueError(
        f"{n_devices} ranks on device {device!r} with "
        f"{torch.cuda.device_count()} card(s): NCCL needs a card a rank; "
        f"pass backend='gloo' to run them on the CPU or to share cards")


def _rank_device(rank, device):
    if torch.device(device).type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _seeded(name, k, **kw):
    """A tiny model, the same on every rank (a seeded generator), its
    centroids shrunk so random weights give distinct descriptors."""
    from openibl_tpu_torch import models

    gen = torch.Generator().manual_seed(0)
    model = models.create(name, base=models.VGG16(generator=gen),
                          net_vlad=models.NetVLAD(num_clusters=k,
                                                  generator=gen), **kw)
    with torch.no_grad():
        model.net_vlad.centroids.mul_(0.1)
    return model


def _dryrun_rank(rank, n_devices, device, backend, store):
    import torch.distributed as dist

    from openibl_tpu_torch.engine.evaluator import evaluate_descriptors
    from openibl_tpu_torch.engine.pipeline import eval_view
    from openibl_tpu_torch.engine.sfrs import SFRSTrainer, make_teacher
    from openibl_tpu_torch.engine.trainer import Trainer
    from openibl_tpu_torch.ops.distance import mine_hard_tuples
    from openibl_tpu_torch.ops.pq import build_pq, pq_search_sharded
    from openibl_tpu_torch.parallel.extract import extract_features_sharded
    from openibl_tpu_torch.parallel.mesh import (
        Mesh, broadcast_object, check_replicated)

    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=n_devices)
    try:
        mesh = Mesh(dev, rank, n_devices, dist.group.WORLD)
        say = print if rank == 0 else (lambda *a, **k: None)

        # a SARE data-parallel step: one tuple (anchor + positive + 2
        # negatives) a rank, 32x32 images
        model = _seeded("embednet", 8).to(dev)
        trainer = Trainer(model, loss_type="sare_ind", lr=1e-3, mesh=mesh)
        trainer.init()
        imgs = np.random.RandomState(0).randn(
            n_devices, 4, 32, 32, 3).astype(np.float32)
        loss = float(trainer.step(imgs[rank:rank + 1]))
        assert np.isfinite(loss), f"non-finite loss {loss}"
        check_replicated(mesh, model.parameters(), "the parameters")
        say(f"dryrun_multichip({n_devices}): baseline DP step ok, "
            f"loss={loss:.4f}", flush=True)

        # an SFRS step (teacher + student, hard + soft losses): anchor +
        # positive + 2 negatives + 1 difficult positive; 32x32 gives a 2x2
        # conv5 map, the smallest that quarters
        region = _seeded("embedregionnet", 4).to(dev)
        teacher = make_teacher(region)
        strainer = SFRSTrainer(region, neg_num=2, lr=1e-3, mesh=mesh)
        strainer.init_generation()
        timgs = np.random.RandomState(1).randn(
            n_devices, 5, 32, 32, 3).astype(np.float32)
        lh, ls = (float(x) for x in strainer.step(
            teacher, timgs[rank:rank + 1], 1))
        assert np.isfinite(lh) and np.isfinite(ls), (lh, ls)
        check_replicated(mesh, region.parameters(), "the SFRS student")
        say(f"dryrun_multichip({n_devices}): SFRS DP step ok, "
            f"hard={lh:.4f} soft={ls:.4f}", flush=True)

        # sharded extraction, the sharded Recall@N and a mining refresh:
        # the queries ARE gallery images, so recall@1 is exact whatever
        # the weights
        rows = 2 * max(n_devices, 8)
        g_imgs = np.random.RandomState(2).randn(
            rows, 32, 32, 3).astype(np.float32) * 20

        class Source:
            def __len__(self):
                return len(g_imgs)

            def load(self, i):
                return g_imgs[i]

        q_ids = [i % rows for i in (3, 2 * n_devices - 1, 0, 5)]
        g_feats = extract_features_sharded(
            eval_view(model.eval()), Source(), batch_size=n_devices,
            mesh=mesh, device_output=True)
        q_feats = g_feats[q_ids]
        recalls = evaluate_descriptors(q_feats, g_feats,
                                       [[i] for i in q_ids], topk=(1, 5),
                                       mesh=mesh, print_results=False)
        assert recalls[0] == 1.0, f"planted-query recall@1 {recalls}"
        pos_idx = np.array([[i, -1] for i in q_ids])
        cand_idx = np.array([[(i + 2) % rows, (i + 3) % rows]
                             for i in q_ids])
        pos, neg = mine_hard_tuples(q_feats, g_feats, pos_idx, cand_idx,
                                    neg_num=2)
        assert pos.tolist() == q_ids, pos.tolist()
        say(f"dryrun_multichip({n_devices}): sharded eval ok, "
            f"recall@1={recalls[0]:.2f} recall@5={recalls[1]:.2f}, "
            f"mined negs shape={tuple(neg.shape)}", flush=True)

        # the sharded PQ search: codes split over the ranks, each rank's
        # ADC top-k (K2 on a card), one all-gather merge
        pq = broadcast_object(mesh, build_pq(g_feats.cpu().numpy(), m=8,
                                             ksub=8, iters=3)
                              if rank == 0 else None)
        _, pq_idx = pq_search_sharded(q_feats, pq["pq_codes"],
                                      pq["pq_codebooks"], mesh, k=1)
        assert pq_idx[:, 0].tolist() == q_ids, pq_idx.tolist()
        say(f"dryrun_multichip({n_devices}): sharded PQ search ok, "
            f"top-1 = planted ids {q_ids}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices, device="cuda", backend=None):
    """Spawn ``n_devices`` ranks (one process each, a file rendezvous in a
    temporary directory) and run the four checks in each; raises if a
    rank fails. ``backend`` None means NCCL, which needs a card a rank
    (``n_devices <= torch.cuda.device_count()``); ``"gloo"`` runs the ranks
    on the CPU (``device="cpu"``) or lets several share a card."""
    import torch.multiprocessing as mp

    backend = _backend(n_devices, device, backend)
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    try:
        mp.start_processes(_dryrun_rank,
                           args=(n_devices, device, backend,
                                 os.path.join(tmp, "store")),
                           nprocs=n_devices, join=True,
                           start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-devices", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = p.parse_args()
    dryrun_multichip(args.n_devices, args.device, args.backend)
    fn, example_args = entry(args.device)
    with torch.inference_mode():
        out = fn(*example_args)
    print(f"entry(): descriptor {tuple(out.shape)}, norm "
          f"{float(out.norm()):.6f}")
