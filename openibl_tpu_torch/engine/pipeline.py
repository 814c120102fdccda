"""Training and evaluation workflows (port of
openibl_tpu/engine/pipeline.py): baseline training (triplet / SARE with
hard-negative mining), SFRS training and checkpoint evaluation, on one
device or data-parallel over the ranks of a mesh.

Per epoch: the StepLR rate, then for each shuffled subset of the training
queries

  1. mining extraction through the fused NetVLAD head (kernel K1 on the
     card, ``eval_view``): the gallery and the subset's anchors, kept on the
     device;
  2. the sampler's refresh, mined on the device;
  3. training over the mined tuples through the eager head (``Trainer``);

then a validation eval (K1 again), a checkpoint, and strict
best-by-Recall@5 selection. The run ends with PCA-whitening fitted on the
best model's training descriptors and a test-split eval through it.

The JAX package's draws are kept: subsets from ``RandomState(seed +
epoch)``, the sampler's from ``RandomState(seed + epoch)``, jitter from
(seed, epoch, subset), so on one dataset both packages see the same
subsets, candidates and pixels. Checkpoints are the JAX package's .npz
(parameters in its layouts); the port's SGD momentum sits beside them.

``run_sfrs_training`` trains generations of student/teacher
self-distillation (SFRS) over an ``EmbedRegionNet``: per generation the
teacher is a frozen copy of the student, the student re-initializes from
the run's initial parameters with a fresh SGD and StepLR, gen 0 trains its
last epoch only; gen 0 mines on descriptor distances alone, gen >= 1 adds
difficult positives promoted by k-reciprocal Jaccard distances over the
q∪g union (ops.rerank). Mining and evaluation go through K1 as above;
training through the eager head. Checkpoints
``checkpoint{gen}_{epoch}.npz`` hold the student, the optimizer state
(the JAX package's optax layout), the teacher and the negative cache, so
either package resumes the other's run mid-generation.

With ``device_jitter`` the tuples arrive as raw uint8 and ColorJitter runs
on the device, each step's draws from a generator keyed by (seed, epoch,
subset, step), (seed, generation, epoch, subset, step) in SFRS, where the
JAX package folds its key: a resumed run draws the same pixels.

``run_eval`` evaluates a checkpoint (port of the JAX package's
``run_eval``): fixed-shape query and gallery passes through K1, or for
Tokyo 24/7 bucket-padded queries through the masked forward (eager head)
and the gallery through K1; PCA-whitening loaded or fitted on demand;
spatial NMS; the k-reciprocal rerank. With a mesh (parallel.mesh) the
extractions and the kNN are split over its ranks.

With a mesh (``parallel.mesh.get_mesh``, one device a rank) both
trainings run data-parallel, as the reference under ``torch.distributed``:
every rank builds the model and takes rank 0's parameters
(``broadcast_module``, again after a resume, with the SGD momentum); the
mining, validation and PCA extractions are split over the ranks; every
rank mines, and rank 0's tuples and negative cache are broadcast (the
card's Jaccard sweep sums with atomics, so two cards may order near-ties
differently); each rank trains on its rows of every global batch
(``_local_tuple_stream``) with the gradients averaged over the ranks; only
rank 0 writes files and prints, and a barrier orders each write before
its readers.
"""

import os
import os.path as osp

import numpy as np
import torch

from openibl_tpu_torch import data as datasets
from openibl_tpu_torch import models
from openibl_tpu_torch.data.loader import (
    BatchLoader, ImageSource, PaddedBatchLoader, TupleLoader,
)
from openibl_tpu_torch.data.sampler import (DiffTupleSampler, TupleSampler,
                                            shard_tuples)
from openibl_tpu_torch.data.transforms import TestTransform, TrainTransform
from openibl_tpu_torch.engine.evaluator import Evaluator
from openibl_tpu_torch.engine.sfrs import SFRSTrainer, make_teacher
from openibl_tpu_torch.engine.trainer import Trainer
from openibl_tpu_torch.models import convert
from openibl_tpu_torch.ops import pca as pca_ops
from openibl_tpu_torch.ops.distance import pairwise_sqdist
from openibl_tpu_torch.ops.kmeans import kmeans
from openibl_tpu_torch.ops.rerank import build_v_sparse, jaccard_for_queries
from openibl_tpu_torch.parallel.extract import extract_features_sharded
from openibl_tpu_torch.parallel.mesh import (barrier, broadcast_module,
                                             broadcast_object,
                                             broadcast_tensors,
                                             check_replicated, run_device)
from openibl_tpu_torch.utils import (array_file, f32_precision, read_arrays,
                                     to_numpy, write_arrays)
from openibl_tpu_torch.utils.checkpoint import (
    load_npz_tree, read_checkpoint, save_checkpoint,
)
from openibl_tpu_torch.utils.profiling import PhaseTimer
from openibl_tpu_torch.utils.watchdog import Watchdog

# warns loudly on hung device phases
_WATCHDOG = Watchdog(warn_after=600.0)


def _apply_iters_cap(tuples, iters, tuple_size):
    """Reference --iters semantics: exactly ``iters`` train iterations per
    subset; a short tuple list repeats, not truncates."""
    if iters <= 0 or not tuples:
        return tuples
    need = iters * tuple_size
    reps = -(-need // len(tuples))  # ceil
    return (list(tuples) * reps)[:need]


def _local_tuple_stream(tuples, tuple_size, mesh):
    """This rank's part of the mined tuple stream and its batch size: the
    stream itself without a mesh or at world size 1; else its rows of every
    global batch (``shard_tuples``) and tuple_size / size tuples a step."""
    if mesh is None or mesh.size == 1:
        return tuples, tuple_size
    return (shard_tuples(tuples, tuple_size, mesh.size, mesh.rank),
            tuple_size // mesh.size)


def _rank0_tuples(mesh, sampler):
    """Rank 0's freshly mined tuples and negative cache on every rank (its
    ``sampler`` updated); the sampler's own without a group. Every rank has
    drawn the same numbers from its ``sampler.rng``, so the samplers stay
    in step."""
    sampler.tuples, sampler.neg_cache = broadcast_object(
        mesh, (sampler.tuples, sampler.neg_cache))
    return sampler.tuples


def _is_rank0(mesh):
    return mesh is None or mesh.rank == 0


# ---------------------------------------------------------------------------
# setup helpers
# ---------------------------------------------------------------------------

def load_dataset(cfg):
    root = osp.join(cfg.data.data_dir, cfg.data.dataset)
    kwargs = {}
    if cfg.data.dataset == "pitts":
        kwargs["scale"] = cfg.data.scale
    return datasets.create(cfg.data.dataset, root, **kwargs)


def bootstrap_centroids(cfg, dataset, base, n_images=500, per_image=100,
                        seed=43, mesh=None):
    """NetVLAD centroid bootstrap: conv5 descriptors sampled from random
    train images (``base`` on its device, f32 maps), k-means on the same
    device. Returns (centroids (K, C), descriptors (N, C)) numpy f32.

    Reads or writes the JAX package's cache
    ({arch}_{dataset}_{k}_desc_cen.hdf5 with 'centroids' + 'descriptors';
    .npz under the same name where h5py is not installed,
    ``utils.array_file``). With a ``mesh`` rank 0 decides whether the
    cache exists; without it every rank bootstraps, rank 0 writes the
    cache and a barrier holds the ranks until it is written."""
    cache = array_file(osp.join(
        cfg.init_dir,
        f"{cfg.arch}_{cfg.data.dataset}_{cfg.num_clusters}_desc_cen.hdf5"))
    if broadcast_object(mesh, osp.isfile(cache)):
        return tuple(read_arrays(cache, ("centroids", "descriptors")))

    items = sorted(set(dataset.q_train) | set(dataset.db_train))
    rng = np.random.RandomState(seed)
    pick = rng.choice(len(items), min(n_images, len(items)), replace=False)
    src = ImageSource(
        [items[i] for i in pick], root=dataset.images_dir,
        transform=TestTransform(cfg.data.height, cfg.data.width),
    )
    dev = next(base.parameters()).device
    descs = []
    with torch.no_grad(), f32_precision():
        for images, _, count in BatchLoader(src,
                                            batch_size=cfg.data.test_batch_size,
                                            prefetch=cfg.data.workers):
            fmap = base(torch.from_numpy(images).to(dev))[1][:count]
            fmap = fmap.float().cpu().numpy()
            n, h, w, c = fmap.shape
            flat = fmap.reshape(n, h * w, c)
            flat = flat / np.maximum(
                np.linalg.norm(flat, axis=-1, keepdims=True), 1e-12)
            for img_desc in flat:
                sample = rng.choice(h * w, min(per_image, h * w),
                                    replace=False)
                descs.append(img_desc[sample])
        descs = np.concatenate(descs).astype(np.float32)
        centroids, _ = kmeans(torch.from_numpy(descs).to(dev),
                              cfg.num_clusters, iters=100, seed=seed)
    if _is_rank0(mesh):
        os.makedirs(cfg.init_dir, exist_ok=True)
        write_arrays(cache, {"descriptors": descs, "centroids": centroids})
    barrier(mesh)
    return centroids, descs


def new_embednet(cfg, rng_seed=0, region=False):
    """The EmbedNet of ``cfg`` (``arch`` in ``compute_dtype``,
    ``num_clusters``) from a seeded random init, on the CPU; with
    ``region`` the EmbedRegionNet (SFRS) of ``cfg.tuple_size``."""
    gen = torch.Generator().manual_seed(rng_seed)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    base = models.create(cfg.arch, compute_dtype=dtype, generator=gen)
    nv = models.NetVLAD(num_clusters=cfg.num_clusters, generator=gen)
    if region:
        return models.create("embedregionnet", base=base, net_vlad=nv,
                             tuple_size=cfg.tuple_size)
    return models.create("embednet", base=base, net_vlad=nv)


def build_model(cfg, dataset, device, rng_seed=0, region=False, mesh=None):
    """Backbone + NetVLAD with centroid init, on ``device``, layers before
    ``cfg.train_layers`` frozen. Returns the EmbedNet (the EmbedRegionNet
    with ``region``). With a ``mesh`` every rank holds rank 0's parameters
    and buffers (``broadcast_module``).

    The backbone starts from the MatConvNet VGG16 the reference trains from
    when ``{init_dir}/vd16_offtheshelf_conv5_3_max.pth`` exists (loaded
    weights-only), from a seeded random init otherwise."""
    model = new_embednet(cfg, rng_seed, region)
    base, nv = model.base, model.net_vlad
    matconvnet = osp.join(cfg.init_dir, "vd16_offtheshelf_conv5_3_max.pth")
    if osp.isfile(matconvnet):
        state = convert.vgg16_state_from_torch(
            convert.load_torch_checkpoint(matconvnet))
        model.load_state_dict(state, strict=False)
    base.freeze(cfg.train_layers)
    model.to(device, memory_format=torch.channels_last)
    clsts, traindescs = bootstrap_centroids(cfg, dataset, base, mesh=mesh)
    init = models.netvlad_init_from_clusters(clsts, traindescs)
    with torch.no_grad():
        nv.assign_w.copy_(init["assign_w"])
        nv.centroids.copy_(init["centroids"])
    return broadcast_module(mesh, model)


def eval_view(model):
    """``model`` with the fused NetVLAD head (K1) for no-grad extraction
    and eval when its parameters live on a CUDA device (the JAX package
    switches its fused head on for the TPU the same way); ``model`` itself
    otherwise. The view shares every parameter with ``model``."""
    nv = model.net_vlad
    if nv.fused or next(model.parameters()).device.type != "cuda":
        return model
    fused = models.NetVLAD(nv.num_clusters, nv.dim, nv.normalize_input,
                           fused=True)
    fused.assign_w, fused.centroids = nv.assign_w, nv.centroids
    return models.EmbedNet(base=model.base, net_vlad=fused)


def _use_device_jitter(cfg):
    return cfg.device_jitter and cfg.augment


def make_sources(cfg, dataset):
    """uint8 images (the mean is subtracted on the device); the train
    transform's jitter stream is seeded and re-seeded per subset.
    ``augment=False`` turns ColorJitter off."""
    train_tf = TrainTransform(cfg.data.height, cfg.data.width,
                              jitter=cfg.augment and not cfg.device_jitter,
                              device_normalize=True, seed=cfg.seed)
    test_tf = TestTransform(cfg.data.height, cfg.data.width,
                            device_normalize=True)
    train_items = dataset.q_train + dataset.db_train
    return {
        "tuple": ImageSource(train_items, dataset.images_dir, train_tf),
        "q_train": ImageSource(dataset.q_train, dataset.images_dir, test_tf),
        "db_train": ImageSource(dataset.db_train, dataset.images_dir, test_tf),
        "q_val": ImageSource(dataset.q_val, dataset.images_dir, test_tf),
        "db_val": ImageSource(dataset.db_val, dataset.images_dir, test_tf),
        "q_test": ImageSource(dataset.q_test, dataset.images_dir, test_tf),
        "db_test": ImageSource(dataset.db_test, dataset.images_dir, test_tf),
    }


def _subset_splits(n_query, cache_size, epoch, step_size, seed,
                   tuple_size=1):
    """Shuffled query subsets of (possibly grown) cache size per epoch. A
    cache_size below tuple_size is clamped to the full query set (else no
    subset mines one batch and training takes no step)."""
    if cache_size < tuple_size or cache_size > n_query:
        cache_size = n_query
    size = min(max(cache_size * (2 ** (epoch // step_size)), 1), n_query)
    rng = np.random.RandomState(seed + epoch)
    perm = rng.permutation(n_query)
    # each subset is SORTED: extraction returns features in ascending index
    # order, and the sampler pairs feature row r with subset[r]
    return [np.sort(perm[s : s + size]) for s in range(0, n_query, size)]


def _extract(model, source, cfg, feature, indices=None, pca=None,
             mesh=None):
    """Descriptors of ``source`` (rows in ascending index order), kept on
    the model's device; split over the ranks of ``mesh``."""
    return extract_features_sharded(
        model, source, indices, cfg.data.test_batch_size, mesh=mesh, pca=pca,
        feature=feature, prefetch=cfg.data.workers, device_output=True)


def _load_params(model, params):
    """A JAX-layout parameter tree into ``model``, in place."""
    model.load_state_dict(convert.params_from_jax(params))


# ---------------------------------------------------------------------------
# baseline training (triplet / SARE)
# ---------------------------------------------------------------------------

def run_baseline_training(cfg, device="cuda", mesh=None, verbose=True,
                          timer=None):
    """Train, select the best epoch, fit PCA and evaluate the test split.

    Runs on ``device`` (the card by default; without one this raises
    unless ``device="cpu"``), or data-parallel over the ranks of ``mesh``
    (each on its own device of ``device``'s type). Returns (model, final
    test recalls, history [(epoch, val recalls)]); the model holds the best
    epoch's parameters.
    """
    device = run_device(device, mesh)
    verbose = verbose and _is_rank0(mesh)
    timer = timer if timer is not None else PhaseTimer(device)
    dataset = load_dataset(cfg)
    sources = make_sources(cfg, dataset)
    model = build_model(cfg, dataset, device, mesh=mesh)
    emodel = eval_view(model)
    feature = "vlad" if cfg.use_vlad else "pool"
    evaluator = Evaluator(emodel, feature=feature, mesh=mesh)

    trainer = Trainer(
        model, loss_type=cfg.loss_type, margin=cfg.margin, lr=cfg.lr,
        momentum=cfg.momentum, weight_decay=cfg.weight_decay, mesh=mesh,
        use_pool_feature=not cfg.use_vlad, remat=cfg.remat,
        device_jitter=_use_device_jitter(cfg),
    )
    trainer.check_batch_shape(cfg.tuple_size)
    trainer.init()
    sampler = TupleSampler(
        len(dataset.q_train), len(dataset.db_train),
        dataset.train_pos, dataset.train_neg,
        neg_num=cfg.neg_num, neg_pool=cfg.neg_pool, seed=cfg.seed,
    )

    start_epoch, best_recall5 = 0, 0.0
    if cfg.resume:
        tree, meta = read_checkpoint(cfg.resume)
        _load_params(model, tree["params"])
        if "torch_sgd" in tree:  # a JAX checkpoint restarts the momentum
            trainer.load_momentum_state(
                convert.params_from_jax(tree["torch_sgd"]["momentum"]))
        _replicate_trainer(mesh, trainer)
        sampler.neg_cache = np.asarray(tree["neg_cache"])
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_recall5 = float(meta.get("best_recall5", 0.0))

    bs, pf = cfg.data.test_batch_size, cfg.data.workers
    history = []
    for epoch in range(start_epoch, cfg.epochs):
        sampler.set_epoch(cfg.seed + epoch)
        trainer.set_epoch_lr(epoch, cfg.step_size, cfg.gamma)
        for subid, subset in enumerate(
            _subset_splits(len(dataset.q_train), cfg.cache_size, epoch,
                           cfg.step_size, cfg.seed, cfg.tuple_size)
        ):
            with _WATCHDOG.watch(f"mining extraction epoch {epoch}-{subid}"), \
                    timer.phase("mining_extract"):
                g_feats = _extract(emodel, sources["db_train"], cfg, feature,
                                   mesh=mesh)
                q_feats = _extract(emodel, sources["q_train"], cfg, feature,
                                   indices=subset, mesh=mesh)
            with timer.phase("mining_refresh"):
                sampler.refresh(q_feats, g_feats, subset)
                tuples = _rank0_tuples(mesh, sampler)
            # the tuples are host lists now: free the (G, D) gallery before
            # training needs the memory (~11 GB at Pitts250k, 32768-d)
            del g_feats, q_feats
            tuples = _apply_iters_cap(tuples, cfg.iters, cfg.tuple_size)
            sources["tuple"].transform.reseed(cfg.seed, epoch, subid)
            loader = TupleLoader(sources["tuple"], *_local_tuple_stream(
                tuples, cfg.tuple_size, mesh), prefetch=pf)
            with timer.phase("train"):
                avg_loss = trainer.train_epoch(
                    loader, print_freq=cfg.print_freq,
                    log_prefix=f"Epoch [{epoch}-{subid}]",
                    rng=(cfg.seed, epoch, subid))
            if verbose:
                print(f"Epoch [{epoch}-{subid}] avg loss {avg_loss:.4f}")

        if verbose:
            print(timer.summary())
        if (epoch + 1) % cfg.eval_step == 0 or epoch == cfg.epochs - 1:
            with timer.phase("eval"):
                recalls = evaluator.evaluate_sources(
                    sources["q_val"], sources["db_val"], dataset.val_pos,
                    batch_size=bs, prefetch=pf, print_results=verbose)
            history.append((epoch, recalls))
            is_best = recalls[1] > best_recall5
            best_recall5 = max(recalls[1], best_recall5)
            if _is_rank0(mesh):
                save_checkpoint(
                    osp.join(cfg.logs_dir, f"checkpoint{epoch}.npz"),
                    {"params": convert.params_to_jax(model.state_dict()),
                     "torch_sgd": {"momentum": convert.params_to_jax(
                         trainer.momentum_state())},
                     "neg_cache": sampler.neg_cache},
                    {"epoch": epoch, "best_recall5": float(best_recall5)},
                    is_best=is_best,
                )
            if verbose:
                print(
                    f" * epoch {epoch} recall@1/5/10: "
                    f"{recalls[0]:.1%}/{recalls[1]:.1%}/{recalls[2]:.1%} "
                    f"best@5 {best_recall5:.1%}{' *' if is_best else ''}")

    # final: PCA on the best model, test-split eval
    _load_best(cfg, model, mesh)
    recalls = finalize_with_pca(cfg, dataset, sources, model, verbose=verbose,
                                mesh=mesh)
    return model, recalls, history


def _replicate_trainer(mesh, trainer):
    """After a resume: rank 0's parameters and SGD momentum on every rank
    (each rank read the same file; the broadcast makes it so)."""
    broadcast_module(mesh, trainer.model)
    broadcast_tensors(mesh, trainer.momentum_state().values())


def _load_best(cfg, model, mesh):
    """The best checkpoint's parameters into ``model``, if rank 0 wrote
    one; every rank waits for rank 0's writes first."""
    barrier(mesh)
    best_path = osp.join(cfg.logs_dir, "model_best.npz")
    if broadcast_object(mesh, osp.isfile(best_path)):
        _load_params(model, read_checkpoint(best_path)[0]["params"])


def _train_pca(feats, pca_dim, whiten, params_path, seed):
    """PCA fit on at most 10k descriptors (a seeded subsample), with the
    component count clamped to the data."""
    if len(feats) > 10000:
        sel = np.random.RandomState(seed).choice(len(feats), 10000,
                                                 replace=False)
        feats = feats[torch.as_tensor(sel, device=feats.device)]
    pca = pca_ops.PCA(min(pca_dim, feats.shape[0], feats.shape[1]),
                      whiten=whiten, params_path=params_path)
    pca.train(feats)
    return pca


def finalize_with_pca(cfg, dataset, sources, model, verbose=True,
                      mesh=None):
    """Fit PCA-whitening on the training split's descriptors and evaluate
    the test split with the reduction (pool or VLAD feature per
    ``cfg.use_vlad``). The fit is saved as pca_params_model_best.h5 in
    ``cfg.logs_dir`` (``utils.array_file``). With a ``mesh`` the
    extractions are split over its ranks, every rank fits the same PCA on
    the gathered descriptors, rank 0 writes it and only rank 0 prints."""
    feature = "vlad" if cfg.use_vlad else "pool"
    verbose = verbose and _is_rank0(mesh)
    emodel = eval_view(model)
    feats = torch.cat([_extract(emodel, sources[name], cfg, feature,
                                mesh=mesh)
                       for name in ("q_train", "db_train")])
    pca = _train_pca(
        feats, cfg.pca_dim, cfg.whiten,
        array_file(osp.join(cfg.logs_dir, "pca_params_model_best.h5"))
        if _is_rank0(mesh) else None, cfg.seed)
    del feats
    if verbose:
        print("Testing with PCA reduction:")
    return Evaluator(emodel, feature=feature, mesh=mesh).evaluate_sources(
        sources["q_test"], sources["db_test"], dataset.test_pos, pca=pca,
        batch_size=cfg.data.test_batch_size, prefetch=cfg.data.workers,
        print_results=verbose,
    )


# ---------------------------------------------------------------------------
# SFRS training
# ---------------------------------------------------------------------------

def _jaccard_rows(q_all, g_feats, subset, rerank_lambda):
    """(S, G) numpy Jaccard distances of the subset anchors to the gallery
    over the q∪g union of descriptors on one device (k1 = 20; with
    ``rerank_lambda`` mixed with the row-normalized squared distances), for
    DiffTupleSampler.refresh."""
    nq = len(q_all)
    union = torch.cat([q_all, g_feats])
    rows, cols, vals, _, rm2 = build_v_sparse(union, k1=20)
    sub = np.asarray(subset)
    jac = jaccard_for_queries(rows, cols, vals, len(union), sub,
                              device=union.device)
    if rerank_lambda:
        with f32_precision():
            d2_sub = to_numpy(pairwise_sqdist(
                union[torch.as_tensor(sub, device=union.device)], union))
        jac = jac * (1 - rerank_lambda) + (
            np.square(np.maximum(d2_sub, 0.0)) / rm2[sub][:, None]
        ) * rerank_lambda
    # a copy: the (S, N) matrix and the V triplet are freed on return
    return np.ascontiguousarray(jac[:, nq:])


def run_sfrs_training(cfg, device="cuda", mesh=None, verbose=True,
                      timer=None):
    """Train ``cfg.generations`` generations of SFRS, select the best
    (validation Recall@5, strict), fit PCA and evaluate the test split.

    Runs on ``device`` (the card by default; without one this raises
    unless ``device="cpu"``), or data-parallel over the ranks of ``mesh``
    as ``run_baseline_training`` (every rank computes the Jaccard rows on
    the gathered descriptors; rank 0's tuples supersede them). ``timer``
    (a ``utils.profiling.PhaseTimer``) gets the phases "mining_extract",
    "mining_jaccard" (gen >= 1), "mining_refresh", "train" and "eval".
    Returns (model, final test recalls); the model (an EmbedRegionNet)
    holds the best checkpoint's parameters."""
    if not cfg.use_vlad:
        raise ValueError("SFRS training is defined on the VLAD feature "
                         "(the reference hardcodes vlad=True); "
                         "use_vlad=False is only supported by the baseline")
    if len(cfg.temperature) < cfg.generations:
        raise ValueError(
            f"SFRS needs one teacher temperature per generation: got "
            f"{len(cfg.temperature)} temps for {cfg.generations} generations")
    device = run_device(device, mesh)
    verbose = verbose and _is_rank0(mesh)
    timer = timer if timer is not None else PhaseTimer(device)
    dataset = load_dataset(cfg)
    sources = make_sources(cfg, dataset)
    model = build_model(cfg, dataset, device, region=True, mesh=mesh)
    emodel = eval_view(model)
    # the re-init source of every generation's student (rank 0's)
    pristine = {k: v.detach().clone() for k, v in model.state_dict().items()}
    evaluator = Evaluator(emodel, mesh=mesh)
    trainer = SFRSTrainer(
        model, loss_type=cfg.loss_type, margin=cfg.margin,
        temps=cfg.temperature, soft_weight=cfg.soft_weight,
        neg_num=cfg.neg_num, lr=cfg.lr, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, mesh=mesh, remat=cfg.remat,
        device_jitter=_use_device_jitter(cfg),
    )
    trainer.check_batch_shape(cfg.tuple_size)
    sampler = DiffTupleSampler(
        len(dataset.q_train), len(dataset.db_train),
        dataset.train_pos, dataset.train_neg,
        pos_num=cfg.pos_num, pos_pool=cfg.pos_pool,
        neg_num=cfg.neg_num, neg_pool=cfg.neg_pool, seed=cfg.seed,
    )

    best_recall5 = 0.0
    start_gen, resume, resume_epoch = 0, None, None
    if cfg.resume:
        # the student, its optimizer state, the teacher and the mining cache,
        # mid-generation (the teacher is the checkpoint's, not a copy of the
        # resumed student)
        resume, meta = read_checkpoint(cfg.resume)
        sampler.neg_cache = np.asarray(resume["neg_cache"])
        start_gen = int(meta.get("generation", 0))
        resume_epoch = int(meta.get("epoch", -1)) + 1
        best_recall5 = float(meta.get("best_recall5", 0.0))

    bs, pf = cfg.data.test_batch_size, cfg.data.workers
    for gen in range(start_gen, cfg.generations):
        if resume is not None and gen == start_gen:
            _load_params(model, resume["params"])
            teacher = make_teacher(model)
            _load_params(teacher, resume["teacher"])
            trainer.init_generation()
            trainer.load_jax_opt_state(resume["opt_state"],
                                       convert.params_from_jax)
            _replicate_trainer(mesh, trainer)
            start_epoch = resume_epoch
            resume = None
        else:
            # teacher ← student; the student re-initializes; a fresh SGD
            teacher = make_teacher(model)
            model.load_state_dict(pristine)
            trainer.init_generation()
            start_epoch = cfg.epochs - 1 if gen == 0 else 0
        check_replicated(mesh, teacher.state_dict().values(),
                         f"generation {gen}'s teacher")

        for epoch in range(start_epoch, cfg.epochs):
            sampler.set_epoch(cfg.seed + epoch)
            # a fresh StepLR each generation; gen 0 trains its one epoch at
            # the base rate (its schedule has taken no step)
            trainer.set_epoch_lr(0 if gen == 0 else epoch, cfg.step_size,
                                 cfg.gamma)
            for subid, subset in enumerate(
                _subset_splits(len(dataset.q_train), cfg.cache_size, epoch,
                               cfg.step_size, cfg.seed, cfg.tuple_size)
            ):
                jaccard_rows = None
                with _WATCHDOG.watch(f"mining extraction gen {gen} epoch "
                                     f"{epoch}-{subid}"), \
                        timer.phase("mining_extract"):
                    g_feats = _extract(emodel, sources["db_train"], cfg,
                                       "vlad", mesh=mesh)
                    # gen >= 1 needs every query for the Jaccard union
                    q_feats = _extract(emodel, sources["q_train"], cfg,
                                       "vlad",
                                       indices=None if gen else subset,
                                       mesh=mesh)
                if gen > 0:
                    with timer.phase("mining_jaccard"):
                        jaccard_rows = _jaccard_rows(
                            q_feats, g_feats, subset, cfg.rerank_lambda)
                        q_feats = q_feats[torch.as_tensor(
                            subset, device=q_feats.device)]
                with timer.phase("mining_refresh"):
                    sampler.refresh(q_feats, g_feats, subset,
                                    jaccard_rows=jaccard_rows)
                    tuples = _rank0_tuples(mesh, sampler)
                # the tuples are host lists now: free the mining buffers
                # before training needs the memory
                del g_feats, q_feats, jaccard_rows
                tuples = _apply_iters_cap(tuples, cfg.iters, cfg.tuple_size)
                sources["tuple"].transform.reseed(cfg.seed, gen, epoch, subid)
                loader = TupleLoader(sources["tuple"], *_local_tuple_stream(
                    tuples, cfg.tuple_size, mesh), prefetch=pf)
                with timer.phase("train"):
                    lh, ls = trainer.train_epoch(
                        teacher, loader, gen, print_freq=cfg.print_freq,
                        log_prefix=f"Gen {gen} Epoch [{epoch}-{subid}]",
                        rng=(cfg.seed, gen, epoch, subid))
                if verbose:
                    print(f"Gen {gen} Epoch [{epoch}-{subid}] "
                          f"hard {lh:.4f} soft {ls:.4f}")

            if verbose:
                print(timer.summary())
            if not ((epoch + 1) % cfg.eval_step == 0
                    or epoch == cfg.epochs - 1):
                continue
            with timer.phase("eval"):
                recalls = evaluator.evaluate_sources(
                    sources["q_val"], sources["db_val"], dataset.val_pos,
                    batch_size=bs, prefetch=pf, print_results=verbose)
            is_best = recalls[1] > best_recall5
            best_recall5 = max(recalls[1], best_recall5)
            if _is_rank0(mesh):
                save_checkpoint(
                    osp.join(cfg.logs_dir, f"checkpoint{gen}_{epoch}.npz"),
                    {"params": convert.params_to_jax(model.state_dict()),
                     "opt_state": trainer.jax_opt_state(
                         convert.params_to_jax),
                     "teacher": convert.params_to_jax(teacher.state_dict()),
                     "neg_cache": sampler.neg_cache},
                    {"epoch": epoch, "generation": gen,
                     "best_recall5": float(best_recall5)},
                    is_best=is_best,
                )
            if verbose:
                print(f" * gen {gen} epoch {epoch} recall@1/5/10: "
                      f"{recalls[0]:.1%}/{recalls[1]:.1%}/{recalls[2]:.1%}"
                      f"{' *' if is_best else ''}")

    _load_best(cfg, model, mesh)
    recalls = finalize_with_pca(cfg, dataset, sources, model, verbose=verbose,
                                mesh=mesh)
    return model, recalls


# ---------------------------------------------------------------------------
# evaluation entry
# ---------------------------------------------------------------------------

def _load_eval_weights(model, path):
    """A checkpoint's EmbedNet weights into ``model``: a JAX-layout .npz
    (bare model tree or pipeline ``params/...``) or a released reference
    .pth/.pth.tar (loaded weights-only). Every model tensor must come from
    the file; PCA-layer entries are left out (the reduction is its own
    file)."""
    if path.endswith((".pth", ".pth.tar")):
        state = convert.torch_checkpoint_state(path)
    else:
        state = convert.params_from_jax(load_npz_tree(path)[0])
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in state.items() if k in own})


def _eval_pca(cfg, model, feature, mesh=None):
    """The PCA-whitening of ``cfg``: loaded from ``cfg.pca_params`` or
    ``pca_params_<checkpoint stem>`` beside the checkpoint, else fitted on
    the train split of ``cfg.pca_dataset`` (default: Pitts30k for the
    pitts and tokyo evals, as the reference's test.py; the eval's own
    dataset otherwise) and written there (by rank 0 of ``mesh``; the
    extraction is split over its ranks and every rank fits the same)."""
    stem = osp.basename(cfg.checkpoint).split(".")[0] or "model"
    path = cfg.pca_params or array_file(osp.join(
        osp.dirname(cfg.checkpoint) or ".", f"pca_params_{stem}.h5"))
    if osp.isfile(path):
        return pca_ops.PCA(cfg.pca_dim, whiten=cfg.whiten, params_path=path)
    name = cfg.pca_dataset or (
        "pitts" if cfg.data.dataset in ("pitts", "tokyo")
        else cfg.data.dataset)
    scale = cfg.pca_scale or ("30k" if name == "pitts" else cfg.data.scale)
    kwargs = {"scale": scale} if name == "pitts" else {}
    pca_ds = datasets.create(name, osp.join(cfg.data.data_dir, name),
                             **kwargs)
    items = sorted(set(pca_ds.q_train) | set(pca_ds.db_train))
    src = ImageSource(items, pca_ds.images_dir,
                      TestTransform(cfg.data.height, cfg.data.width,
                                    device_normalize=True))
    feats = _extract(model, src, cfg, feature, mesh=mesh)
    rank = 0 if mesh is None else mesh.rank
    return _train_pca(feats, cfg.pca_dim, cfg.whiten,
                      path if rank == 0 else None, seed=0)


def run_eval(cfg, device="cuda", mesh=None, verbose=True, timer=None):
    """Evaluate ``cfg.checkpoint`` on ``cfg.data.dataset``'s test split:
    Recall@1/5/10, with PCA-whitening when ``cfg.reduction``, spatial
    NMS when ``cfg.nms`` and the k-reciprocal rerank (k1 ``cfg.rr_topk``,
    ``cfg.lambda_value``) when ``cfg.rerank``.

    Runs on ``device`` (the card by default; without one this raises
    unless ``device="cpu"``). The model is ``eval_view`` of the EmbedNet
    in ``cfg.compute_dtype``. Tokyo's variable-shape queries run
    bucket-padded through ``forward_masked``; every fixed-shape batch goes
    through K1 on the card. ``timer`` (a ``utils.profiling.PhaseTimer``)
    gets the phases "dataset", "pca_fit", "query", "gallery", "knn" and
    "rerank".

    With a ``mesh`` (``parallel.mesh.get_mesh``; its device of
    ``device``'s type) each rank runs on its own device, the PCA fit and
    the fixed-shape extractions are split over the ranks, the kNN is
    sharded, and only rank 0 prints. Across ranks Tokyo's queries are
    extracted whole on every rank (bucket-padded batches come out in an
    order the ranks cannot reassemble) and the gallery is split.
    """
    device = run_device(device, mesh)
    timer = timer if timer is not None else PhaseTimer(device)
    with timer.phase("dataset"):
        dataset = load_dataset(cfg)
    tokyo = cfg.data.dataset == "tokyo"
    h, w = cfg.data.height, cfg.data.width
    # uint8 pixels: the model subtracts the mean on the device
    q_src = ImageSource(dataset.q_test, dataset.images_dir,
                        TestTransform(h, w, tokyo=tokyo,
                                      device_normalize=True))
    db_src = ImageSource(dataset.db_test, dataset.images_dir,
                         TestTransform(h, w, device_normalize=True))

    model = new_embednet(cfg)
    if cfg.checkpoint:
        _load_eval_weights(model, cfg.checkpoint)
    model.to(device, memory_format=torch.channels_last).eval()
    model = eval_view(model)
    feature = "vlad" if cfg.use_vlad else "pool"

    pca = None
    if cfg.reduction:
        with timer.phase("pca_fit"):
            pca = _eval_pca(cfg, model, feature, mesh)

    bs, pf = cfg.data.test_batch_size, cfg.data.workers
    show = verbose and (mesh is None or mesh.rank == 0)
    evaluator = Evaluator(
        model, feature=feature,
        masked_apply_fn=model.forward_masked if tokyo else None, timer=timer,
        mesh=mesh)
    gallery_pids = [it[1] for it in dataset.db_test]
    scoring = dict(nms=cfg.nms, rerank=cfg.rerank, rr_topk=cfg.rr_topk,
                   lambda_value=cfg.lambda_value, print_results=show)
    if tokyo and (mesh is None or mesh.size == 1):
        return evaluator.evaluate(
            PaddedBatchLoader(q_src, batch_size=bs, prefetch=pf),
            BatchLoader(db_src, batch_size=bs, prefetch=pf),
            dataset.test_pos, gallery_pids, pca=pca, verbose=show, **scoring)
    if tokyo:
        with timer.phase("query"):
            q_feats = evaluator.extract(
                PaddedBatchLoader(q_src, batch_size=bs, prefetch=pf),
                pca=pca, verbose=show)
        with timer.phase("gallery"):
            g_feats = evaluator.extract_sharded(
                db_src, pca=pca, batch_size=bs, prefetch=pf, verbose=show)
        return evaluator.score(q_feats, g_feats, dataset.test_pos,
                               gallery_pids, **scoring)
    return evaluator.evaluate_sources(
        q_src, db_src, dataset.test_pos, gallery_pids, pca=pca,
        batch_size=bs, prefetch=pf, verbose=show, **scoring)
