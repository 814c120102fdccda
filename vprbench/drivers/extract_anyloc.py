"""The AnyLoc gallery build through the index build's entry:
``parallel.extract.extract_features(model, loader, device_output=True)``
with the port's ``AnyLocVLAD``.

Set-up: from the seed (``vprbench.anyloc_inputs``), the weights under
DINOv2's names and the vocabulary (the harness's spherical k-means on the
plain reference's f32 facets of ``cluster_frames`` seeded frames), both
given to both sides; the model at the configuration's widths given them
by the port's DINOv2 loader (``build``); a resident gallery of
``index_rows`` x 49,152 seeded unit f32 rows on the card, and one shard of
``shard_batches`` batches of ``batch_size`` seeded uint8 frames on the
host; one batch through the entry to warm its shape. The window: the entry
called on the shard again and again until ``--seconds`` have passed, each
call's rows written into the gallery at the next offset (cycling), ended by
a synchronize. The check: whole batches drawn from the seed across the
window, the last one among them; the rows the gallery holds for them
against the plain f64 reference (``reference/anyloc.py``) under the margin
rule (``tie_margin``: a token whose top-two cosine margin is under it may
go either way, at most ``max_ambiguous`` such tokens an image), and the
cosines of the port's facets of the same frames, taken after the window,
against the reference's.
"""

import math
import sys

import numpy as np
import torch

from vprbench import anyloc_inputs, inputs
from vprbench.common import (Outcome, free, now, peak_bytes, reset_peak,
                             sync)
from vprbench.drivers.extract import ShardLoader
from vprbench.reference import anyloc as ref
from vprbench.reference.model import no_tf32


def build(cfg, weights, dev):
    """The port's ``AnyLocVLAD`` at the configuration's widths, through
    the model factory, given ``weights`` (DINOv2's names) by the port's
    own loader, as ``hub.anyloc_dinov2_vitg14`` builds it at the published
    widths."""
    from openibl_tpu_torch import models
    from openibl_tpu_torch.models.dinov2 import build_facet

    vit = build_facet(
        dev, weights, embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
        facet_block=cfg["facet_block"], ffn_hidden=cfg["ffn_hidden"],
        patch_size=cfg["patch_size"], pos_grid=cfg["pos_grid"],
        eps=cfg["layer_norm_eps"])
    return models.create("anyloc_dinov2_vitg14", backbone=vit,
                         num_clusters=cfg["vlad_clusters"]).to(dev).eval()


def numbers(ctx, saved, prec=None, desc=None):
    """The compared numbers of the written descriptors (or of ``desc``;
    or, with ``prec``, of the reference in that precision put in the
    port's place) against the f64 reference: the widest L2 gap to the
    nearest reference descriptor under the margin rule, the most tokens
    of one image within the margin of a tie, and the widest gap of a
    token's cosine with a centre."""
    cfg, mix = ctx.config, ctx.traffic
    w = anyloc_inputs.make_weights(ctx.seed, cfg, ctx.device)
    tokens = ref.facets(saved["frames"], w, cfg, "f64")
    centers = saved["centers"]
    if prec is not None:
        low = ref.facets(saved["frames"], w, cfg, prec)
        sims = [ref.cosines(t, centers, prec) for t in low]
        desc = torch.stack([ref.vlad(t, centers, s.argmax(-1))
                            for t, s in zip(low, sims)])
        del low
    else:
        sims = saved["port_sims"]
        desc = saved["desc"] if desc is None else desc
    del w
    free(ctx.device)
    gaps, most, total, sim_gap = [], 0, 0, 0.0
    for i, t in enumerate(tokens):
        gap, m = ref.nearest(desc[i], t, centers, mix["tie_margin"],
                             mix["max_ambiguous"])
        gaps.append(gap)
        most, total = max(most, m), total + m
        sim_gap = max(sim_gap, float((torch.as_tensor(sims[i]).to(
            t.device, t.dtype) - ref.cosines(t, centers)).abs().max()))
    if desc.shape[0] != len(tokens):
        gaps.append(math.inf)
    print(f"vprbench: {total} tokens of {len(tokens)} images within "
          f"{mix['tie_margin']} of a tie", file=sys.stderr)
    return {"desc_gap": max(gaps), "ambiguous_max": most,
            "sim_gap": sim_gap}


def check(ctx, saved):
    return numbers(ctx, saved)


def control(ctx, saved):
    """The control in the port's place: the reference in TF32."""
    return numbers(ctx, saved, prec="tf32")


def faults(ctx, saved):
    """The numbers of faults planted in the written descriptors: each
    batch's second half a copy of its first; one row of each batch moved
    off the unit sphere's point and renormalised."""
    bs = ctx.traffic["batch_size"]
    half, altered = saved["desc"].clone(), saved["desc"].clone()
    for s in range(0, len(half), bs):
        k = bs // 2
        half[s + k:s + bs] = saved["desc"][s:s + bs - k]
        altered[s + bs - 1] = torch.nn.functional.normalize(
            altered[s + bs - 1] + 0.05, dim=0)
    return {"half_batch": numbers(ctx, saved, desc=half),
            "answer_altered": numbers(ctx, saved, desc=altered)}


def write_rows(gallery, offset, rows):
    """``rows`` into ``gallery`` from ``offset`` on, wrapping at its end;
    returns the next offset."""
    cap, n = gallery.shape[0], rows.shape[0]
    first = min(n, cap - offset)
    gallery[offset:offset + first] = rows[:first]
    gallery[:n - first] = rows[first:]
    return (offset + n) % cap


def run(ctx):
    # the port's AnyLoc first: a port without it fails here, at once
    from openibl_tpu_torch.models.anyloc import AnyLocVLAD
    from openibl_tpu_torch.parallel.extract import extract_features

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    h, w, bs = cfg["height"], cfg["width"], mix["batch_size"]
    ctx.mark("the driver's imports")
    weights = anyloc_inputs.make_weights(ctx.seed, cfg, dev)
    ctx.mark("weights (harness)")
    shard = inputs.frames(inputs.stream(ctx.seed, "frames", dev),
                          mix["shard_batches"] * bs, h, w, dev)
    ctx.mark("frames (harness)")
    centers = anyloc_inputs.make_centers(ctx.seed, cfg, weights, dev)
    ctx.mark("vocabulary: k-means on the reference's facets (harness)")
    model = build(cfg, weights, dev)
    model.centers.copy_(centers)
    del weights
    free(dev)
    ctx.mark("models.create() and the DINOv2 weights (port)")
    reset_peak(dev)
    gallery = anyloc_inputs.make_gallery(ctx.seed, cfg["index_rows"],
                                         model.descriptor_dim, dev)
    ctx.mark("gallery (harness)")
    extract_features(model, ShardLoader(shard[:bs], bs), device_output=True)
    sync(dev)
    ctx.mark("warm-up: one batch (port)")
    setup_s = now() - ctx.t_start

    offsets, spans, offset = [], [], 0
    with ctx.tracer as tr:
        t0 = tr.open()
        before = AnyLocVLAD.images
        deadline = t0 + ctx.seconds
        while now() < deadline:
            s0 = now()
            out = extract_features(model, ShardLoader(shard, bs),
                                   device_output=True)
            offsets.append(offset)
            offset = write_rows(gallery, offset, out)
            spans.append(("extract_features", s0, now()))
        sync(dev)
        t1 = now()
        counted = AnyLocVLAD.images - before
    memory = peak_bytes(dev)
    images = len(offsets) * len(shard)

    batches = len(shard) // bs
    resident = max(1, gallery.shape[0] // len(shard))  # not overwritten
    first = max(0, len(offsets) - resident) * batches
    total = len(offsets) * batches
    rng = inputs.host_rng(ctx.seed, "check")
    pick = sorted(set((first + rng.choice(
        total - first, min(total - first, mix["check_batches"] - 1),
        replace=False)).tolist()) | {total - 1})
    rows = torch.cat([(offsets[b // batches] + (b % batches) * bs
                       + torch.arange(bs)) % gallery.shape[0] for b in pick])
    frames = np.concatenate([shard[(b % batches) * bs:(b % batches + 1) * bs]
                             for b in pick])
    desc = gallery[rows.to(dev)].cpu()
    del gallery, out
    free(dev)
    unit = torch.nn.functional.normalize(model.centers, dim=1)
    with torch.no_grad(), no_tf32():  # the port's facets, after the window
        sims = [(model.facets(torch.from_numpy(frames[s:s + bs]).to(dev))
                 @ unit.T).cpu() for s in range(0, len(frames), bs)]
    del model
    free(dev)
    saved = {"frames": frames, "desc": desc, "centers": centers,
             "port_sims": torch.cat(sims)}
    checks = check(ctx, saved)
    values = {"extract_images_per_s": images / (t1 - t0), "setup_s": setup_s}
    info = {"spans": spans, "images": images, "counted_images": counted,
            "window": (t0, t1), "saved": saved}
    return Outcome(attempted=total, failed=0, values=values, checks=checks,
                   memory_peak_bytes=memory, trace=ctx.tracer.trace,
                   info=info)
