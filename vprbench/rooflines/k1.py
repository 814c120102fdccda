"""K1, the fused NetVLAD head (csrc/netvlad.cu): one call takes a batch's
conv5_3 map to its intra- and globally normalised VLADs. Its work is the
two f32 products of the head (soft-assignment logits and aggregation) over
the map, with the map, the two weight matrices and the descriptors moved
once. At batch 16 and 480x640 (30 x 40 x 512, K = 64): 2.517 GFLOP and
41.68 MB, a bound of 0.01244 ms set by bytes."""

from vprbench.work import head_work

KERNEL = "K1"


def work(cfg, batch):
    h, w = cfg["height"] // 16, cfg["width"] // 16
    return head_work(batch, h * w, cfg["feature_dim"], cfg["num_clusters"])


def calls(launches, cfg):
    """Calls in a window of ``launches`` counted wrapper launches."""
    return launches
