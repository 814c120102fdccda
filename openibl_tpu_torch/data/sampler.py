"""Hard-negative tuple samplers: host orchestration + device mining (port of
openibl_tpu/data/sampler.py:29-218, ``TupleSampler`` and
``DiffTupleSampler``).

The host keeps the set-algebra state (candidate sampling by rejection, the
per-anchor negative cache) and draws from ``np.random.RandomState`` in the
JAX package's order, so one seed gives both packages the same candidates
and tuple order. The distances and choices run on the features' device
(ops.distance.mine_hard_tuples):

  positive  = nearest UTM-positive by current descriptors ("easiest")
  negatives = neg_num nearest among (neg_pool random gallery samples outside
              the UTM 25 m exclusion zone) ∪ (previous refresh's negatives)

``DiffTupleSampler`` (SFRS) adds ``pos_num`` difficult positives: the
anchor's ``pos_pool`` nearest positives, ranked on the device, of which it
keeps those the k-reciprocal Jaccard ordering promotes (numpy, stable
sorts). ``slice_indices`` cuts a dataset into the ranks' contiguous
slices for sharded extraction; ``shard_tuples`` gives each rank its rows
of every global tuple batch for the data-parallel step.
"""

import numpy as np

from openibl_tpu_torch.ops.distance import (mine_hard_tuples,
                                            mine_hard_tuples_ranked)
from openibl_tpu_torch.utils import pad_index_lists, to_numpy


class TupleSampler:
    """Mines (anchor, easiest-positive, neg_num hardest negatives) tuples."""

    def __init__(self, n_query, n_gallery, pos_list, neg_list,
                 neg_num=10, neg_pool=1000, seed=0):
        self.n_query = n_query
        self.n_gallery = n_gallery
        self.neg_num = neg_num
        self.neg_pool = neg_pool
        self.pos_padded, _ = pad_index_lists(pos_list)
        # exclusion sets: UTM "non-negatives" within 25 m, as sorted index
        # arrays for vectorized mask fills
        self.excl_arrays = [np.asarray(sorted(n), np.int64) for n in neg_list]
        # reusable per-anchor membership mask (marks excluded/picked ids)
        self._scratch = np.zeros(n_gallery, bool)
        self.neg_cache = np.full((n_query, neg_num), -1, np.int32)
        self.rng = np.random.RandomState(seed)
        self.tuples = []  # list of [anchor, pos+Q, negs...+Q] global indices

    def set_epoch(self, epoch):
        self.rng = np.random.RandomState(epoch)

    def _sample_candidates(self, sub_ids):
        """Per-anchor candidate negatives: neg_pool uniform samples without
        replacement from the allowed gallery ∪ cached negatives.

        Sequential with-replacement draws, rejecting excluded and
        already-picked ids and keeping first occurrences, are uniform
        sampling without replacement at O(|excl| + neg_pool) host work per
        anchor."""
        n_cand = self.neg_pool + self.neg_num
        cand = np.full((len(sub_ids), n_cand), -1, np.int32)
        want = self.neg_pool
        g = self.n_gallery
        scratch = self._scratch
        for row, a in enumerate(sub_ids):
            excl = self.excl_arrays[a]
            scratch[excl] = True
            if g - len(excl) <= want:
                # tiny allowed set: the sample is the whole set
                pool = np.flatnonzero(~scratch).astype(np.int32)
            else:
                pool = np.empty(want, np.int32)
                got = 0
                while got < want:
                    need = want - got
                    # oversample for the current rejection rate plus slack
                    frac = (len(excl) + got) / g
                    draw = self.rng.randint(
                        0, g,
                        size=int(need / max(1.0 - frac, 1e-9) * 1.1) + 16,
                    )
                    draw = draw[~scratch[draw]]
                    if draw.size == 0:
                        continue
                    uniq_first = np.sort(
                        np.unique(draw, return_index=True)[1]
                    )
                    draw = draw[uniq_first][:need]
                    scratch[draw] = True
                    pool[got : got + len(draw)] = draw
                    got += len(draw)
                scratch[pool] = False
            scratch[excl] = False
            cached = self.neg_cache[a]
            cached = cached[cached >= 0]
            merged = np.unique(np.concatenate([pool, cached]))
            cand[row, : len(merged)] = merged[:n_cand]
        return cand

    def refresh(self, q_sub_feats, g_feats, sub_ids):
        """Re-mine tuples for ``sub_ids`` anchors given current descriptors.

        q_sub_feats: (S, D) descriptors of the subset anchors;
        g_feats: (G, D) gallery descriptors (tensors on the device the
        mining runs on, or numpy arrays, mined on the CPU).
        """
        sub_ids = np.asarray(sub_ids)
        cand = self._sample_candidates(sub_ids)
        pos_choice, neg_choice = mine_hard_tuples(
            q_sub_feats, g_feats, self.pos_padded[sub_ids], cand,
            neg_num=self.neg_num)
        pos_choice = to_numpy(pos_choice)
        neg_choice = to_numpy(neg_choice)
        if (neg_choice < 0).any():
            raise ValueError(
                "not enough valid negative candidates for some anchors "
                "(gallery too small or exclusion zones too large); "
                "reduce neg_num or grow neg_pool/gallery"
            )
        self.neg_cache[sub_ids] = neg_choice
        q = self.n_query
        self.tuples = [
            [int(a), int(p) + q] + [int(n) + q for n in negs]
            for a, p, negs in zip(sub_ids, pos_choice, neg_choice)
        ]
        order = self.rng.permutation(len(self.tuples))
        self.tuples = [self.tuples[i] for i in order]
        return self.tuples



class DiffTupleSampler(TupleSampler):
    """SFRS sampler: tuples [anchor, positive, negatives..., difficult
    positives...] with ``pos_num`` difficult positives."""

    def __init__(self, n_query, n_gallery, pos_list, neg_list,
                 pos_num=10, pos_pool=20, neg_num=10, neg_pool=1000, seed=0):
        super().__init__(n_query, n_gallery, pos_list, neg_list, neg_num,
                         neg_pool, seed)
        self.pos_num = pos_num
        self.pos_pool = pos_pool

    @staticmethod
    def _jaccard_promoted(euclid_order, jac_dist, pos_num):
        """Positives promoted by the Jaccard ordering.

        euclid_order: (P,) gallery ids of the top-P positives, euclid-nearest
        first; jac_dist: (P,) their Jaccard distances. Keeps (in Jaccard
        order) the entries whose Jaccard rank beats their euclid rank (gap <
        0, most-promoted first), then those of equal rank, cut to pos_num.
        """
        p = len(euclid_order)
        jac_rank_to_euclid = np.argsort(jac_dist, kind="stable")  # (P,)
        gap = np.arange(p) - jac_rank_to_euclid
        neg_positions = np.arange(p)[gap < 0]
        neg_sorted = neg_positions[np.argsort(gap[gap < 0], kind="stable")]
        zero_positions = np.arange(p)[gap == 0]
        keep = np.concatenate([neg_sorted, zero_positions])[:pos_num]
        sel = jac_rank_to_euclid[keep]
        return euclid_order[sel]

    def refresh(self, q_sub_feats, g_feats, sub_ids, jaccard_rows=None):
        """Mine (anchor, top-1 positive, negatives, difficult positives)
        tuples. ``jaccard_rows``: optional (S, G) numpy Jaccard distances of
        the subset anchors to the gallery (ops.rerank); without them the
        difficult positives are the euclid-nearest ones (generation 0)."""
        sub_ids = np.asarray(sub_ids)
        cand = self._sample_candidates(sub_ids)
        # one device call: mining and the positive ranking share the (S, G)
        # distance matrix
        pos_choice, neg_choice, ranked_pos, _ = mine_hard_tuples_ranked(
            q_sub_feats, g_feats, self.pos_padded[sub_ids], cand,
            neg_num=self.neg_num, pos_pool=self.pos_pool)
        pos_choice = to_numpy(pos_choice)
        neg_choice = to_numpy(neg_choice)
        if (neg_choice < 0).any():
            raise ValueError(
                "not enough valid negative candidates for some anchors "
                "(gallery too small or exclusion zones too large); "
                "reduce neg_num or grow neg_pool/gallery"
            )
        ranked_pos = to_numpy(ranked_pos)
        self.neg_cache[sub_ids] = neg_choice

        q = self.n_query
        self.tuples = []
        for row, a in enumerate(sub_ids):
            order = ranked_pos[row]
            order = order[order >= 0]
            if jaccard_rows is not None:
                jd = jaccard_rows[row][order]
                diff_pos = self._jaccard_promoted(order, jd, self.pos_num)
            else:
                diff_pos = order[: self.pos_num]
            # pad by repeating the nearest positive if too few
            if len(diff_pos) < self.pos_num:
                fill = np.full(self.pos_num - len(diff_pos), order[0],
                               np.int64)
                diff_pos = np.concatenate([diff_pos, fill])
            self.tuples.append(
                [int(a), int(pos_choice[row]) + q]
                + [int(n) + q for n in neg_choice[row]]
                + [int(p) + q for p in diff_pos]
            )
        order = self.rng.permutation(len(self.tuples))
        self.tuples = [self.tuples[i] for i in order]
        return self.tuples


def slice_indices(n, n_shards, shard):
    """Shard ``shard``'s contiguous slice of range(n) for ``n_shards``
    ranks, each exactly ceil(n / n_shards) rows: the tail is padded by
    cycling the index list (``np.resize``), even when n < n_shards, so the
    rank-ordered concatenation of the slices starts with range(n)."""
    per = -(-n // n_shards)
    idx = np.resize(np.arange(n), per * n_shards)
    return idx[shard * per:(shard + 1) * per]


def shard_tuples(tuples, tuple_size, n_shards, shard):
    """Shard ``shard``'s part of the mined tuple stream, for ``n_shards``
    ranks: the stream is cut to whole global batches of ``tuple_size``
    tuples (the last partial batch dropped, as TupleLoader drops it in one
    process), and the shard takes rows [shard * per, (shard + 1) * per) of
    every global batch, per = tuple_size / n_shards. The rank-ordered
    concatenation of the shards' batches is the global batch, and every
    rank takes the same number of steps."""
    if tuple_size % n_shards:
        raise ValueError(
            f"tuple_size={tuple_size} must be a multiple of the process "
            f"count ({n_shards}) for multi-host tuple sharding"
        )
    per = tuple_size // n_shards
    n_whole = len(tuples) - len(tuples) % tuple_size
    out = []
    for s in range(0, n_whole, tuple_size):
        out.extend(tuples[s + shard * per:s + (shard + 1) * per])
    return out
