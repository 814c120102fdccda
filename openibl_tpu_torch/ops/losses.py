"""Weakly-supervised retrieval losses of the baseline trainer (port of
openibl_tpu/ops/losses.py:19-57,131-139).

  * triplet    — hinge on L2 distances (margin = sqrt(0.1) in the recipe),
                 with the ``eps`` inside the norm as torch.pairwise_distance
  * sare_joint — softmax over −[d²⁺, d²₁⁻..d²ₙ⁻], NLL of the positive
  * sare_ind   — per-negative 2-way softmax, averaged

All take descriptors shaped (B, 2+neg, L): [anchor, positive, negatives...].
The dot-product variants and the SFRS losses come with the SFRS slice
(ROADMAP Queue 1 item 10).
"""

import torch


def _split_tuple(desc):
    return desc[:, 0], desc[:, 1], desc[:, 2:]  # anchors, positives, negatives


def _l2_dist(a, b, eps=1e-6):
    return torch.sqrt(torch.sum(torch.square(a - b + eps), dim=-1))


def triplet_loss(desc, margin):
    """F.triplet_margin_loss over every (anchor, positive, negative)."""
    a, p, n = _split_tuple(desc)
    d_pos = _l2_dist(a, p)[:, None]  # (B, 1)
    d_neg = _l2_dist(a[:, None], n)  # (B, neg)
    return torch.mean(torch.clamp(d_pos - d_neg + margin, min=0.0))


def _sq_dists(desc):
    a, p, n = _split_tuple(desc)
    d2_pos = torch.sum(torch.square(a - p), dim=-1)  # (B,)
    d2_neg = torch.sum(torch.square(a[:, None] - n), dim=-1)  # (B, neg)
    return d2_pos, d2_neg


def sare_joint_loss(desc):
    """Softmax over negated squared-euclidean distances."""
    d2_pos, d2_neg = _sq_dists(desc)
    logits = -torch.cat([d2_pos[:, None], d2_neg], dim=1)
    return torch.mean(-torch.log_softmax(logits, dim=1)[:, 0])


def sare_ind_loss(desc):
    """Per-negative two-way softmax, averaged."""
    d2_pos, d2_neg = _sq_dists(desc)
    pair = -torch.stack([d2_pos[:, None].expand_as(d2_neg), d2_neg], dim=-1)
    return torch.mean(-torch.log_softmax(pair, dim=-1)[..., 0])


def tuple_loss(desc, loss_type, margin=None):
    """The baseline trainer's loss by name."""
    if loss_type == "triplet":
        return triplet_loss(desc, margin)
    if loss_type == "sare_joint":
        return sare_joint_loss(desc)
    if loss_type == "sare_ind":
        return sare_ind_loss(desc)
    raise ValueError(f"unknown loss_type {loss_type}")
