"""Weakly-supervised retrieval losses (port of openibl_tpu/ops/losses.py).

  * triplet    — hinge on L2 distances (margin = sqrt(0.1) in the recipe),
                 with the ``eps`` inside the norm as torch.pairwise_distance
  * sare_joint — softmax over −[d²⁺, d²₁⁻..d²ₙ⁻], NLL of the positive
  * sare_ind   — per-negative 2-way softmax, averaged
  * the dot-product variants with a temperature, the SFRS hard loss
    (gen 0: global descriptors; gen >= 1: each negative's hardest of its
    9 regions) and the soft self-distillation cross-entropy

The baseline losses take descriptors shaped (B, 2+neg, L): [anchor,
positive, negatives...].
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


# --- dot-product variants with a temperature (the SFRS losses) -------------

def sare_joint_dot_loss(anchors, positives, negatives, temp):
    """anchors/positives (B, L), negatives (B, neg, L)."""
    s_pos = torch.sum(anchors * positives, dim=-1, keepdim=True)  # (B, 1)
    s_neg = torch.einsum("bl,bnl->bn", anchors, negatives)  # (B, neg)
    logits = torch.cat([s_pos, s_neg], dim=1) / temp
    return torch.mean(-torch.log_softmax(logits, dim=1)[:, 0])


def sare_ind_dot_loss(anchors, positives, negatives, temp):
    s_pos = torch.sum(anchors * positives, dim=-1)  # (B,)
    s_neg = torch.einsum("bl,bnl->bn", anchors, negatives)  # (B, neg)
    pair = torch.stack([s_pos[:, None].expand_as(s_neg), s_neg],
                       dim=-1) / temp
    return torch.mean(-torch.log_softmax(pair, dim=-1)[..., 0])


def triplet_dot_loss(anchors, positives, negatives, margin):
    """The SFRS triplet variant (still euclidean)."""
    d_pos = _l2_dist(anchors, positives)[:, None]
    d_neg = _l2_dist(anchors[:, None], negatives)
    return torch.mean(torch.clamp(d_pos - d_neg + margin, min=0.0))


def sfrs_hard_loss(vlad_a, vlad_p, sim_easy, loss_type, temp, margin, gen):
    """SFRS hard loss over region descriptors.

    vlad_a (T, 1, 9, L) anchor regions, vlad_p (T, 1+neg, 9, L) the
    positive's and negatives' regions, sim_easy (T, 1+neg, 9, 9) anchor
    region x pair region scores. Gen 0 uses the global descriptors (region
    0); gen >= 1 takes each negative's region most similar to the anchor's
    global one (a detached argmax; the first of equal maxima)."""
    anchors = vlad_a[:, 0, 0]  # (T, L)
    positives = vlad_p[:, 0, 0]  # (T, L)
    if gen == 0:
        negatives = vlad_p[:, 1:, 0]  # (T, neg, L)
    else:
        hardest = torch.argmax(sim_easy[:, 1:, 0].detach(), dim=-1)
        idx = hardest[:, :, None, None].expand(-1, -1, 1, vlad_p.shape[-1])
        negatives = torch.gather(vlad_p[:, 1:], 2, idx)[:, :, 0]
    if loss_type == "sare_ind":
        return sare_ind_dot_loss(anchors, positives, negatives, temp)
    if loss_type == "sare_joint":
        return sare_joint_dot_loss(anchors, positives, negatives, temp)
    if loss_type == "triplet":
        return triplet_dot_loss(anchors, positives, negatives, margin)
    raise ValueError(f"unknown loss_type {loss_type}")


def sfrs_soft_loss(sim_student, sim_teacher, temp_student, temp_teacher):
    """Self-distillation cross-entropy between student and teacher region
    similarities, sim_* (T, pos, 9, 9): only the anchor-global row (region
    0) is distilled, flattened over (pos x 9 regions);
    sum(mean(-p_t * log_p_s, 0)) with the teacher's softmax detached."""
    t = sim_student.shape[0]
    logits_s = sim_student[:, :, 0].reshape(t, -1) / temp_student
    logits_t = sim_teacher[:, :, 0].reshape(t, -1) / temp_teacher
    log_p_s = torch.log_softmax(logits_s, dim=1)
    p_t = torch.softmax(logits_t, dim=1).detach()
    return torch.sum(torch.mean(-p_t * log_p_s, dim=0))


def tuple_loss(desc, loss_type, margin=None):
    """The baseline trainer's loss by name."""
    if loss_type == "triplet":
        return triplet_loss(desc, margin)
    if loss_type == "sare_joint":
        return sare_joint_loss(desc)
    if loss_type == "sare_ind":
        return sare_ind_loss(desc)
    raise ValueError(f"unknown loss_type {loss_type}")
