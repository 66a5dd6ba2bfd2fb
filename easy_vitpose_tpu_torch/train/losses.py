"""Training losses (port of ``easy_vitpose_tpu/train/losses.py``; reference
vit_models/losses/).

The train loop uses :func:`joints_mse_loss` (reference
vit_utils/train_valid_fn.py:73); the rest of the reference's loss zoo that
its configs can reach is here with JAX's signatures, each a plain function
of batched tensors that any step takes as ``loss_fn`` where its shapes fit:
JointsOHKMMSELoss, CombinedTargetMSELoss, AdaptiveWingLoss, the regression
losses (SmoothL1, L1, MSE, Wing, SoftWing, bone, MPJPE, the semi-supervision
pair), BCE and the associative-embedding losses.  Every reduction runs in
float32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def joints_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    target_weight: torch.Tensor) -> torch.Tensor:
    """JointsMSELoss: the mean over (B, K, H*W) of ``(pred*w - target*w)^2``
    in float32, for (B, K, H, W) maps and (B, K, 1) weights."""
    B, K = pred.shape[:2]
    w = target_weight.reshape(B, K, 1).float()
    p = pred.reshape(B, K, -1).float() * w
    t = target.reshape(B, K, -1).float() * w
    return torch.mean((p - t) ** 2)


def _weighted_maps(pred, target, target_weight):
    B, K = pred.shape[:2]
    p = pred.reshape(B, K, -1).float()
    t = target.reshape(B, K, -1).float()
    if target_weight is not None:
        w = target_weight.reshape(B, K, 1).float()
        p, t = p * w, t * w
    return p, t


def joints_ohkm_mse_loss(pred, target, target_weight=None, topk: int = 8,
                         loss_weight: float = 1.0) -> torch.Tensor:
    """Online hard keypoint mining MSE (reference mse_loss.py:95-151): per
    sample, the mean of the ``topk`` largest per-joint MSEs."""
    p, t = _weighted_maps(pred, target, target_weight)
    per_joint = torch.mean((p - t) ** 2, dim=-1)
    top = torch.topk(per_joint, topk, dim=1).values
    return torch.mean(torch.sum(top, dim=1) / topk) * loss_weight


def combined_target_mse_loss(pred, target, target_weight, loss_weight: float = 1.0):
    """CombinedTarget (heatmap + offset triplets) MSE (reference
    mse_loss.py:47-93)."""
    B, C = pred.shape[:2]
    K = C // 3
    p = pred.reshape(B, K, 3, -1).float()
    t = target.reshape(B, K, 3, -1).float()
    w = target_weight.reshape(B, K, 1).float()
    hm_p, hm_t = p[:, :, 0] * w, t[:, :, 0] * w
    loss = 0.5 * torch.mean((hm_p - hm_t) ** 2)
    for i in (1, 2):
        loss = loss + 0.5 * torch.mean((hm_t * p[:, :, i] - hm_t * t[:, :, i]) ** 2)
    return loss * loss_weight


def adaptive_wing_loss(pred, target, target_weight=None, alpha: float = 2.1,
                       omega: float = 14.0, epsilon: float = 1.0, theta: float = 0.5,
                       loss_weight: float = 1.0) -> torch.Tensor:
    """Adaptive wing loss for heatmaps (reference heatmap_loss.py:6-88); the
    (B, K, 1) weight scales the maps before the loss."""
    p, t = pred.float(), target.float()
    if target_weight is not None:
        w = target_weight.reshape(*target_weight.shape[:2], 1, 1).float()
        p, t = p * w, t * w
    delta = torch.abs(t - p)
    a_pow = alpha - t
    A = (omega * (1 / (1 + (theta / epsilon) ** a_pow)) * a_pow
         * ((theta / epsilon) ** (a_pow - 1)) / epsilon)
    C = theta * A - omega * torch.log1p((theta / epsilon) ** a_pow)
    small = omega * torch.log1p((delta / epsilon) ** a_pow)
    loss = torch.where(delta < theta, small, A * delta - C)
    return torch.mean(loss) * loss_weight


def _weighted(pred, target, target_weight):
    """The reference's regression losses weight the inputs:
    ``criterion(output * w, target * w)``."""
    if target_weight is not None:
        return pred * target_weight, target * target_weight
    return pred, target


def smooth_l1_loss(pred, target, target_weight=None, loss_weight=1.0):
    """SmoothL1Loss (beta 1, mean)."""
    p, t = _weighted(pred, target, target_weight)
    d = torch.abs(p - t)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5)) * loss_weight


def l1_loss(pred, target, target_weight=None, loss_weight=1.0):
    p, t = _weighted(pred, target, target_weight)
    return torch.mean(torch.abs(p - t)) * loss_weight


def mse_regression_loss(pred, target, target_weight=None, loss_weight=1.0):
    p, t = _weighted(pred, target, target_weight)
    return torch.mean((p - t) ** 2) * loss_weight


def wing_loss(pred, target, target_weight=None, omega: float = 10.0, epsilon: float = 2.0,
              loss_weight: float = 1.0):
    """Wing loss (reference regression_loss.py:44-99): the per-sample sum
    over (K, D), then the batch mean."""
    p, t = _weighted(pred, target, target_weight)
    d = torch.abs(p - t)
    C = omega - omega * math.log(1.0 + omega / epsilon)
    loss = torch.where(d < omega, omega * torch.log(1.0 + d / epsilon), d - C)
    return torch.mean(torch.sum(loss, dim=(1, 2))) * loss_weight


def soft_wing_loss(pred, target, target_weight=None, omega1: float = 2.0, omega2: float = 20.0,
                   epsilon: float = 0.5, loss_weight: float = 1.0):
    """Soft wing loss (reference regression_loss.py SoftWingLoss): |x| below
    ``omega1``, the log branch above, reduced as :func:`wing_loss`."""
    p, t = _weighted(pred, target, target_weight)
    d = torch.abs(p - t)
    B = omega1 - omega2 * math.log(1.0 + omega1 / epsilon)
    loss = torch.where(d < omega1, d, omega2 * torch.log(1.0 + d / epsilon) + B)
    return torch.mean(torch.sum(loss, dim=(1, 2))) * loss_weight


def bone_loss(pred, target, joint_parents: Sequence[int], target_weight=None,
              loss_weight: float = 1.0):
    """Bone-length loss (reference regression_loss.py BoneLoss): the L1
    between the batch-mean lengths of the non-root bones of ``pred`` and
    ``target`` (B, K, D); ``joint_parents`` has each joint's parent (the
    root its own); ``target_weight`` optional (B, K-1) bone weights."""
    parents = list(joint_parents)
    non_root = [i for i, p in enumerate(parents) if p != i]
    pb = torch.linalg.norm(pred - pred[:, parents], dim=-1)[:, non_root]
    tb = torch.linalg.norm(target - target[:, parents], dim=-1)[:, non_root]
    if target_weight is not None:
        pb, tb = pb * target_weight, tb * target_weight
    return torch.mean(torch.abs(pb.mean(0) - tb.mean(0))) * loss_weight


def project_joints(x, intrinsics):
    """Pinhole projection of (B, K, 3) joints, with radial and tangential
    distortion when ``intrinsics`` is (B, 9) [f, c, k, p] rather than (B, 4)
    [f, c]."""
    intr = intrinsics[:, None, :]
    f, c = intr[..., :2], intr[..., 2:4]
    xy = torch.clamp(x[:, :, :2] / x[:, :, 2:], -1.0, 1.0)
    if intrinsics.shape[-1] == 9:
        k, p = intr[..., 4:7], intr[..., 7:9]
        r2 = torch.sum(xy ** 2, dim=-1, keepdim=True)
        radial = 1 + torch.sum(k * torch.cat([r2, r2 ** 2, r2 ** 3], -1), -1, keepdim=True)
        tan = torch.sum(p * xy, dim=-1, keepdim=True)
        xy = xy * (radial + tan) + p * r2
    return f * xy + c


def semi_supervision_loss(labeled_pose, unlabeled_pose, unlabeled_traj, unlabeled_target_2d,
                          intrinsics, joint_parents, projection_loss_weight: float = 1.0,
                          bone_loss_weight: float = 1.0):
    """The semi-supervision losses (reference SemiSupervisionLoss):
    ``{"proj_loss", "bone_loss"}``; its warm-up gating is the caller's."""
    proj_2d = project_joints(unlabeled_pose + unlabeled_traj, intrinsics)
    return {"proj_loss": mpjpe_loss(proj_2d, unlabeled_target_2d,
                                    loss_weight=projection_loss_weight),
            "bone_loss": bone_loss(unlabeled_pose, labeled_pose, joint_parents,
                                   loss_weight=bone_loss_weight)}


def bce_loss(pred_logits, target, target_weight=None, loss_weight=1.0):
    """Binary cross-entropy with logits (reference classfication_loss.py:9)."""
    p, t = pred_logits.float(), target.float()
    loss = torch.clamp(p, min=0) - p * t + torch.log1p(torch.exp(-torch.abs(p)))
    if target_weight is not None:
        loss = loss * target_weight
    return torch.mean(loss) * loss_weight


def ae_heatmap_loss(pred, target, mask: Optional[torch.Tensor] = None):
    """Bottom-up heatmap MSE with an optional (B, H, W) pixel mask, per
    image (reference multi_loss_factory.py HeatmapLoss)."""
    d = (pred.float() - target.float()) ** 2
    if mask is not None:
        d = d * mask.float()[:, None]
    return torch.mean(d, dim=(1, 2, 3))


def ae_grouping_loss(tags, joint_indices, joint_valid, pull_weight: float = 1.0,
                     push_weight: float = 1.0):
    """Associative-embedding pull and push losses of one image (reference
    multi_loss_factory.py AELoss): ``tags`` (HW,) or (HW, T), the (P, K)
    flat index of each ground-truth joint and its 0/1 validity."""
    if tags.dim() == 1:
        tags = tags[:, None]
    P, K = joint_indices.shape
    t = tags[joint_indices.reshape(-1)].reshape(P, K, -1)
    v = joint_valid.float()[..., None]
    cnt = torch.clamp(v.sum(1), min=1e-6)
    mean = (t * v).sum(1) / cnt
    pull_per = ((t - mean[:, None]) ** 2 * v).sum(1) / cnt
    person_valid = (v.sum(1) > 0).float()
    n_person = torch.clamp(person_valid.sum(), min=1.0)
    pull = (pull_per * person_valid).sum() / n_person
    diff = mean[:, None, :] - mean[None, :, :]
    pv = person_valid[:, 0]
    pair_valid = pv[:, None] * pv[None, :] * (1 - torch.eye(P, dtype=pv.dtype, device=pv.device))
    push_mat = torch.exp(-torch.sum(diff ** 2, -1)) * pair_valid
    denom = torch.clamp(n_person * (n_person - 1), min=1.0)
    push = push_mat.sum() / denom * 0.5
    return pull * pull_weight, push * push_weight


def mpjpe_loss(pred, target, target_weight=None, loss_weight=1.0):
    """Mean per-joint position error (reference MPJPELoss): the (B, K, D)
    weight multiplies the residual inside the norm."""
    r = pred - target
    if target_weight is not None:
        r = r * target_weight
    return torch.mean(torch.linalg.norm(r, dim=-1)) * loss_weight
