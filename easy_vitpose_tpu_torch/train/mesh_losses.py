"""3D human-mesh and GAN losses (port of ``easy_vitpose_tpu/train/mesh_losses.py``;
reference vit_models/losses/mesh_loss.py).

No config of the reference reaches them (they belong to mmpose's
mesh-recovery models); they are here for the loss zoo's completeness:

* rotation helpers: :func:`rot6d_to_rotmat`, :func:`quat_to_rotmat`,
  :func:`batch_rodrigues` (mesh_loss.py:7-71);
* :func:`perspective_projection` (mesh_loss.py:73-112);
* :func:`mesh_loss`: vertex L1, SMPL pose and beta MSE, the pelvis-centred
  3D-joint SmoothL1 and the 2D reprojection SmoothL1 (mesh_loss.py:113-313);
* :func:`gan_loss`: vanilla, lsgan, wgan and hinge (mesh_loss.py:313-444).
"""
from __future__ import annotations

from typing import Dict

import torch


def _normalize(v, dim=-1, eps=1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True), min=eps)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(B, 6) continuous 6D rotations -> (B, 3, 3) rotation matrices."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-1)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(B, 4) quaternions (w, x, y, z) -> (B, 3, 3)."""
    q = quat / torch.linalg.norm(quat, dim=1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    w2, x2, y2, z2 = w ** 2, x ** 2, y ** 2, z ** 2
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=1).reshape(-1, 3, 3)


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """(B, 3) axis-angle -> (B, 3, 3) through the quaternion, with the
    reference's epsilon (|theta + 1e-8|)."""
    l2 = torch.linalg.norm(theta + 1e-8, dim=1, keepdim=True)
    half = l2 * 0.5
    return quat_to_rotmat(torch.cat([torch.cos(half), torch.sin(half) * (theta / l2)], 1))


def perspective_projection(points, rotation, translation, focal_length, camera_center):
    """(B, N, 3) points through a pinhole camera -> (B, N, 2)."""
    B = points.shape[0]
    K = torch.zeros((B, 3, 3), dtype=points.dtype, device=points.device)
    K[:, 0, 0] = focal_length
    K[:, 1, 1] = focal_length
    K[:, 2, 2] = 1.0
    K[:, :2, 2] = camera_center
    p = torch.einsum("bij,bkj->bki", rotation, points) + translation[:, None]
    p = p / p[:, :, -1:]
    return torch.einsum("bij,bkj->bki", K, p)[:, :, :2]


def _smooth_l1(a, b):
    d = torch.abs(a - b)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def mesh_loss(output: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor], *,
              joints_2d_loss_weight: float = 1.0, joints_3d_loss_weight: float = 1.0,
              vertex_loss_weight: float = 1.0, smpl_pose_loss_weight: float = 1.0,
              smpl_beta_loss_weight: float = 1.0, img_res: int = 224,
              focal_length: float = 5000.0) -> Dict[str, torch.Tensor]:
    """The reference MeshLoss.forward (mesh_loss.py:246-313); ``output`` and
    ``target`` as JAX's ``mesh_loss`` takes them."""
    losses = {}
    has_smpl = target["has_smpl"].float()
    v_l1 = torch.abs(output["vertices"] - target["vertices"])
    losses["vertex_loss"] = (has_smpl[:, None, None] * v_l1).mean() * vertex_loss_weight
    if "pose" in output and "beta" in output:
        gt_rotmat = batch_rodrigues(target["pose"].reshape(-1, 3)).reshape(-1, 24, 3, 3)
        pose_mse = (output["pose"] - gt_rotmat) ** 2
        beta_mse = (output["beta"] - target["beta"]) ** 2
        losses["smpl_pose_loss"] = ((has_smpl[:, None, None, None] * pose_mse).mean()
                                    * smpl_pose_loss_weight)
        losses["smpl_beta_loss"] = (has_smpl[:, None] * beta_mse).mean() * smpl_beta_loss_weight
    gt3, pr3 = target["joints_3d"], output["joints_3d"]
    gt3 = gt3 - (gt3[:, 2, :] + gt3[:, 3, :])[:, None] / 2
    pr3c = pr3 - (pr3[:, 2, :] + pr3[:, 3, :])[:, None] / 2
    conf3 = target["joints_3d_visible"].float()
    losses["joints_3d_loss"] = (conf3 * _smooth_l1(pr3c, gt3)).mean() * joints_3d_loss_weight
    cam = output["camera"]
    B = pr3.shape[0]
    cam_t = torch.stack([cam[:, 1], cam[:, 2],
                         2 * focal_length / (img_res * cam[:, 0] + 1e-9)], -1)
    eye = torch.eye(3, dtype=pr3.dtype, device=pr3.device).expand(B, 3, 3)
    pred_2d = perspective_projection(pr3, eye, cam_t, focal_length,
                                     torch.zeros((B, 2), dtype=pr3.dtype, device=pr3.device))
    pred_2d = 2 * pred_2d / (img_res - 1)
    gt_2d = 2 * target["joints_2d"] / (img_res - 1) - 1
    conf2 = target["joints_2d_visible"].float()
    losses["joints_2d_loss"] = (conf2 * _smooth_l1(pred_2d, gt_2d)).mean() * joints_2d_loss_weight
    return losses


def gan_loss(x: torch.Tensor, target_is_real: bool, gan_type: str = "vanilla",
             real_label_val: float = 1.0, fake_label_val: float = 0.0,
             loss_weight: float = 1.0, is_disc: bool = False) -> torch.Tensor:
    """The reference GANLoss.forward (mesh_loss.py:313-444); ``loss_weight``
    applies to generator calls only."""
    x = x.float()
    if gan_type == "wgan":
        loss = -x.mean() if target_is_real else x.mean()
    elif gan_type == "hinge":
        if is_disc:
            xx = -x if target_is_real else x
            loss = torch.clamp(1 + xx, min=0.0).mean()
        else:
            loss = -x.mean()
    else:
        label = torch.full_like(x, real_label_val if target_is_real else fake_label_val)
        if gan_type == "vanilla":
            loss = (torch.clamp(x, min=0) - x * label + torch.log1p(torch.exp(-torch.abs(x)))).mean()
        elif gan_type == "lsgan":
            loss = ((x - label) ** 2).mean()
        else:
            raise NotImplementedError(f"GAN type {gan_type}")
    return loss if is_disc else loss * loss_weight
