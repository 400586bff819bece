"""Rigid transforms, quaternions and Gaussian covariance building (sym6 form).

Counterpart of splatter360_tpu/geometry/transforms.py; sym6 = (s00, s01, s02,
s11, s12, s22), the upper triangle of a symmetric 3x3 covariance. The video
trajectories: interpolate_pose_6d between two poses, trajectory_wobble and
trajectory_spin about one.
"""

from __future__ import annotations

import math

import torch


def quaternion_to_matrix(quat_xyzw: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """xyzw quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    i, j, k, r = quat_xyzw.unbind(-1)
    two_s = 2.0 / ((quat_xyzw * quat_xyzw).sum(-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(*o.shape[:-1], 3, 3)


def sym6_to_matrix(sym6: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> full symmetric [..., 3, 3]."""
    s00, s01, s02, s11, s12, s22 = sym6.unbind(-1)
    rows = torch.stack([s00, s01, s02, s01, s11, s12, s02, s12, s22], dim=-1)
    return rows.reshape(*sym6.shape[:-1], 3, 3)


def build_covariance_sym6(
    scale: torch.Tensor,
    quat_xyzw: torch.Tensor,
    world_rot: torch.Tensor | None = None,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Sigma = (Rw Rq S)(Rw Rq S)^T as sym6 [..., 6], all elementwise math.

    world_rot [..., 3, 3] (broadcast against the Gaussian axis) is folded in
    before the product, as the adapter does with the c2w rotation."""
    i, j, k, r = quat_xyzw.unbind(-1)
    two_s = 2.0 / ((quat_xyzw * quat_xyzw).sum(-1) + eps)
    rq = (
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r),
        two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    )
    if world_rot is not None:
        wr = [[world_rot[..., a, b] for b in range(3)] for a in range(3)]
        m = [
            sum(wr[a][c] * rq[c * 3 + b] for c in range(3))
            for a in range(3)
            for b in range(3)
        ]
    else:
        m = list(rq)
    s = scale.unbind(-1)
    m = [m[3 * a + b] * s[b] for a in range(3) for b in range(3)]

    def dot(a, b):
        return (
            m[3 * a] * m[3 * b] + m[3 * a + 1] * m[3 * b + 1]
            + m[3 * a + 2] * m[3 * b + 2]
        )

    return torch.stack(
        [dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)], dim=-1
    )


def inverse_se3(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a [..., 4, 4] SE(3) pose."""
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    t_inv = -(rot_t @ pose[..., :3, 3:4])
    top = torch.cat([rot_t, t_inv], dim=-1)
    bottom = torch.zeros_like(pose[..., 3:4, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation_6d_to_matrix(d6: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Gram-Schmidt 6D rotation representation [..., 6] -> [..., 3, 3]."""
    a1, a2 = d6[..., 0:3], d6[..., 3:6]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + eps)
    a2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 / (torch.linalg.norm(a2, dim=-1, keepdim=True) + eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(rot: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> its first two rows flattened, [..., 6]."""
    return torch.cat([rot[..., 0, :], rot[..., 1, :]], dim=-1)


def interpolate_pose_6d(pose_a: torch.Tensor, pose_b: torch.Tensor, t) -> torch.Tensor:
    """Interpolate two [..., 4, 4] c2w poses: the translation and the 6D
    rotation linearly, then re-orthogonalised. t is a scalar or broadcasts
    against the poses' batch axes."""
    t = torch.as_tensor(t, dtype=pose_a.dtype, device=pose_a.device)
    while t.dim() < pose_a.dim() - 2:
        t = t[..., None]
    trans = (1 - t)[..., None] * pose_a[..., :3, 3] + t[..., None] * pose_b[..., :3, 3]
    d6 = ((1 - t)[..., None] * matrix_to_rotation_6d(pose_a[..., :3, :3])
          + t[..., None] * matrix_to_rotation_6d(pose_b[..., :3, :3]))
    top = torch.cat([rotation_6d_to_matrix(d6), trans[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def trajectory_wobble(pose: torch.Tensor, radius, t) -> torch.Tensor:
    """A circular wobble about a [4, 4] c2w pose: the camera origin traces a
    circle of `radius` in its local xy plane (dx = r sin 2 pi t, dy = -r cos
    2 pi t + r), the orientation fixed; t in [0, 1] is one loop, a scalar or
    any shape (the poses come out [*t.shape, 4, 4])."""
    t = torch.as_tensor(t, dtype=pose.dtype, device=pose.device)
    dx = radius * torch.sin(2.0 * math.pi * t)
    dy = -radius * torch.cos(2.0 * math.pi * t) + radius
    delta = torch.stack([dx, dy, torch.zeros_like(dx)], dim=-1)
    out = pose.expand(*t.shape, 4, 4).clone()
    out[..., :3, 3] += torch.einsum("ij,...j->...i", pose[:3, :3], delta)
    return out


def trajectory_spin(pose: torch.Tensor, t) -> torch.Tensor:
    """A yaw in place: the [4, 4] c2w pose turned about its local up (y)
    axis by 2 pi t, the origin fixed; t a scalar or any shape."""
    t = torch.as_tensor(t, dtype=pose.dtype, device=pose.device)
    ang = 2.0 * math.pi * t
    c, s = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot_y = torch.stack([torch.stack([c, z, s], dim=-1), torch.stack([z, o, z], dim=-1),
                         torch.stack([-s, z, c], dim=-1)], dim=-2)
    out = pose.expand(*t.shape, 4, 4).clone()
    out[..., :3, :3] = torch.einsum("ij,...jk->...ik", pose[:3, :3], rot_y)
    return out
