"""3D Gaussian -> 2D screen-space projection for equirect, pinhole and
orthographic cameras.

Counterpart of splatter360_tpu/ops/projection.py (project_erp,
project_pinhole, project_ortho, _finalize, sh_colors). The arithmetic keeps
the reference's operation order so that binning decisions agree with it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..geometry.sh import eval_sh
from ..geometry.transforms import inverse_se3


class Projected(NamedTuple):
    mean2d: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor   # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor   # [N] sort key: radial distance (erp), camera z (pinhole, ortho)
    radius: torch.Tensor  # [N, 2] per-axis pixel extent
    valid: torch.Tensor   # [N] bool
    gate_s: Optional[torch.Tensor] = None  # [N] elliptical-cull level


def _to_cam(rot, t, means):
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    x = rot[0, 0] * mx + rot[0, 1] * my + rot[0, 2] * mz + t[0]
    y = rot[1, 0] * mx + rot[1, 1] * my + rot[1, 2] * mz + t[1]
    z = rot[2, 0] * mx + rot[2, 1] * my + rot[2, 2] * mz + t[2]
    return x, y, z


def _cov2d_scalar(w2c_rot, du, dv, covs):
    """2D covariance (a, b, c) = T Sigma T^T, T = J R, from the Jacobian rows
    du, dv ([N] triples) and world covariances ([N, 6] sym6 or [N, 3, 3])."""
    rows = []
    for d0, d1, d2 in (du, dv):
        rows.append(tuple(
            d0 * w2c_rot[0, k] + d1 * w2c_rot[1, k] + d2 * w2c_rot[2, k]
            for k in range(3)
        ))
    (t00, t01, t02), (t10, t11, t12) = rows
    if covs.dim() == 2 and covs.shape[-1] == 6:
        s00, s01, s02, s11, s12, s22 = covs.unbind(-1)
    else:
        cf = covs.reshape(-1, 9)
        s00, s01, s02, s11, s12, s22 = (cf[:, i] for i in (0, 1, 2, 4, 5, 8))
    p0 = s00 * t00 + s01 * t01 + s02 * t02
    p1 = s01 * t00 + s11 * t01 + s12 * t02
    p2 = s02 * t00 + s12 * t01 + s22 * t02
    a = t00 * p0 + t01 * p1 + t02 * p2
    b = t10 * p0 + t11 * p1 + t12 * p2
    q0 = s00 * t10 + s01 * t11 + s02 * t12
    q1 = s01 * t10 + s11 * t11 + s12 * t12
    q2 = s02 * t10 + s12 * t11 + s22 * t12
    c = t10 * q0 + t11 * q1 + t12 * q2
    return a, b, c


def _finalize(u, v, a, b, c, depth, valid, eps2d=0.3, max_radius=None,
              opacities=None):
    """Conic, per-axis radii (opacity-tightened when opacities are given) and
    the elliptical-cull level; see splatter360_tpu/ops/projection.py."""
    mean2d = torch.stack([u, v], dim=-1)
    a = a + eps2d
    c = c + eps2d
    det = a * c - b * b
    det_safe = torch.where(det > 1e-12, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)
    if opacities is not None:
        o = opacities.detach()
        q = torch.clamp(torch.log(255.0 * torch.clamp(o, min=1e-12)), 0.0, 4.5)
        scale = torch.sqrt(q / 4.5)
        valid = valid & (o >= 1.0 / 255.0)
    else:
        scale = 1.0
    rx = torch.ceil(3.0 * torch.sqrt(a) * scale)
    ry = torch.ceil(3.0 * torch.sqrt(c) * scale)
    if max_radius is not None:
        rx = torch.clamp(rx, max=max_radius[0])
        ry = torch.clamp(ry, max=max_radius[1])
    radius = torch.stack([rx, ry], dim=-1)
    valid = valid & (det > 1e-12)
    if opacities is not None:
        q_lvl = 4.5 * torch.square(scale)
        gate_s = 2.0 * q_lvl * (1.0 + 1e-4) + 1e-6
    else:
        gate_s = torch.full_like(u, 2.0 * 4.5 * (1.0 + 1e-4) + 1e-6)
    return Projected(mean2d, conic, depth, radius, valid, gate_s)


def project_erp(
    means: torch.Tensor,
    covs: torch.Tensor,
    c2w: torch.Tensor,
    image_shape: tuple[int, int],
    near: float | torch.Tensor,
    eps2d: float = 0.3,
    opacities: torch.Tensor | None = None,
) -> Projected:
    """Project world-space Gaussians [N, 3] straight into an ERP image with
    the local-affine Jacobian of the ERP mapping (see geometry/erp.py)."""
    from .tiling import TILE_W

    h, w = image_shape
    w2c = inverse_se3(c2w)
    rot = w2c[:3, :3]
    x, y, z = _to_cam(rot, w2c[:3, 3], means)

    rho2 = x * x + z * z
    r2 = rho2 + y * y
    r = torch.sqrt(r2)
    rho = torch.sqrt(rho2)
    valid = r > 0.2 * torch.as_tensor(near, dtype=means.dtype, device=means.device)
    rho2_safe = torch.clamp(rho2, min=1e-12)
    rho_safe = torch.clamp(rho, min=1e-6)
    r2_safe = torch.clamp(r2, min=1e-12)

    theta = torch.atan2(x, z)
    phi = torch.atan2(y, rho_safe)
    u = (-theta / (2 * math.pi) + 0.5) * w - 0.5
    v = (-phi / math.pi + 0.5) * h - 0.5

    ku = -w / (2 * math.pi)
    kv = -h / math.pi
    du = (ku * z / rho2_safe, torch.zeros_like(x), -ku * x / rho2_safe)
    dv = (
        -kv * x * y / (r2_safe * rho_safe),
        kv * rho_safe / r2_safe,
        -kv * z * y / (r2_safe * rho_safe),
    )
    a, b, c = _cov2d_scalar(rot, du, dv, covs)
    # Radius caps: half the height bounds the pole blow-up, and
    # W/2 - TILE_W/2 - 1 keeps every footprint inside half the azimuth range
    # minus a tile, which makes the compositor's per-tile seam re-centring
    # exact (ops/cuda/composite.py).
    max_rx = float(min(h // 2, max(w // 2 - TILE_W // 2 - 1, 8)))
    max_ry = float(h // 2)
    return _finalize(u, v, a, b, c, r, valid, eps2d, max_radius=(max_rx, max_ry),
                     opacities=opacities)


def project_pinhole(
    means: torch.Tensor,
    covs: torch.Tensor,
    c2w: torch.Tensor,
    intrinsics: torch.Tensor,
    image_shape: tuple[int, int],
    near: float | torch.Tensor,
    eps2d: float = 0.3,
    opacities: torch.Tensor | None = None,
) -> Projected:
    """Project world-space Gaussians through a pinhole camera with normalized
    intrinsics [3, 3] (EWA local-affine Jacobian, as 3DGS): valid past
    z > 0.2 near, x/z and y/z clamped to 1.3 tan(fov/2) inside the Jacobian
    only, radii capped at max(h, w) on both axes."""
    h, w = image_shape
    w2c = inverse_se3(c2w)
    rot = w2c[:3, :3]
    x, y, z = _to_cam(rot, w2c[:3, 3], means)

    fx = intrinsics[0, 0] * w
    fy = intrinsics[1, 1] * h
    cx = intrinsics[0, 2] * w
    cy = intrinsics[1, 2] * h

    valid = z > 0.2 * torch.as_tensor(near, dtype=means.dtype, device=means.device)
    z_safe = torch.where(valid, z, torch.ones_like(z))

    tan_x = 0.5 * w / fx
    tan_y = 0.5 * h / fy
    tx = torch.clamp(x / z_safe, -1.3 * tan_x, 1.3 * tan_x)
    ty = torch.clamp(y / z_safe, -1.3 * tan_y, 1.3 * tan_y)

    u = fx * x / z_safe + cx - 0.5
    v = fy * y / z_safe + cy - 0.5

    zero = torch.zeros_like(z_safe)
    du = (fx / z_safe, zero, -fx * tx / z_safe)
    dv = (zero, fy / z_safe, -fy * ty / z_safe)
    a, b, c = _cov2d_scalar(rot, du, dv, covs)
    mr = float(max(h, w))
    return _finalize(u, v, a, b, c, z, valid, eps2d, max_radius=(mr, mr), opacities=opacities)


def project_ortho(
    means: torch.Tensor,
    covs: torch.Tensor,
    c2w: torch.Tensor,
    extent: float | torch.Tensor,
    image_shape: tuple[int, int],
    near: float | torch.Tensor = 0.0,
    far: float | torch.Tensor = float("inf"),
    eps2d: float = 0.3,
) -> Projected:
    """Orthographic projection (the paper figures' camera): looking down +z,
    the world square of side `extent` centred on the axis fills the image;
    the Jacobian is constant, so the 2D covariance is exact."""
    h, w = image_shape
    w2c = inverse_se3(c2w)
    rot = w2c[:3, :3]
    x, y, z = _to_cam(rot, w2c[:3, 3], means)

    extent = torch.as_tensor(extent, dtype=means.dtype, device=means.device)
    fx = w / extent
    fy = h / extent
    u = fx * x + 0.5 * w - 0.5
    v = fy * y + 0.5 * h - 0.5
    valid = (z > near) & (z < far)

    zero = torch.zeros_like(x)
    du = (fx * torch.ones_like(x), zero, zero)
    dv = (zero, fy * torch.ones_like(x), zero)
    a, b, c = _cov2d_scalar(rot, du, dv, covs)
    mr = float(max(h, w))
    return _finalize(u, v, a, b, c, z, valid, eps2d, max_radius=(mr, mr))


def sh_colors(sh: torch.Tensor, means: torch.Tensor, campos: torch.Tensor,
              degree: int) -> torch.Tensor:
    """3DGS colour model: clamp(eval_sh(dir) + 0.5, 0). sh [N, 3, n] -> [N, 3]."""
    d = means - campos
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
    return torch.clamp(eval_sh(sh, d, degree) + 0.5, min=0.0)
