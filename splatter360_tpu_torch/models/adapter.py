"""Raw network channels -> world-space Gaussians (sym6 covariances).

Counterpart of splatter360_tpu/models/adapter.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.erp import erp_ray_directions
from ..geometry.sh import num_sh_coeffs, rotate_sh
from ..geometry.transforms import build_covariance_sym6
from .types import Gaussians


@dataclass(frozen=True)
class GaussianAdapterConfig:
    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 4

    @property
    def d_sh(self) -> int:
        return num_sh_coeffs(self.sh_degree)

    @property
    def d_in(self) -> int:
        """Raw channels per Gaussian: 3 scale + 4 quat + 3 * d_sh."""
        return 7 + 3 * self.d_sh


def sh_band_mask(sh_degree: int, device=None) -> torch.Tensor:
    mask = torch.ones(num_sh_coeffs(sh_degree), device=device)
    for degree in range(1, sh_degree + 1):
        mask[degree**2:(degree + 1) ** 2] = 0.1 * 0.25**degree
    return mask


def adapt_gaussians(cfg: GaussianAdapterConfig, extrinsics, depths, opacities,
                    raw_gaussians, image_shape) -> Gaussians:
    """extrinsics [B, V, 4, 4] c2w, depths/opacities [B, V, H*W, 1],
    raw_gaussians [B, V, H*W, 7 + 3 d_sh] -> Gaussians with N = V*H*W."""
    b, v, n, _ = raw_gaussians.shape
    h, w = image_shape
    d_sh = cfg.d_sh
    raw_scales = raw_gaussians[..., 0:3]
    raw_quats = raw_gaussians[..., 3:7]
    raw_sh = raw_gaussians[..., 7:7 + 3 * d_sh]

    pixel_size = 1.0 / max(w, h)
    scales = cfg.gaussian_scale_min + (cfg.gaussian_scale_max - cfg.gaussian_scale_min) * (
        torch.reciprocal(1.0 + torch.exp(-raw_scales)))
    scales = scales * depths * pixel_size
    quats = raw_quats / (torch.linalg.norm(raw_quats, dim=-1, keepdim=True) + 1e-8)
    sh = raw_sh.reshape(b, v, n, 3, d_sh) * sh_band_mask(cfg.sh_degree, raw_sh.device)

    c2w_rot = extrinsics[..., :3, :3]
    covs = build_covariance_sym6(scales, quats, world_rot=c2w_rot[:, :, None])

    if n != h * w:
        raise NotImplementedError("gaussians_per_pixel > 1 is not ported")
    dirs = erp_ray_directions(h, w, depths.device).reshape(h * w, 3)
    pts_cam = dirs * depths
    means = torch.einsum("bvij,bvnj->bvni", c2w_rot, pts_cam) + extrinsics[..., None, :3, 3]
    sh_world = rotate_sh(sh, c2w_rot[:, :, None], cfg.sh_degree)
    return Gaussians(
        means=means.reshape(b, v * n, 3),
        covariances=covs.reshape(b, v * n, 6),
        harmonics=sh_world.reshape(b, v * n, 3, d_sh),
        opacities=opacities[..., 0].reshape(b, v * n),
    )


def map_pdf_to_opacity(pdf, global_step: int, initial: float, final: float, warm_up: int):
    """Warm-up density -> opacity map. The warm-up fraction and the exponent
    are float32, as the JAX package computes them from its int32 step."""
    f32 = np.float32
    frac = min(f32(global_step) / f32(max(warm_up, 1)), f32(1.0))
    exponent = f32(2.0) ** (f32(initial) + frac * f32(final - initial))
    return 0.5 * (1.0 - (1.0 - pdf) ** float(exponent) + pdf ** float(f32(1.0) / exponent))
