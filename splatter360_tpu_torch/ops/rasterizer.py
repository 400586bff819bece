"""Tiled Gaussian rasterizer, direct-ERP forward path.

Counterpart of splatter360_tpu/ops/rasterizer.py `render_tiled` with
camera_kind="erp" and the fused compositor: project -> SH colours -> tile
binning -> one compositor launch for all views.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .cuda.composite import build_attrs, composite_tiles
from .projection import project_erp, sh_colors
from .tiling import assign_tiles

DEPTH_MODES = ("depth", "log", "disparity", "relative_disparity")


class RenderOutput(NamedTuple):
    color: torch.Tensor            # [H, W, 3] (or [V, H, W, 3])
    depth: Optional[torch.Tensor]  # [H, W] or None
    alpha: torch.Tensor            # [H, W]
    dropped: torch.Tensor          # [] (or [V]) int32


def transform_depth(depth, mode, near, far):
    """Per-Gaussian depth transform before compositing (depth/log/disparity/
    relative_disparity)."""
    if mode == "depth":
        return depth
    d = torch.clamp(depth, min=1e-8)
    if mode == "log":
        return torch.log(d)
    if mode == "disparity":
        return 1.0 / d
    if mode == "relative_disparity":
        return (1.0 / d - 1.0 / far) / (1.0 / near - 1.0 / far)
    raise ValueError(f"unknown depth_mode {mode!r}; expected {DEPTH_MODES}")


def render_erp_batch(
    means: torch.Tensor,        # [N, 3]
    covariances: torch.Tensor,  # [N, 6] sym6
    harmonics: torch.Tensor,    # [N, 3, d_sh]
    opacities: torch.Tensor,    # [N]
    c2w: torch.Tensor,          # [V, 4, 4]
    image_shape: tuple[int, int],
    near,                       # [V] or scalar
    far,                        # [V] or scalar
    background: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    depth_mode: str = "depth",
) -> RenderOutput:
    """Render V ERP views of one Gaussian set with a single compositor
    launch. Returns batched outputs (color [V, H, W, 3], depth/alpha
    [V, H, W], dropped [V])."""
    v = c2w.shape[0]
    if background is None:
        background = torch.zeros(3, dtype=means.dtype, device=means.device)
    if sh_degree is None:
        sh_degree = int(math.isqrt(harmonics.shape[-1]) - 1)
    near = torch.as_tensor(near, dtype=means.dtype, device=means.device).expand(v)
    far = torch.as_tensor(far, dtype=means.dtype, device=means.device).expand(v)
    attrs, assignments = [], []
    for i in range(v):
        proj = project_erp(means, covariances, c2w[i], image_shape, near[i],
                           opacities=opacities)
        if harmonics.shape[-1] == 1:
            colors = harmonics[..., 0]
        else:
            colors = sh_colors(harmonics, means, c2w[i, :3, 3], sh_degree)
        with torch.no_grad():  # binning yields indices only: nothing to differentiate
            assignments.append(assign_tiles(proj, image_shape, wrap_x=True))
        depth_vals = transform_depth(proj.depth, depth_mode, near[i], far[i])
        attrs.append(build_attrs(proj.mean2d, proj.conic, colors, opacities,
                                 depth_vals, proj.radius))
    rgb, alpha, dacc = composite_tiles(assignments, torch.stack(attrs),
                                       image_shape, background, wrap_x=True)
    return RenderOutput(color=rgb, depth=dacc, alpha=alpha,
                        dropped=torch.stack([a.dropped for a in assignments]))


def render_tiled(
    means, covariances, harmonics, opacities, c2w, image_shape,
    camera_kind: str = "erp", near=0.1, far=100.0, background=None,
    sh_degree: Optional[int] = None, render_depth: bool = False,
    depth_mode: str = "depth",
) -> RenderOutput:
    """Render one view ([H, W, 3] colour); the counterpart of the JAX
    render_tiled for camera_kind="erp" on the fused compositor."""
    if camera_kind != "erp":
        raise NotImplementedError(f"camera_kind={camera_kind!r}: only 'erp' is ported")
    out = render_erp_batch(means, covariances, harmonics, opacities, c2w[None],
                           image_shape, near, far, background, sh_degree, depth_mode)
    return RenderOutput(color=out.color[0], depth=out.depth[0] if render_depth else None,
                        alpha=out.alpha[0], dropped=out.dropped[0])
