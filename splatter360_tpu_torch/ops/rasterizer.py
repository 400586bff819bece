"""Tiled Gaussian rasterizer for ERP and pinhole views.

Counterpart of splatter360_tpu/ops/rasterizer.py `render_tiled`: project
-> SH colours -> tile binning -> one compositor call for all views. The
`backend` is the JAX package's: "pallas" composites with the CUDA kernels
(ops/cuda/composite.py), "jax" with the scan compositor
(ops/composite_scan.py, composite_jax's counterpart). As in the JAX
package, an ERP render narrower than 2 tiles goes to the scan compositor
under "pallas" too: the kernels re-centre u per tile, which cannot serve
both sides of the seam inside one tile. That switch is decided by the
shape alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .composite_scan import composite_tiles_scan
from .cuda.composite import build_attrs, composite_tiles
from .projection import project_erp, project_pinhole, sh_colors
from .tiling import assign_tiles

DEPTH_MODES = ("depth", "log", "disparity", "relative_disparity")
BACKENDS = ("pallas", "jax")


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


def project_views(means, covariances, opacities, c2w, image_shape, near,
                  camera_kind="erp", intrinsics=None):
    """The N Gaussians projected into each of the V views c2w [V, 4, 4]
    (near [V]): a list of Projected."""
    if camera_kind == "erp":
        return [project_erp(means, covariances, c2w[i], image_shape, near[i], opacities=opacities)
                for i in range(c2w.shape[0])]
    return [project_pinhole(means, covariances, c2w[i], intrinsics, image_shape, near[i],
                            opacities=opacities) for i in range(c2w.shape[0])]


def view_colors(harmonics, means, c2w, sh_degree, views_per_position=1):
    """Each view's RGB [N, 3]. Each run of `views_per_position` consecutive
    views shares one camera position (the 6 faces of a cube rig), so their
    SH colours, a function of the position alone, are computed once."""
    v = c2w.shape[0]
    if harmonics.shape[-1] == 1:
        return [harmonics[..., 0]] * v
    runs = [sh_colors(harmonics, means, c2w[i, :3, 3], sh_degree)
            for i in range(0, v, views_per_position)]
    return [runs[i // views_per_position] for i in range(v)]


def bin_views(projs, image_shape, wrap_x, instance_cap=None):
    """assign_tiles of each view; binning yields indices only, so nothing
    of it is differentiated."""
    with torch.no_grad():
        return [assign_tiles(p, image_shape, wrap_x, instance_cap=instance_cap) for p in projs]


def view_attrs(projs, colors, opacities, near, far, depth_mode="depth"):
    """The compositor's attribute table [V, N, 16] of the views."""
    return torch.stack([
        build_attrs(p.mean2d, p.conic, c, opacities,
                    transform_depth(p.depth, depth_mode, near[i], far[i]), p.radius)
        for i, (p, c) in enumerate(zip(projs, colors))])


def batch_inputs(
    means: torch.Tensor,        # [N, 3]
    covariances: torch.Tensor,  # [N, 6] sym6
    harmonics: torch.Tensor,    # [N, 3, d_sh]
    opacities: torch.Tensor,    # [N]
    c2w: torch.Tensor,          # [V, 4, 4]
    image_shape: tuple[int, int],
    near,                       # [V] or scalar
    far,                        # [V] or scalar
    sh_degree: Optional[int] = None,
    depth_mode: str = "depth",
    camera_kind: str = "erp",
    intrinsics: Optional[torch.Tensor] = None,  # [3, 3] normalized (pinhole)
    instance_cap: Optional[int] = None,
    views_per_position: int = 1,
):
    """The compositor's inputs for V views of one Gaussian set: (attrs
    [V, N, 16], the views' tile assignments, wrap_x). ERP views composite
    with the horizontal wrap, pinhole views without it."""
    v = c2w.shape[0]
    if camera_kind not in ("erp", "pinhole"):
        raise ValueError(f"camera_kind={camera_kind!r}: expected 'erp' or 'pinhole'")
    if camera_kind == "pinhole" and intrinsics is None:
        raise ValueError("a pinhole render needs intrinsics")
    if v % views_per_position:
        raise ValueError(f"{v} views are not runs of {views_per_position}")
    wrap_x = camera_kind == "erp"
    if sh_degree is None:
        sh_degree = int(math.isqrt(harmonics.shape[-1]) - 1)
    near = torch.as_tensor(near, dtype=means.dtype, device=means.device).expand(v)
    far = torch.as_tensor(far, dtype=means.dtype, device=means.device).expand(v)
    projs = project_views(means, covariances, opacities, c2w, image_shape, near, camera_kind,
                          intrinsics)
    colors = view_colors(harmonics, means, c2w, sh_degree, views_per_position)
    assignments = bin_views(projs, image_shape, wrap_x, instance_cap)
    attrs = view_attrs(projs, colors, opacities, near, far, depth_mode)
    return attrs, assignments, wrap_x


def render_batch(
    means, covariances, harmonics, opacities, c2w, image_shape, near, far,
    background: Optional[torch.Tensor] = None, sh_degree: Optional[int] = None,
    depth_mode: str = "depth", camera_kind: str = "erp", intrinsics=None,
    instance_cap: Optional[int] = None, views_per_position: int = 1,
    backend: str = "pallas", max_per_tile: int = 512,
) -> RenderOutput:
    """Render V views of one Gaussian set (batch_inputs' arguments) with a
    single compositor call: the CUDA kernels' launch with backend "pallas",
    the scan compositor (each tile's first `max_per_tile` instances) with
    "jax" or for an ERP view narrower than 2 tiles. Returns batched outputs
    (color [V, H, W, 3], depth/alpha [V, H, W], dropped [V])."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    attrs, assignments, wrap_x = batch_inputs(
        means, covariances, harmonics, opacities, c2w, image_shape, near, far, sh_degree,
        depth_mode, camera_kind, intrinsics, instance_cap, views_per_position)
    if background is None:
        background = torch.zeros(3, dtype=means.dtype, device=means.device)
    if backend == "pallas" and wrap_x and assignments[0].num_tiles_x < 2:
        backend = "jax"
    if backend == "jax":
        rgb, alpha, dacc = composite_tiles_scan(assignments, attrs, image_shape, background,
                                                wrap_x, max_per_tile)
    else:
        rgb, alpha, dacc = composite_tiles(assignments, attrs, image_shape, background,
                                           wrap_x=wrap_x)
    return RenderOutput(color=rgb, depth=dacc, alpha=alpha,
                        dropped=torch.stack([a.dropped for a in assignments]))


def render_tiled(
    means, covariances, harmonics, opacities, c2w, image_shape,
    camera_kind: str = "erp", intrinsics=None, near=0.1, far=100.0, background=None,
    sh_degree: Optional[int] = None, render_depth: bool = False,
    depth_mode: str = "depth", instance_cap: Optional[int] = None,
    backend: str = "pallas", max_per_tile: int = 512,
) -> RenderOutput:
    """Render one view ([H, W, 3] colour); the counterpart of the JAX
    render_tiled (camera_kind "erp" or "pinhole", backend "pallas" or
    "jax")."""
    out = render_batch(means, covariances, harmonics, opacities, c2w[None], image_shape,
                       near, far, background, sh_degree, depth_mode, camera_kind, intrinsics,
                       instance_cap, backend=backend, max_per_tile=max_per_tile)
    return RenderOutput(color=out.color[0], depth=out.depth[0] if render_depth else None,
                        alpha=out.alpha[0], dropped=out.dropped[0])
