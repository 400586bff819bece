"""Gaussians + target cameras -> rendered panoramas or cube faces.

Counterpart of splatter360_tpu/models/decoder.py (`render_erp_views`,
`render_cube_views`). The JAX vmap over (batch, view[, face]) becomes a
loop over the batch; all views (or all V*6 faces) of a batch item are one
compositor launch. The JAX `sequential` ("unroll", lax.map) face schedules
are XLA devices with no PyTorch counterpart; `remat_faces` becomes
torch.utils.checkpoint of each target view's 6 faces.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..geometry.cubemap import cube_face_extrinsics, cube_face_intrinsics
from ..ops.rasterizer import render_batch
from .types import Gaussians


class DecoderOutput(NamedTuple):
    color: torch.Tensor              # [B, V, H, W, 3] or [B, V, 6, f, f, 3]
    depth: Optional[torch.Tensor]    # matching spatial shape, or None
    alpha: Optional[torch.Tensor]    # matching spatial shape
    dropped: Optional[torch.Tensor] = None  # [B, V] / [B, V, 6] int32 splats lost to caps


def render_erp_views(
    gaussians: Gaussians,
    extrinsics: torch.Tensor,  # [B, V, 4, 4] target ERP c2w
    near: torch.Tensor,        # [B, V]
    far: torch.Tensor,         # [B, V]
    image_shape: tuple[int, int],
    background: Optional[torch.Tensor] = None,
    render_depth: bool = False,
    backend: str = "pallas",
    max_per_tile: int = 2048,
) -> DecoderOutput:
    """Metric depth only: the serving path renders no other depth mode.
    `backend` and `max_per_tile` as in ops/rasterizer.render_batch."""
    outs = [
        render_batch(gaussians.means[i], gaussians.covariances[i],
                     gaussians.harmonics[i], gaussians.opacities[i],
                     extrinsics[i], image_shape, near[i], far[i],
                     background=background, backend=backend, max_per_tile=max_per_tile)
        for i in range(extrinsics.shape[0])
    ]
    return DecoderOutput(
        color=torch.stack([o.color for o in outs]),
        depth=torch.stack([o.depth for o in outs]) if render_depth else None,
        alpha=torch.stack([o.alpha for o in outs]),
        dropped=torch.stack([o.dropped for o in outs]),
    )


def cube_face_batch(extrinsics: torch.Tensor, near: torch.Tensor, far: torch.Tensor, n: int):
    """The render_batch arguments of the 6 cube faces (F R B L U D) of V
    target views (extrinsics [V, 4, 4] ERP c2w, near/far [V]) of N
    Gaussians: (c2w [V*6, 4, 4], near [V*6], far [V*6], the pinhole
    keywords). A face sees about a sixth of the splats, so each face's
    instance list is capped at max(N, 4096), as in the JAX package; the 6
    faces of a view share its position and so its SH colours."""
    return (cube_face_extrinsics(extrinsics).reshape(-1, 4, 4), near.repeat_interleave(6),
            far.repeat_interleave(6),
            dict(camera_kind="pinhole",
                 intrinsics=cube_face_intrinsics(extrinsics.dtype, extrinsics.device),
                 instance_cap=max(n, 4096), views_per_position=6))


def render_cube_views(
    gaussians: Gaussians,
    extrinsics_sphere: torch.Tensor,  # [B, V, 4, 4] target ERP c2w
    near: torch.Tensor,               # [B, V]
    far: torch.Tensor,                # [B, V]
    face_shape: tuple[int, int],
    background: Optional[torch.Tensor] = None,
    render_depth: bool = False,
    depth_mode: str = "depth",
    remat_faces: bool = False,
    backend: str = "pallas",
    max_per_tile: int = 2048,
) -> DecoderOutput:
    """The 6 cube faces (F R B L U D) of every target view: colour
    [B, V, 6, fh, fw, 3], depth and alpha [B, V, 6, fh, fw], dropped
    [B, V, 6] (cube_face_batch's faces). All V*6 faces of a batch item go
    through one compositor launch; with `remat_faces`, one launch per target
    view, each under torch.utils.checkpoint, which keeps only its inputs for
    the backward and renders its 6 faces again there."""
    b, v = extrinsics_sphere.shape[:2]
    n = gaussians.means.shape[-2]

    def faces(means, covs, sh, op, c2w, nr, fr):
        c2w, nr, fr, kw = cube_face_batch(c2w, nr, fr, n)
        out = render_batch(means, covs, sh, op, c2w, face_shape, nr, fr, background=background,
                           depth_mode=depth_mode, backend=backend, max_per_tile=max_per_tile,
                           **kw)
        return out.color, out.depth, out.alpha, out.dropped

    outs = []
    for i in range(b):
        g = (gaussians.means[i], gaussians.covariances[i], gaussians.harmonics[i],
             gaussians.opacities[i])
        if remat_faces:
            per_view = [checkpoint(faces, *g, extrinsics_sphere[i, j:j + 1], near[i, j:j + 1],
                                   far[i, j:j + 1], use_reentrant=False) for j in range(v)]
            outs.append([torch.cat(x) for x in zip(*per_view)])
        else:
            outs.append(faces(*g, extrinsics_sphere[i], near[i], far[i]))
    color, depth, alpha, dropped = (torch.stack(x) for x in zip(*outs))
    fh, fw = face_shape
    return DecoderOutput(
        color=color.reshape(b, v, 6, fh, fw, 3),
        depth=depth.reshape(b, v, 6, fh, fw) if render_depth else None,
        alpha=alpha.reshape(b, v, 6, fh, fw),
        dropped=dropped.reshape(b, v, 6),
    )
