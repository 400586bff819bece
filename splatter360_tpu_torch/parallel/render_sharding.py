"""Renders shared by several ranks: band-sharded ERP views (train.shard_render)
and face-sharded cube supervision (train.shard_faces).

Counterpart of splatter360_tpu/parallel/render_sharding.py. Every function
takes the ranks it runs over as a collective (parallel/mesh.py): `Group` for
the ranks of a process group, one part a process, or `Emulated(k)` for all k
parts in this process, one after another, through the same code.

ERP views, one at a time (render_erp_sharded):
  1. the N Gaussians, padded with zero opacity to a multiple of k, are cut
     into k shards; each rank projects its own (project_erp, SH colours)
     and packs JAX's 13 columns a Gaussian (:154-162, in its order). As in
     JAX's band render (:149), the projection takes no opacities: the
     radii are the 3-sigma boxes and `valid` has no o >= 1/255 cut, where
     the unsharded render bins the opacity-tightened boxes. A band bins an
     ERP splat into at most SPAN_H tile rows from the top of its box
     clamped to the band, so where a faint splat's box is taller than
     that, the footprint decides which rows it covers. The looser boxes'
     extra instances are gated to nothing (alpha < 1/255 outside the tight
     box), but they move a tile's block boundaries, and with them its
     early exit (alpha within 1e-4) and, rarely, a pair on the weight gate
     (ROADMAP Queue 3);
  2. the packed shards are gathered in rank order, so the table is the
     unsharded one row for row (backward: a sum reduce-scatter);
  3. the image is cut into k contiguous bands of tile rows, area-weighted
     (_band_partition: the poles are cheap, the equator dear); each rank
     culls the table to its band, bins it at (band_h, w) with the wrap (no
     elliptical cull: JAX's band_proj has no gate_s, :179-185), and
     composites it through ops/cuda/composite.composite_tiles (the fused
     kernels, or past use_fused the unfused pair);
  4. the bands are gathered and the image assembled by a static row gather.
The result is the whole image on every rank; the caller computes the same
function of it on each (its gradient comes back as each rank's band).

Cube faces (render_cube_views_face_sharded): every rank of a face group holds
the same examples' Gaussians and renders a contiguous slice of each
example's v*6 faces; the faces are gathered, and the Gaussians' gradients
summed over the group, which is shard_map's transpose.

The decodes of validation and mode=test go through decode_erp, which holds
the one rule for them: band-sharded with train.shard_render over more than
one rank, else the unsharded decoder.
"""

from __future__ import annotations

import math
from functools import lru_cache
from math import gcd
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..geometry.cubemap import cube_face_extrinsics, cube_face_intrinsics
from ..models import decoder
from ..models.decoder import DecoderOutput
from ..models.types import Gaussians
from ..ops.composite_scan import composite_tiles_scan
from ..ops.cuda.composite import build_attrs, composite_tiles
from ..ops.projection import Projected, project_erp, sh_colors
from ..ops.rasterizer import BACKENDS, RenderOutput, render_batch
from ..ops.tiling import TILE_H, assign_tiles

@lru_cache(maxsize=None)
def _band_partition(n_rows: int, n_dev: int, h: int):
    """Area-weighted contiguous tile-row bands, JAX's partition: each band's
    weight is the sphere area of its rows, |sin(phi_top) - sin(phi_bottom)|,
    plus 1.2 / n_rows a real row (the stretch and straddle floor); a DP
    over cut points minimises the heaviest band. Returns (start rows, row
    counts) in tile-row units, as tuples."""
    edges_y = np.minimum(np.arange(n_rows + 1) * TILE_H, h).astype(np.float64)
    phi = (0.5 - edges_y / max(h, 1)) * np.pi
    s = np.sin(phi)
    area = np.abs(s[:-1] - s[1:])
    real = edges_y[1:] > edges_y[:-1]  # pad rows carry no work
    w_rows = area + real * (1.2 / max(n_rows, 1)) + 1e-9
    prefix = np.concatenate([[0.0], np.cumsum(w_rows)])

    def band_w(i, j):  # weight of rows [i, j)
        return prefix[j] - prefix[i]

    # best[k][j]: the least heaviest band covering rows [0, j) with k bands
    inf = float("inf")
    best = [[inf] * (n_rows + 1) for _ in range(n_dev + 1)]
    cut = [[0] * (n_rows + 1) for _ in range(n_dev + 1)]
    best[0][0] = 0.0
    for k in range(1, n_dev + 1):
        for j in range(n_rows + 1):
            for i in range(j + 1):
                cand = max(best[k - 1][i], band_w(i, j))
                if cand < best[k][j]:
                    best[k][j] = cand
                    cut[k][j] = i
    bounds = [n_rows]
    for k in range(n_dev, 0, -1):
        bounds.append(cut[k][bounds[-1]])
    bounds = bounds[::-1]
    starts = tuple(bounds[:-1])
    rows = tuple(b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:]))
    return starts, rows


def band_layout(h: int, k: int):
    """(starts, rows, band_h) of k bands of an h-row image: the bands' first
    tile rows and tile-row counts, and the rows of every band's buffer."""
    starts, rows = _band_partition(-(-h // TILE_H), k, h)
    return starts, rows, max(max(rows), 1) * TILE_H


def _pad_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    pad = (-x.shape[0]) % k
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def pack_shard(means, covs, sh, op, c2w, image_shape, near, sh_degree):
    """One shard's projected Gaussians [n, 13], JAX's columns: u v | conic a
    b c | r g b | opacity | depth | rx ry | valid, from the projection
    without opacities (see the module docstring)."""
    proj = project_erp(means, covs, c2w, image_shape, near)
    cols = sh[..., 0] if sh.shape[-1] == 1 else sh_colors(sh, means, c2w[:3, 3], sh_degree)
    return torch.cat([proj.mean2d, proj.conic, cols, op[:, None], proj.depth[:, None],
                      proj.radius, proj.valid.to(means.dtype)[:, None]], dim=-1)


def packed_table(means, covariances, harmonics, opacities, c2w, image_shape, comm,
                 near=0.1, sh_degree: Optional[int] = None) -> torch.Tensor:
    """The Gaussians, padded with zero opacity to a multiple of comm.size
    and cut into that many shards, each projected and packed by its rank
    (pack_shard), gathered in rank order: the table [N_pad, 13] of the
    whole set, row for row; its gradient reaches each rank's shard summed
    over the ranks."""
    k = comm.size
    if sh_degree is None:
        sh_degree = int(math.isqrt(harmonics.shape[-1]) - 1)
    shards = [_pad_rows(x, k) for x in (means, covariances, harmonics, opacities)]
    n_loc = shards[0].shape[0] // k
    return comm.gather([
        pack_shard(*(x[r * n_loc:(r + 1) * n_loc] for x in shards), c2w, image_shape, near,
                   sh_degree)
        for r in comm.local_ranks])


def band_inputs(table, start: int, rows: int, band_h: int, w: int):
    """The compositor's inputs of one band: its tile assignment at
    (band_h, w) with the wrap, of the table's Gaussians whose 3-sigma boxes
    reach rows [start, start + rows) (in tile rows), with no elliptical
    cull (JAX's band_proj), and their attribute rows [1, N, 16], v measured
    from the band's top."""
    mean2d, conic, cols = table[:, 0:2], table[:, 2:5], table[:, 5:8]
    op, depth, radius = table[:, 8], table[:, 9], table[:, 10:12]
    valid = table[:, 12] > 0.5
    v_loc = mean2d[:, 1] - float(start * TILE_H)
    ry = radius[:, 1]
    in_band = (v_loc + ry >= 0.0) & (v_loc - ry < float(rows * TILE_H))
    mean_loc = torch.stack([mean2d[:, 0], v_loc], dim=-1)
    proj = Projected(mean2d=mean_loc, conic=conic, depth=depth, radius=radius,
                     valid=valid & in_band)
    with torch.no_grad():
        assignment = assign_tiles(proj, (band_h, w), wrap_x=True)
    return assignment, build_attrs(mean_loc, conic, cols, op, depth, radius)[None]


def render_erp_sharded(
    means: torch.Tensor,        # [N, 3]
    covariances: torch.Tensor,  # [N, 6] sym6 or [N, 3, 3]
    harmonics: torch.Tensor,    # [N, 3, d_sh]
    opacities: torch.Tensor,    # [N]
    c2w: torch.Tensor,          # [4, 4]
    image_shape: tuple[int, int],
    comm,
    near: float | torch.Tensor = 0.1,
    background: Optional[torch.Tensor] = None,
    sh_degree: Optional[int] = None,
    render_depth: bool = False,
    backend: str = "pallas",
    max_per_tile: int = 512,
) -> RenderOutput:
    """One ERP view with the Gaussians and the image's tile-row bands shared
    by the ranks of `comm` (see the module docstring); colour [H, W, 3],
    alpha and depth [H, W], dropped: the instances all bands lost to their
    caps. Every rank gets the whole image."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    h, w = image_shape
    starts, rows, band_h = band_layout(h, comm.size)
    if background is None:
        background = torch.zeros(3, dtype=means.dtype, device=means.device)
    table = packed_table(means, covariances, harmonics, opacities, c2w, image_shape, comm, near,
                         sh_degree)

    bands, dropped = [], torch.zeros((), dtype=torch.int32, device=means.device)
    for r in comm.local_ranks:
        assignment, attrs = band_inputs(table, starts[r], rows[r], band_h, w)
        # the scan compositor for "jax" and under 2 tiles wide, as render_batch
        if backend == "jax" or assignment.num_tiles_x < 2:
            rgb, alpha, dacc = composite_tiles_scan([assignment], attrs, (band_h, w),
                                                    background, True, max_per_tile)
        else:
            rgb, alpha, dacc = composite_tiles([assignment], attrs, (band_h, w), background,
                                               wrap_x=True)
        bands.append(torch.cat([rgb[0], alpha[0, ..., None], dacc[0, ..., None]], dim=-1))
        dropped = dropped + assignment.dropped
    image = comm.gather(bands, replicated=True)  # [k * band_h, w, 5]
    (dropped,) = comm.all_reduce([dropped])

    # band d's buffer rows [0, rows[d] * TILE_H) are its image rows from
    # starts[d] * TILE_H on; the padding of the last tile row is cropped
    src = np.zeros(h, np.int64)
    for d, (s0, r) in enumerate(zip(starts, rows)):
        lo, hi = s0 * TILE_H, min((s0 + r) * TILE_H, h)
        src[lo:hi] = d * band_h + np.arange(hi - lo)
    image = image[torch.from_numpy(src).to(image.device)]
    return RenderOutput(color=image[..., :3], depth=image[..., 4] if render_depth else None,
                        alpha=image[..., 3], dropped=dropped)


def render_erp_views_sharded(
    gaussians: Gaussians,
    extrinsics: torch.Tensor,  # [B, V, 4, 4]
    near: torch.Tensor,        # [B, V] (the cull's near)
    far: torch.Tensor,         # [B, V] (unused: the decoder's interface)
    image_shape: tuple[int, int],
    comm,
    background: Optional[torch.Tensor] = None,
    render_depth: bool = False,
    backend: str = "pallas",
    max_per_tile: int = 512,
) -> DecoderOutput:
    """decoder.render_erp_views with every view band-sharded over `comm`
    (the train.shard_render decode of validation and mode=test): one
    render_erp_sharded a view, so one compositor launch a rank and view.
    dropped is None, as in JAX."""
    b, v = extrinsics.shape[:2]
    outs = [render_erp_sharded(gaussians.means[i], gaussians.covariances[i],
                               gaussians.harmonics[i], gaussians.opacities[i], extrinsics[i, j],
                               image_shape, comm, near=near[i, j], background=background,
                               render_depth=True, backend=backend, max_per_tile=max_per_tile)
            for i in range(b) for j in range(v)]

    def stack(xs):
        return torch.stack(xs).reshape(b, v, *xs[0].shape)

    return DecoderOutput(color=stack([o.color for o in outs]),
                         depth=stack([o.depth for o in outs]) if render_depth else None,
                         alpha=stack([o.alpha for o in outs]), dropped=None)


def shards_erp(cfg, comm) -> bool:
    """Whether the ERP decodes of validation and mode=test are band-sharded
    over `comm`: with train.shard_render and more than one rank. On one rank
    (or comm None) the flag acts as off, as in JAX."""
    return bool(cfg.train.shard_render) and comm is not None and comm.size > 1


def decode_erp(cfg, comm, gaussians: Gaussians, extrinsics, near, far,
               render_depth: bool = False) -> DecoderOutput:
    """The ERP decode of validation and mode=test at cfg.dataset.image_shape
    through cfg.train.render_backend: render_erp_views_sharded over `comm`
    where shards_erp(cfg, comm), a collective that every rank of `comm`
    must enter alike, else decoder.render_erp_views on this rank alone."""
    shape, backend = tuple(cfg.dataset.image_shape), cfg.train.render_backend
    if shards_erp(cfg, comm):
        return render_erp_views_sharded(gaussians, extrinsics, near, far, shape, comm,
                                        render_depth=render_depth, backend=backend)
    return decoder.render_erp_views(gaussians, extrinsics, near, far, shape,
                                    render_depth=render_depth, backend=backend)


def render_cube_views_face_sharded(
    gaussians: Gaussians,
    extrinsics_sphere: torch.Tensor,  # [B, V, 4, 4] target ERP c2w
    near: torch.Tensor,               # [B, V]
    far: torch.Tensor,                # [B, V]
    face_shape: tuple[int, int],
    comm,
    background: Optional[torch.Tensor] = None,
    render_depth: bool = False,
    remat_faces: bool = True,
    backend: str = "pallas",
    max_per_tile: int = 2048,
) -> DecoderOutput:
    """decoder.render_cube_views with each example's v*6 faces (F R B L U D
    of each view, in order) split into `comm.size` contiguous slices, one a
    rank of the face group, which holds the same Gaussians on every rank.
    Each rank renders its slice of an example in one compositor launch, by
    render_cube_views' per-face contract (pinhole, wrap_x=False, instance
    cap max(N, 4096)); with `remat_faces` under torch.utils.checkpoint, so
    the slice is rendered again in the backward, as JAX's jax.checkpoint of
    each face. The faces are gathered, so every rank gets all of them, and
    the Gaussians' gradients are summed over the ranks."""
    b, v = extrinsics_sphere.shape[:2]
    vf, k = v * 6, comm.size
    if vf % k:
        raise ValueError(f"shard_faces: {vf} faces do not split over {k} ranks "
                         f"(use face_mesh_split)")
    per = vf // k
    n = gaussians.means.shape[-2]
    means, covs, sh, op = comm.shared(*gaussians)
    faces_c2w = cube_face_extrinsics(extrinsics_sphere).reshape(b, vf, 4, 4)
    near_f, far_f = near.repeat_interleave(6, dim=1), far.repeat_interleave(6, dim=1)
    intr = cube_face_intrinsics(extrinsics_sphere.dtype, extrinsics_sphere.device)
    # a slice starts at a multiple of per, so runs of gcd(per, 6) faces
    # never cross a view: each run shares its view's position and SH colours
    kw = dict(camera_kind="pinhole", intrinsics=intr, instance_cap=max(n, 4096),
              views_per_position=gcd(per, 6), background=background, backend=backend,
              max_per_tile=max_per_tile)

    def faces(m, c, s, o, c2w, nr, fr):
        out = render_batch(m, c, s, o, c2w, face_shape, nr, fr, **kw)
        return out.color, out.depth, out.alpha, out.dropped

    parts = []
    for r in comm.local_ranks:
        sl = slice(r * per, (r + 1) * per)
        items = []
        for i in range(b):
            args = (means[i], covs[i], sh[i], op[i], faces_c2w[i, sl], near_f[i, sl],
                    far_f[i, sl])
            items.append(checkpoint(faces, *args, use_reentrant=False) if remat_faces
                         else faces(*args))
        parts.append([torch.stack(x) for x in zip(*items)])  # each [B, per, ...]
    color, depth, alpha, dropped = (comm.gather([p[j] for p in parts], dim=1, replicated=True)
                                    for j in range(4))
    fh, fw = face_shape
    return DecoderOutput(
        color=color.reshape(b, v, 6, fh, fw, 3),
        depth=depth.reshape(b, v, 6, fh, fw) if render_depth else None,
        alpha=alpha.reshape(b, v, 6, fh, fw),
        dropped=dropped.reshape(b, v, 6),
    )
