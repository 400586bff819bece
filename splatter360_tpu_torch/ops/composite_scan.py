"""The scan tile compositor: the `render_backend: "jax"` compositor.

Counterpart of splatter360_tpu/ops/composite_jax.py (`composite_tiles_jax`),
which is XLA ops in the JAX package (a lax.scan per tile, differentiated by
autograd), so here it is plain PyTorch ops on whatever device its inputs
are on, differentiated by autograd. Its semantics are composite_jax's, not
the CUDA kernels':
  * each tile walks a static `max_per_tile` slice of its depth-sorted
    segment, padded with zero-opacity slots or truncated;
  * alpha = min(0.99, o exp(power)), kept where the pixel lies inside the
    Gaussian's radius box, -4.5 < power <= 0 and alpha >= 1/255;
  * T decays unmasked, T_new = T (1 - alpha), and a weight alpha T counts
    only while T_new >= 1e-4;
  * with `wrap_x` the x offset is re-centred as dx - w round(dx / w).
Autograd gives dalpha/dpower = 0 at the 0.99 cap, as JAX's autograd does
(the Pallas backward and the CUDA kernels take alpha there).

The walk stops after the longest segment (at most `max_per_tile` slots):
the padded slots past it have zero opacity, so they multiply T by 1 and add
nothing, and the result is the same. An image narrower than a tile (one
tile column: a cube face, a narrow ERP view) composites only its own
columns; the others are cropped away and carry no gradient. Slots are taken `SCAN_CHUNK` at a time
(alpha of a chunk's slots at once, T step by step in slot order, as the
scan multiplies it); under autograd each chunk is a torch.utils.checkpoint,
so the backward keeps one chunk's intermediates at a time and the chunks'
carried planes, not every step's.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .tiling import TILE_H, TILE_W, TileAssignment

SCAN_NAME = "composite_scan"
# calls of composite_tiles_scan (a render of V views), counted as the
# kernels' launches are (ops/cuda/composite.py launch_counts)
scan_counts = {SCAN_NAME: 0}
SCAN_CHUNK = 64
_ALPHA_CAP = 0.99
_ALPHA_MIN = 1.0 / 255.0
_T_EPS = 1e-4


def _chunk(rgb, trans, dacc, rows, gx, gy, w_img: float, wrap_x: bool):
    """Composite a chunk of slots rows [VT, K, 16] (u v a b c o r g b depth
    rx ry, the opacity zero on padded slots) into the carried planes rgb
    [VT, 3, TH, tw], trans and dacc [VT, TH, tw]."""
    col = lambda i: rows[:, :, i, None, None]  # noqa: E731  [VT, K, 1, 1]
    dx = gx[:, None] - col(0)
    if wrap_x:
        dx = dx - w_img * torch.round(dx / w_img)
    dy = gy[:, None] - col(1)
    power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
    alpha = torch.minimum(col(5) * torch.exp(power), power.new_tensor(_ALPHA_CAP))
    keep = ((dx.abs() <= col(10)) & (dy.abs() <= col(11)) & (power > -4.5) & (power <= 0.0)
            & (alpha >= _ALPHA_MIN))
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    weights = []
    for k in range(rows.shape[1]):
        a = alpha[:, k]
        trans_new = trans * (1.0 - a)
        weights.append(torch.where(trans_new >= _T_EPS, a * trans, torch.zeros_like(a)))
        trans = trans_new
    wts = torch.stack(weights, dim=1)  # [VT, K, TH, TW]
    rgb = rgb + torch.einsum("nkhw,nkc->nchw", wts, rows[:, :, 6:9])
    dacc = dacc + torch.einsum("nkhw,nk->nhw", wts, rows[:, :, 9])
    return rgb, trans, dacc


def composite_tiles_scan(assignments: list[TileAssignment], attrs: torch.Tensor, image_shape,
                         background: torch.Tensor, wrap_x: bool, max_per_tile: int = 2048):
    """Composite V views: assignments (one per view) and attrs [V, N, 16]
    (ops/cuda/composite.py's row order) -> (rgb [V, H, W, 3], alpha
    [V, H, W], depth [V, H, W]), composite_tiles_jax's function of each
    view; differentiable in attrs by autograd."""
    scan_counts[SCAN_NAME] += 1
    h, w = image_shape
    ntx, nty = assignments[0].num_tiles_x, assignments[0].num_tiles_y
    v, t = attrs.shape[0], ntx * nty
    dev, dt = attrs.device, attrs.dtype
    gidx = torch.stack([a.gaussian_idx for a in assignments]).long()
    starts = torch.stack([a.tile_starts for a in assignments]).long()
    counts = torch.stack([a.tile_counts for a in assignments]).long()
    k_inst = gidx.shape[1]
    m = min(max_per_tile, int(counts.max()))

    slot = torch.arange(m, device=dev)
    seg = (starts[..., None] + slot).clamp(0, k_inst - 1)  # [V, T, M]
    in_seg = slot < counts[..., None]
    gi = torch.where(in_seg, torch.gather(gidx, 1, seg.reshape(v, -1)).reshape(v, t, m), 0)
    rows = attrs[torch.arange(v, device=dev)[:, None, None], gi]  # [V, T, M, 16]
    rows = torch.cat([rows[..., :5], torch.where(in_seg, rows[..., 5], 0.0)[..., None],
                      rows[..., 6:]], dim=-1).reshape(v * t, m, -1)

    tw = min(TILE_W, w) if ntx == 1 else TILE_W
    tid = torch.arange(t, device=dev).repeat(v)
    gx = (tid % ntx * TILE_W).to(dt)[:, None, None] + torch.arange(tw, device=dev, dtype=dt)
    gy = (tid // ntx * TILE_H).to(dt)[:, None, None] + torch.arange(TILE_H, device=dev,
                                                                     dtype=dt)[:, None]
    gx, gy = gx.expand(-1, TILE_H, tw), gy.expand(-1, TILE_H, tw)
    rgb = torch.zeros((v * t, 3, TILE_H, tw), device=dev, dtype=dt)
    trans = torch.ones((v * t, TILE_H, tw), device=dev, dtype=dt)
    dacc = torch.zeros_like(trans)
    remat = torch.is_grad_enabled() and rows.requires_grad
    for k0 in range(0, m, SCAN_CHUNK):
        args = (rgb, trans, dacc, rows[:, k0:k0 + SCAN_CHUNK], gx, gy, float(w), wrap_x)
        if remat:
            rgb, trans, dacc = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            rgb, trans, dacc = _chunk(*args)

    planes = torch.cat([rgb, dacc[:, None], trans[:, None]], dim=1).reshape(
        v, nty, ntx, 5, TILE_H, tw)
    img = planes.permute(0, 3, 1, 4, 2, 5).reshape(v, 5, nty * TILE_H, ntx * tw)[..., :h, :w]
    trans = img[:, 4]
    return img[:, :3].permute(0, 2, 3, 1) + trans[..., None] * background, 1.0 - trans, img[:, 3]
