"""Fused tile compositor: the CUDA kernels' wrappers, their plain versions, and
the autograd function that joins them.

Counterpart of splatter360_tpu/ops/pallas/composite.py's fused path
(`_forward_kernel_fused`, `_backward_kernel_fused`, `_render_core_fused` and
its custom VJP, `composite_tiles_pallas`). The kernels are
csrc/composite_fwd.cu and csrc/composite_bwd.cu. `composite_forward` and
`composite_backward` launch them for CUDA tensors and use the plain versions
for CPU tensors; there is no fallback from one to the other.

Layouts: attrs [V, N, 16] f32 in the row order u v a b c o r g b depth rx ry
0 0 0 0 (the JAX [NSUB, 128] packed table is this array reshaped); gidx
[V, K] int32 with K a multiple of 128; starts/counts [V, T] int32. Forward
output [V, T, 8, 2048] f32 per tile: r g b depth T logT n_processed 0. The
backward reads the cotangents of planes 0-4 and returns g_attrs [V, N, 16]
(rows 10-15 zero).
"""

from __future__ import annotations

import ctypes

import torch

from ..tiling import BLOCK, TILE_H, TILE_W, TileAssignment

CHUNK = BLOCK
N_PIX = TILE_H * TILE_W
ROWS = 16
N_GRAD = 10  # gradient rows: u v a b c o r g b depth
N_REGIONS = 16  # thread blocks per tile in the forward kernel (N_SUB in the source)
_NEG_CUTOFF = -4.5
_ALPHA_MIN = 1.0 / 255.0
_T_EPS = 1e-4
_LOG_T_EPS = -9.21034  # log(1e-4)
# tiles per step of the plain versions: bounds their [tiles, 2048, 128]
# temporaries to ~270 MB each
_PLAIN_TILES_PER_STEP = 256

KERNEL_NAME = "composite_forward_fused"
BWD_KERNEL_NAME = "composite_backward_fused"
# calls that launch a CUDA kernel, one per call: a forward call is the
# forward kernel's two grid passes (csrc/composite_fwd.cu), a backward call
# one grid (csrc/composite_bwd.cu), each over all its views. The plain
# versions never count.
launch_counts = {KERNEL_NAME: 0, BWD_KERNEL_NAME: 0}


def build_attrs(mean2d, conic, colors, opacities, depths, radii) -> torch.Tensor:
    """Per-Gaussian attribute table [N, 16]."""
    z = torch.zeros_like(opacities)
    cols = [
        mean2d[:, 0], mean2d[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
        opacities, colors[:, 0], colors[:, 1], colors[:, 2], depths,
        radii[:, 0], radii[:, 1], z, z, z, z,
    ]
    return torch.stack(cols, dim=-1).to(torch.float32).contiguous()


def _check(attrs, gidx, starts, counts, nty, ntx):
    if attrs.dim() != 3 or attrs.shape[-1] != ROWS or attrs.dtype != torch.float32:
        raise ValueError(f"attrs must be [V, N, {ROWS}] float32, got {tuple(attrs.shape)} {attrs.dtype}")
    v = attrs.shape[0]
    t = nty * ntx
    if gidx.dtype != torch.int32 or gidx.dim() != 2 or gidx.shape[0] != v or gidx.shape[1] % CHUNK:
        raise ValueError(f"gidx must be [V, K] int32 with K % {CHUNK} == 0, got {tuple(gidx.shape)} {gidx.dtype}")
    for name, x in (("starts", starts), ("counts", counts)):
        if x.dtype != torch.int32 or tuple(x.shape) != (v, t):
            raise ValueError(f"{name} must be [{v}, {t}] int32, got {tuple(x.shape)} {x.dtype}")
    devs = {x.device for x in (attrs, gidx, starts, counts)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check_backward(starts, g_planes, lt_final, nproc):
    v, t = starts.shape
    if nproc.dtype != torch.int32 or tuple(nproc.shape) != (v, t):
        raise ValueError(f"nproc must be [{v}, {t}] int32, got {tuple(nproc.shape)} {nproc.dtype}")
    if g_planes.dtype != torch.float32 or tuple(g_planes.shape) != (v, t, 8, N_PIX):
        raise ValueError(f"g_planes must be [{v}, {t}, 8, {N_PIX}] float32, "
                         f"got {tuple(g_planes.shape)} {g_planes.dtype}")
    if lt_final.dtype != torch.float32 or tuple(lt_final.shape) != (v, t, N_PIX):
        raise ValueError(f"lt_final must be [{v}, {t}, {N_PIX}] float32, "
                         f"got {tuple(lt_final.shape)} {lt_final.dtype}")
    devs = {x.device for x in (starts, g_planes, lt_final, nproc)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def composite_forward(attrs, gidx, starts, counts, nty: int, ntx: int,
                      w_img: float, wrap_x: bool) -> torch.Tensor:
    """Composite every (view, tile); returns the planes [V, T, 8, 2048]."""
    _check(attrs, gidx, starts, counts, nty, ntx)
    if not attrs.is_cuda:
        return composite_forward_plain(attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x)
    from .build import load

    fn = load("composite_fwd").composite_fwd_fused
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    attrs, gidx = attrs.contiguous(), gidx.contiguous()
    starts, counts = starts.contiguous(), counts.contiguous()
    v, n, _ = attrs.shape
    t = nty * ntx
    out = torch.empty((v, t, 8, N_PIX), dtype=torch.float32, device=attrs.device)
    # each tile region's own exit block, passed from the kernel's first pass
    # to its second
    region_exits = torch.empty((v, t, N_REGIONS), dtype=torch.int32, device=attrs.device)
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), gidx.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                 out.data_ptr(), region_exits.data_ptr(), v, n, gidx.shape[1], nty, ntx,
                 float(w_img), int(bool(wrap_x)), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {err}")
    launch_counts[KERNEL_NAME] += 1
    return out


def composite_backward(attrs, gidx, starts, counts, g_planes, lt_final, nproc,
                       nty: int, ntx: int, w_img: float, wrap_x: bool) -> torch.Tensor:
    """Gradient of the planes' rows 0-4 with respect to attrs: g_planes
    [V, T, 8, 2048] is the planes' cotangent, lt_final [V, T, 2048] and
    nproc [V, T] int32 are the forward's logT and n_processed planes.
    Returns g_attrs [V, N, 16]."""
    _check(attrs, gidx, starts, counts, nty, ntx)
    _check_backward(starts, g_planes, lt_final, nproc)
    if not attrs.is_cuda:
        return composite_backward_plain(attrs, gidx, starts, counts, g_planes, lt_final, nproc,
                                        nty, ntx, w_img, wrap_x)
    from .build import load

    fn = load("composite_bwd").composite_bwd_fused
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    attrs, gidx = attrs.contiguous(), gidx.contiguous()
    starts, counts = starts.contiguous(), counts.contiguous()
    g_planes, lt_final, nproc = g_planes.contiguous(), lt_final.contiguous(), nproc.contiguous()
    v, n, _ = attrs.shape
    g_attrs = torch.zeros_like(attrs)
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), gidx.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                 g_planes.data_ptr(), lt_final.data_ptr(), nproc.data_ptr(), g_attrs.data_ptr(),
                 v, n, gidx.shape[1], nty, ntx, float(w_img), int(bool(wrap_x)), stream)
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL_NAME} launch failed: cudaError {err}")
    launch_counts[BWD_KERNEL_NAME] += 1
    return g_attrs


class _Walk:
    """What both plain versions share: per (view, tile) pair, its segment,
    pixel coordinates, and the gather + alpha of one of its blocks."""

    def __init__(self, attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x):
        v = attrs.shape[0]
        t = nty * ntx
        dev = attrs.device
        self.attrs, self.gidx, self.k = attrs, gidx, gidx.shape[1]
        self.w_img, self.wrap_x = w_img, wrap_x
        self.vt = v * t
        self.starts = starts.reshape(self.vt).long()
        self.ends = self.starts + counts.reshape(self.vt).long()
        self.view_of = torch.arange(v, device=dev).repeat_interleave(t)
        tile_of = torch.arange(t, device=dev).repeat(v)
        self.blk0 = self.starts // CHUNK
        self.n_blocks = (self.ends + CHUNK - 1) // CHUNK - self.blk0
        self.x0 = ((tile_of % ntx) * TILE_W).to(torch.float32)
        y0 = ((tile_of // ntx) * TILE_H).to(torch.float32)
        p = torch.arange(N_PIX, device=dev)
        self.px = (p % TILE_W).to(torch.float32)[None, :] + self.x0[:, None]
        self.py = (p // TILE_W).to(torch.float32)[None, :] + y0[:, None]
        self.lanes = torch.arange(CHUNK, device=dev)

    def block(self, live, j):
        """Block j (a [L] tensor) of the pairs `live`: (gathered Gaussian
        indices [L, 128], in-segment mask, rows [L, 128, 16] zeroed outside
        the segment, alpha / dx / dy [L, 2048, 128], gate)."""
        g = (self.blk0[live] + j)[:, None] * CHUNK + self.lanes[None, :]
        inseg = (g >= self.starts[live][:, None]) & (g < self.ends[live][:, None])
        gi = self.gidx[self.view_of[live][:, None], g.clamp(max=self.k - 1)].long()
        data = self.attrs[self.view_of[live][:, None], gi]
        data = torch.where(inseg[..., None], data, torch.zeros_like(data))
        u = data[..., 0]
        if self.wrap_x:
            xc = (self.x0[live] + TILE_W * 0.5)[:, None]
            u = u + self.w_img * torch.round((xc - u) / self.w_img)
        vv, a, b, c, o = (data[..., r][:, None, :] for r in (1, 2, 3, 4, 5))
        rad_x, rad_y = data[..., 10][:, None, :], data[..., 11][:, None, :]
        dx = self.px[live][:, :, None] - u[:, None, :]  # [L, 2048, 128]
        dy = self.py[live][:, :, None] - vv
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = o * torch.exp(power)
        gate = ((dx.abs() <= rad_x) & (dy.abs() <= rad_y) & (power > _NEG_CUTOFF)
                & (power <= 0.0) & (alpha >= _ALPHA_MIN))
        alpha = torch.where(gate, torch.clamp(alpha, max=0.99), torch.zeros_like(alpha))
        return gi, inseg, data, alpha, dx, dy, gate


def composite_forward_plain(attrs, gidx, starts, counts, nty: int, ntx: int,
                            w_img: float, wrap_x: bool,
                            stats: dict | None = None) -> torch.Tensor:
    """The forward kernel's function in PyTorch ops, same outputs.

    Vectorised over (view, tile) pairs, it walks the block index with the
    same per-tile exit test, and inside a block walks the 128 lanes in order
    so that the prefix and colour sums round exactly as the kernel's do.
    `stats`, if given, receives the number of (pixel, instance) pairs that
    pass the gate under "pairs_alive"."""
    v = attrs.shape[0]
    t = nty * ntx
    dev = attrs.device
    walk = _Walk(attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x)
    vt = walk.vt
    tacc = torch.zeros(vt, N_PIX, dtype=torch.float32, device=dev)
    acc = torch.zeros(vt, N_PIX, 4, dtype=torch.float32, device=dev)
    nproc = torch.zeros(vt, dtype=torch.long, device=dev)
    running = torch.ones(vt, dtype=torch.bool, device=dev)
    for j in range(int(walk.n_blocks.max().item()) if vt else 0):
        running = running & (j < walk.n_blocks) & (tacc.max(dim=1).values >= _LOG_T_EPS)
        live_all = running.nonzero().squeeze(1)
        if live_all.numel() == 0:
            break
        nproc[live_all] += 1
        for live in live_all.split(_PLAIN_TILES_PER_STEP):
            _, _, data, alpha, dx, dy, gate = walk.block(live, j)
            if stats is not None:
                stats["pairs_alive"] = stats.get("pairs_alive", 0) + int(gate.sum())
            del dx, dy, gate
            lg = torch.log1p(-alpha)
            cd = data[..., 6:10]  # [L, 128, 4]
            t_blk = tacc[live]
            a_blk = acc[live]
            e = torch.zeros_like(t_blk)
            for lane in range(CHUNK):
                al = alpha[:, :, lane]
                t_i = torch.exp(t_blk + e)
                w = torch.where(t_i * (1.0 - al) >= _T_EPS, al * t_i, torch.zeros_like(al))
                a_blk = a_blk + w[..., None] * cd[:, None, lane, :]
                e = e + lg[:, :, lane]
            tacc[live] = t_blk + e
            acc[live] = a_blk

    out = torch.zeros(vt, 8, N_PIX, dtype=torch.float32, device=dev)
    out[:, 0:4] = acc.transpose(1, 2)
    out[:, 4] = torch.exp(tacc)
    out[:, 5] = tacc
    out[:, 6] = nproc.to(torch.float32)[:, None]
    return out.reshape(v, t, 8, N_PIX)


def _suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums over the last (lane) axis."""
    return torch.flip(torch.cumsum(torch.flip(x, [-1]), dim=-1), [-1])


def composite_backward_plain(attrs, gidx, starts, counts, g_planes, lt_final, nproc,
                             nty: int, ntx: int, w_img: float, wrap_x: bool,
                             stats: dict | None = None) -> torch.Tensor:
    """The backward kernel's function in PyTorch ops, same output.

    Vectorised over (view, tile) pairs, it walks each pair's processed blocks
    last first with the kernel's telescoped logT and tile-wide gate. Inside a
    block it sums log1p(-alpha) over the lanes in order, as the kernel does,
    so the gate decides alike; the back-to-front walk is taken as suffix sums
    over the lanes, which round differently from the kernel's running sums,
    as do the sums over a tile's pixels. The derivative of alpha is written
    out (d alpha / d power = alpha, also at the 0.99 cap, as the Pallas
    kernel takes it), not autograd of the forward. `stats`, if given,
    receives "blocks_walked", "blocks_gated", "pairs_walked" (gate-passing
    pairs of walked blocks), "pairs_gated" (those of gated blocks) and
    "rows_written" ((instance, tile) pairs of gated blocks)."""
    v, n, _ = attrs.shape
    dev = attrs.device
    walk = _Walk(attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x)
    vt = walk.vt
    nproc_f = nproc.reshape(vt).long()
    planes = g_planes.reshape(vt, 8, N_PIX)
    g_rgbd = planes[:, 0:4].transpose(1, 2)  # [vt, 2048, 4]
    lt = lt_final.reshape(vt, N_PIX)
    gt_term = planes[:, 4] * torch.exp(lt)
    suffix = torch.zeros(vt, N_PIX, dtype=torch.float32, device=dev)
    a_psi = torch.zeros(vt, N_PIX, dtype=torch.float32, device=dev)
    g_flat = torch.zeros(v * n, ROWS, dtype=torch.float32, device=dev)
    st = {"blocks_walked": 0, "blocks_gated": 0, "pairs_walked": 0, "pairs_gated": 0,
          "rows_written": 0}
    for rj in range(int(nproc_f.max().item()) if vt else 0):
        for live in (nproc_f > rj).nonzero().squeeze(1).split(_PLAIN_TILES_PER_STEP):
            gi, inseg, data, alpha, dx, dy, gate = walk.block(live, nproc_f[live] - 1 - rj)
            st["blocks_walked"] += live.numel()
            st["pairs_walked"] += int(gate.sum())
            lg = torch.log1p(-alpha)
            sum_lg = torch.zeros(live.numel(), N_PIX, dtype=torch.float32, device=dev)
            for lane in range(CHUNK):
                sum_lg = sum_lg + lg[:, :, lane]
            log_t_end = lt[live] - suffix[live]
            log_t_start = log_t_end - sum_lg
            suffix[live] = suffix[live] + sum_lg
            keep = (log_t_start.max(dim=1).values >= _LOG_T_EPS).nonzero().squeeze(1)
            if keep.numel() == 0:
                continue
            sel = live[keep]
            gi, inseg, data = gi[keep], inseg[keep], data[keep]
            alpha, dx, dy, lg = alpha[keep], dx[keep], dy[keep], lg[keep]
            log_t_end = log_t_end[keep]
            st["blocks_gated"] += sel.numel()
            st["pairs_gated"] += int(gate[keep].sum())
            st["rows_written"] += int(inseg.sum())
            del gate
            gc = g_rgbd[sel][:, :, None, :]  # [S, 2048, 1, 4]
            cd = data[:, None, :, 6:10]  # [S, 1, 128, 4]
            lg_suffix = _suffix_sum(lg)  # inclusive
            t_i = torch.exp(log_t_end[:, :, None] - lg_suffix)
            one_m = 1.0 - alpha
            contrib = t_i * one_m >= _T_EPS
            gamma = (gc[..., 0] * cd[..., 0] + gc[..., 1] * cd[..., 1] + gc[..., 2] * cd[..., 2]
                     + gc[..., 3] * cd[..., 3])
            zero = torch.zeros_like(alpha)
            w = torch.where(contrib, alpha * t_i, zero)
            psi = w * gamma
            psi_suffix = _suffix_sum(psi)
            strict = torch.cat([psi_suffix[..., 1:], zero[..., :1]], dim=-1)
            later = strict + a_psi[sel][:, :, None] + gt_term[sel][:, :, None]
            g_alpha = torch.where(contrib, t_i * gamma - later / one_m, zero)
            a_psi[sel] = a_psi[sel] + psi_suffix[..., 0]
            g_p = g_alpha * alpha
            m = [g_p.sum(1), (g_p * dx).sum(1), (g_p * dy).sum(1), (g_p * dx * dx).sum(1),
                 (g_p * dy * dy).sum(1), (g_p * dx * dy).sum(1)]
            m += [(w * gc[..., ch]).sum(1) for ch in range(4)]
            del t_i, one_m, contrib, gamma, zero, w, psi, psi_suffix, strict, later, g_alpha, g_p
            a, b, c, o = (data[..., r] for r in (2, 3, 4, 5))
            grad = torch.stack([
                a * m[1] + b * m[2], c * m[2] + b * m[1], -0.5 * m[3], -m[5], -0.5 * m[4],
                m[0] / torch.clamp(o, min=1e-12), m[6], m[7], m[8], m[9],
            ], dim=-1)
            grad = torch.where(inseg[..., None], grad, torch.zeros_like(grad))
            flat = (walk.view_of[sel][:, None] * n + gi).reshape(-1)
            g_flat[:, :N_GRAD].index_add_(0, flat, grad.reshape(-1, N_GRAD))
    if stats is not None:
        stats.update(st)
    return g_flat.reshape(v, n, ROWS)


class _CompositeFused(torch.autograd.Function):
    """composite_forward with the fused backward as its VJP (the contract of
    `_render_core_fused`'s custom_vjp): the cotangents of planes 0-4 (r g b
    depth T) reach the backward; planes 5-7 carry no gradient."""

    @staticmethod
    def forward(ctx, attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x):
        planes = composite_forward(attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x)
        lt_final = planes[:, :, 5].clone()
        nproc = planes[:, :, 6, 0].to(torch.int32)
        ctx.save_for_backward(attrs, gidx, starts, counts, lt_final, nproc)
        ctx.args = (nty, ntx, w_img, wrap_x)
        return planes

    @staticmethod
    def backward(ctx, g_planes):
        attrs, gidx, starts, counts, lt_final, nproc = ctx.saved_tensors
        g_attrs = composite_backward(attrs, gidx, starts, counts, g_planes.contiguous(),
                                     lt_final, nproc, *ctx.args)
        return g_attrs, None, None, None, None, None, None, None


def compose_planes(planes: torch.Tensor, image_shape, nty: int, ntx: int,
                   background: torch.Tensor):
    """Planes [V, T, 8, 2048] -> (rgb [V, H, W, 3] over the background,
    alpha [V, H, W], depth [V, H, W])."""
    h, w = image_shape
    v = planes.shape[0]
    acc = planes.reshape(v, nty, ntx, 8, TILE_H, TILE_W)
    img = acc.permute(0, 3, 1, 4, 2, 5).reshape(v, 8, nty * TILE_H, ntx * TILE_W)
    rgb = img[:, 0:3, :h, :w].permute(0, 2, 3, 1)
    dacc = img[:, 3, :h, :w]
    trans = img[:, 4, :h, :w]
    rgb = rgb + trans[..., None] * background
    return rgb, 1.0 - trans, dacc


def composite_tiles(assignments: list[TileAssignment], attrs: torch.Tensor,
                    image_shape, background: torch.Tensor, wrap_x: bool):
    """Composite V views in one launch: assignments (one per view) and attrs
    [V, N, 16] -> (rgb [V, H, W, 3], alpha [V, H, W], depth [V, H, W]).
    Differentiable in attrs (rows 0-9) through the fused backward."""
    ntx, nty = assignments[0].num_tiles_x, assignments[0].num_tiles_y
    if wrap_x and ntx < 2:
        raise ValueError(
            f"equirect wrap needs a width of at least 2 tiles (w={image_shape[1]} "
            f"< {2 * TILE_W}): the compositor re-centres u per tile, which cannot "
            f"serve both sides of the seam inside one tile"
        )
    gidx = torch.stack([a.gaussian_idx for a in assignments])
    starts = torch.stack([a.tile_starts for a in assignments])
    counts = torch.stack([a.tile_counts for a in assignments])
    planes = _CompositeFused.apply(attrs, gidx, starts, counts, nty, ntx,
                                   float(image_shape[1]), wrap_x)
    return compose_planes(planes, image_shape, nty, ntx, background)
