"""Tile compositor: the CUDA kernels' wrappers, their plain versions, and the
autograd functions that join them.

Counterpart of splatter360_tpu/ops/pallas/composite.py: the fused path
(`_forward_kernel_fused`, `_backward_kernel_fused`, `_render_core_fused`)
and the unfused one (`_forward_kernel`, `_backward_kernel`, `_render_core`),
chosen per N as `composite_tiles_pallas` chooses (`use_fused`). The kernels
are csrc/composite_fwd.cu, csrc/composite_bwd.cu, csrc/composite_fwd_unfused.cu
and csrc/composite_bwd_unfused.cu. Each wrapper launches its kernel for CUDA
tensors and uses its plain version for CPU tensors; there is no fallback
from one to the other.

Layouts: attrs [V, N, 16] f32 in the row order u v a b c o r g b depth rx ry
0 0 0 0 (the JAX [NSUB, 128] packed table is this array reshaped); gidx and
tile_ids [V, K] int32 with K a multiple of 128; starts/counts [V, T] int32;
the unfused path's instance blocks inst [V, K/128, 16, 128] f32. Forward
output [V, T, 8, 2048] f32 per tile: r g b depth T logT n_processed 0. The
backwards read the cotangents of planes 0-4; the fused one returns g_attrs
[V, N, 16] (rows 10-15 zero), the unfused one tile-owned gradient blocks
dout [V, K/128 + T, 16, 128] that `scatter_out_blocks` adds into g_attrs.
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
UNFUSED_KERNEL_NAME = "composite_forward_unfused"
UNFUSED_BWD_KERNEL_NAME = "composite_backward_unfused"
# calls that launch a CUDA kernel, one per call: a forward call is the
# forward kernel's two grid passes (csrc/composite_fwd*.cu), a backward call
# one grid (csrc/composite_bwd*.cu), each over all its views. The plain
# versions never count.
launch_counts = {KERNEL_NAME: 0, BWD_KERNEL_NAME: 0, UNFUSED_KERNEL_NAME: 0,
                 UNFUSED_BWD_KERNEL_NAME: 0}

# The JAX package runs its fused kernels only while their VMEM-resident
# [NSUB, 128] f32 table fits this budget (composite.py:1431-1442) and the
# unfused ones beyond it (N > ~1.47M, such as 3 context panoramas of
# 512x1024). The H100 has no such limit; the port keeps the threshold so that
# it runs the same kernels as the reference at each N.
FUSED_TABLE_BUDGET = 94 * 1024 * 1024


def nsub(n: int) -> int:
    """Rows of the JAX fused kernels' packed table: 8 Gaussians a row, rows
    8-aligned (`_nsub`)."""
    return -(-(-(-n // 8)) // 8) * 8


def fused_table_bytes(n: int) -> int:
    return nsub(n) * 128 * 4


def use_fused(n: int) -> bool:
    """Whether N Gaussians take the fused kernels (`_use_fused`)."""
    return fused_table_bytes(n) <= FUSED_TABLE_BUDGET


def build_attrs(mean2d, conic, colors, opacities, depths, radii) -> torch.Tensor:
    """Per-Gaussian attribute table [N, 16]."""
    z = torch.zeros_like(opacities)
    cols = [
        mean2d[:, 0], mean2d[:, 1], conic[:, 0], conic[:, 1], conic[:, 2],
        opacities, colors[:, 0], colors[:, 1], colors[:, 2], depths,
        radii[:, 0], radii[:, 1], z, z, z, z,
    ]
    return torch.stack(cols, dim=-1).to(torch.float32).contiguous()


def _check_segments(starts, counts, v, t):
    for name, x in (("starts", starts), ("counts", counts)):
        if x.dtype != torch.int32 or tuple(x.shape) != (v, t):
            raise ValueError(f"{name} must be [{v}, {t}] int32, got {tuple(x.shape)} {x.dtype}")


def _check_devices(*xs):
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check(attrs, gidx, starts, counts, nty, ntx):
    if attrs.dim() != 3 or attrs.shape[-1] != ROWS or attrs.dtype != torch.float32:
        raise ValueError(f"attrs must be [V, N, {ROWS}] float32, got {tuple(attrs.shape)} {attrs.dtype}")
    v = attrs.shape[0]
    if gidx.dtype != torch.int32 or gidx.dim() != 2 or gidx.shape[0] != v or gidx.shape[1] % CHUNK:
        raise ValueError(f"gidx must be [V, K] int32 with K % {CHUNK} == 0, got {tuple(gidx.shape)} {gidx.dtype}")
    _check_segments(starts, counts, v, nty * ntx)
    _check_devices(attrs, gidx, starts, counts)


def _check_inst(inst, starts, counts, nty, ntx):
    if inst.dim() != 4 or tuple(inst.shape[2:]) != (ROWS, CHUNK) or inst.dtype != torch.float32:
        raise ValueError(f"inst must be [V, NBLK, {ROWS}, {CHUNK}] float32, "
                         f"got {tuple(inst.shape)} {inst.dtype}")
    _check_segments(starts, counts, inst.shape[0], nty * ntx)
    _check_devices(inst, starts, counts)


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


def pack_instances(attrs, gidx, tile_ids, n_tiles: int) -> torch.Tensor:
    """The unfused path's instance blocks: attrs [V, N, 16] gathered through
    gidx [V, K] into inst [V, K/128, 16, 128], 128 instances a block with
    their rows on the middle axis; entries that are no instance (tile_ids >=
    n_tiles) are zero. The gather + transpose of `_render_core_fwd`, in
    PyTorch indexing (gidx is always in range, ops/tiling.py)."""
    v, k = gidx.shape
    rows = attrs[torch.arange(v, device=attrs.device)[:, None], gidx.long()]
    rows = rows.masked_fill((tile_ids >= n_tiles)[..., None], 0.0)
    return rows.reshape(v, k // CHUNK, CHUNK, ROWS).transpose(2, 3).contiguous()


def out_block_layout(starts, counts) -> torch.Tensor:
    """obase [V, T] int32: each tile's first block in the unfused backward's
    tile-owned output, the exclusive cumsum of its blocks
    (`_out_block_layout`); the output has K/128 + T blocks."""
    nblocks = (starts + counts + CHUNK - 1) // CHUNK - starts // CHUNK
    return (torch.cumsum(nblocks, dim=1) - nblocks).to(torch.int32)


def composite_forward_unfused(inst, starts, counts, nty: int, ntx: int,
                              w_img: float, wrap_x: bool) -> torch.Tensor:
    """Composite every (view, tile) from the instance blocks inst
    [V, K/128, 16, 128]; returns the planes [V, T, 8, 2048], equal to
    composite_forward's on the instances pack_instances gives."""
    _check_inst(inst, starts, counts, nty, ntx)
    if not inst.is_cuda:
        return composite_forward_unfused_plain(inst, starts, counts, nty, ntx, w_img, wrap_x)
    from .build import load

    fn = load("composite_fwd_unfused").composite_fwd_unfused
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    inst, starts, counts = inst.contiguous(), starts.contiguous(), counts.contiguous()
    v, nblk = inst.shape[:2]
    t = nty * ntx
    out = torch.empty((v, t, 8, N_PIX), dtype=torch.float32, device=inst.device)
    region_exits = torch.empty((v, t, N_REGIONS), dtype=torch.int32, device=inst.device)
    stream = torch.cuda.current_stream(inst.device).cuda_stream
    with torch.cuda.device(inst.device):
        err = fn(inst.data_ptr(), starts.data_ptr(), counts.data_ptr(), out.data_ptr(),
                 region_exits.data_ptr(), v, nblk, nty, ntx, float(w_img), int(bool(wrap_x)),
                 stream)
    if err != 0:
        raise RuntimeError(f"{UNFUSED_KERNEL_NAME} launch failed: cudaError {err}")
    launch_counts[UNFUSED_KERNEL_NAME] += 1
    return out


def composite_backward_unfused(inst, starts, counts, g_planes, lt_final, nproc,
                               nty: int, ntx: int, w_img: float, wrap_x: bool) -> torch.Tensor:
    """The unfused backward: tile-owned gradient blocks dout
    [V, K/128 + T, 16, 128], where tile t's walked block j (j < nproc[t])
    is out-block obase[t] + j (out_block_layout), holding rows 0-9 of its
    instances' gradients (zero outside the tile's segment and in blocks that
    fail the tile-wide gate) and zero rows 10-15. Other out-blocks are not
    written: read them only through scatter_out_blocks, which masks them."""
    _check_inst(inst, starts, counts, nty, ntx)
    _check_backward(starts, g_planes, lt_final, nproc)
    if not inst.is_cuda:
        return composite_backward_unfused_plain(inst, starts, counts, g_planes, lt_final, nproc,
                                                nty, ntx, w_img, wrap_x)
    from .build import load

    fn = load("composite_bwd_unfused").composite_bwd_unfused
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    inst, starts, counts = inst.contiguous(), starts.contiguous(), counts.contiguous()
    g_planes, lt_final, nproc = g_planes.contiguous(), lt_final.contiguous(), nproc.contiguous()
    v, nblk = inst.shape[:2]
    obase = out_block_layout(starts, counts)
    dout = torch.empty((v, nblk + nty * ntx, ROWS, CHUNK), dtype=torch.float32, device=inst.device)
    stream = torch.cuda.current_stream(inst.device).cuda_stream
    with torch.cuda.device(inst.device):
        err = fn(inst.data_ptr(), starts.data_ptr(), counts.data_ptr(), g_planes.data_ptr(),
                 lt_final.data_ptr(), nproc.data_ptr(), obase.data_ptr(), dout.data_ptr(),
                 v, nblk, nty, ntx, float(w_img), int(bool(wrap_x)), stream)
    if err != 0:
        raise RuntimeError(f"{UNFUSED_BWD_KERNEL_NAME} launch failed: cudaError {err}")
    launch_counts[UNFUSED_BWD_KERNEL_NAME] += 1
    return dout


def out_block_map(starts, counts, nproc, nblk_out: int):
    """Out-block -> (in-block, live), each [V, nblk_out] (`_out_block_map`):
    out-block o belongs to the last tile whose obase <= o (out_block_layout)
    and is that tile's copy of its in-block blk0 + (o - obase); live where
    the forward processed that block (o - obase < nproc). Summing every
    tile's copy of an in-block is exact: each copy zeroes the lanes of other
    tiles."""
    v, t = starts.shape
    obase = out_block_layout(starts, counts)
    o = torch.arange(nblk_out, dtype=torch.int32, device=starts.device).expand(v, nblk_out)
    t_of_o = torch.searchsorted(obase.contiguous(), o.contiguous(), right=True) - 1
    t_safe = t_of_o.clamp(0, t - 1)
    jb = o - obase.gather(1, t_safe)
    inblk = (starts // CHUNK).gather(1, t_safe) + jb
    live = (t_of_o >= 0) & (jb >= 0) & (jb < nproc.gather(1, t_safe))
    return inblk, live


def scatter_out_blocks(dout, gidx, starts, counts, nproc, n: int) -> torch.Tensor:
    """g_attrs [V, N, 16]: the live out-blocks' lanes of dout (rows 0-9)
    added into per-Gaussian gradients through gidx, the all-blocks branch of
    `_render_core_bwd`. Blocks that are not live were never written and may
    hold anything, NaN included: they are masked with torch.where, never
    multiplied. On CUDA index_add_ adds with atomics, so the last bits vary
    from run to run."""
    v, nblk_out = dout.shape[:2]
    nblk = gidx.shape[1] // CHUNK
    inblk, live = out_block_map(starts, counts, nproc, nblk_out)
    rows = torch.where(live[..., None, None], dout[:, :, :N_GRAD], 0.0)  # [V, O, 10, 128]
    views = torch.arange(v, device=dout.device)[:, None]
    gsel = gidx.reshape(v, nblk, CHUNK)[views, inblk.clamp(0, nblk - 1)]  # [V, O, 128]
    flat = (views[..., None] * n + gsel).reshape(-1)
    g_flat = torch.zeros(v * n, ROWS, dtype=torch.float32, device=dout.device)
    g_flat[:, :N_GRAD].index_add_(0, flat, rows.transpose(2, 3).reshape(-1, N_GRAD))
    return g_flat.reshape(v, n, ROWS)


def _gathered(attrs, gidx):
    """Rows of instances g [L, 128] of views `view` [L, 1] from the table."""
    return lambda view, g: attrs[view, gidx[view, g].long()]


def _packed(inst):
    """Rows of instances g [L, 128] of views `view` [L, 1] from inst."""
    return lambda view, g: inst[view, g // CHUNK, :, g % CHUNK]


class _Walk:
    """What the plain versions share: per (view, tile) pair, its segment,
    pixel coordinates, and the rows + alpha of one of its blocks; `fetch`
    reads the rows (_gathered or _packed), `k` instances a view."""

    def __init__(self, fetch, k, starts, counts, nty, ntx, w_img, wrap_x):
        v = starts.shape[0]
        t = nty * ntx
        dev = starts.device
        self.fetch, self.k = fetch, k
        self.w_img, self.wrap_x = w_img, wrap_x
        self.v, self.t, self.vt = v, t, v * t
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
        """Block j (a [L] tensor) of the pairs `live`: (instance indices
        [L, 128], in-segment mask, rows [L, 128, 16] zeroed outside the
        segment, alpha / dx / dy [L, 2048, 128], gate)."""
        g = (self.blk0[live] + j)[:, None] * CHUNK + self.lanes[None, :]
        inseg = (g >= self.starts[live][:, None]) & (g < self.ends[live][:, None])
        g = g.clamp(max=self.k - 1)
        data = self.fetch(self.view_of[live][:, None], g)
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
        return g, inseg, data, alpha, dx, dy, gate


def composite_forward_plain(attrs, gidx, starts, counts, nty: int, ntx: int,
                            w_img: float, wrap_x: bool,
                            stats: dict | None = None) -> torch.Tensor:
    """The forward kernel's function in PyTorch ops, same outputs.

    Vectorised over (view, tile) pairs, it walks the block index with the
    same per-tile exit test, and inside a block walks the 128 lanes in order
    so that the prefix and colour sums round exactly as the kernel's do.
    `stats`, if given, receives the number of (pixel, instance) pairs that
    pass the gate under "pairs_alive"."""
    walk = _Walk(_gathered(attrs, gidx), gidx.shape[1], starts, counts, nty, ntx, w_img, wrap_x)
    return _forward_walk(walk, stats)


def composite_forward_unfused_plain(inst, starts, counts, nty: int, ntx: int,
                                    w_img: float, wrap_x: bool,
                                    stats: dict | None = None) -> torch.Tensor:
    """The unfused forward kernel's function in PyTorch ops: the walk of
    composite_forward_plain over rows read from inst. On the instances
    pack_instances gives, it equals composite_forward_plain exactly."""
    walk = _Walk(_packed(inst), inst.shape[1] * CHUNK, starts, counts, nty, ntx, w_img, wrap_x)
    return _forward_walk(walk, stats)


def _forward_walk(walk: _Walk, stats: dict | None) -> torch.Tensor:
    dev = walk.lanes.device
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
    return out.reshape(walk.v, walk.t, 8, N_PIX)


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
    walk = _Walk(_gathered(attrs, gidx), gidx.shape[1], starts, counts, nty, ntx, w_img, wrap_x)
    g_flat = torch.zeros(v * n, ROWS, dtype=torch.float32, device=attrs.device)

    def add(sel, j, g, grad):
        view = walk.view_of[sel][:, None]
        flat = (view * n + gidx[view, g].long()).reshape(-1)
        g_flat[:, :N_GRAD].index_add_(0, flat, grad.reshape(-1, N_GRAD))

    _backward_walk(walk, g_planes, lt_final, nproc, None, add, stats)
    return g_flat.reshape(v, n, ROWS)


def composite_backward_unfused_plain(inst, starts, counts, g_planes, lt_final, nproc,
                                     nty: int, ntx: int, w_img: float, wrap_x: bool,
                                     stats: dict | None = None) -> torch.Tensor:
    """The unfused backward kernel's function in PyTorch ops: the walk of
    composite_backward_plain over rows read from inst, each walked block's
    gradient rows written into its tile-owned out-block (zeros where the
    gate fails). The out-blocks the kernel never writes are NaN here, so a
    caller that reads one without masking fails on the CPU too."""
    v, nblk = inst.shape[:2]
    walk = _Walk(_packed(inst), nblk * CHUNK, starts, counts, nty, ntx, w_img, wrap_x)
    obase = out_block_layout(starts, counts).reshape(walk.vt).long()
    dout = torch.full((v, nblk + walk.t, ROWS, CHUNK), float("nan"), dtype=torch.float32,
                      device=inst.device)

    def zero(live, j):
        dout[walk.view_of[live], obase[live] + j] = 0.0

    def put(sel, j, g, grad):
        dout[walk.view_of[sel], obase[sel] + j, :N_GRAD] = grad.transpose(1, 2)

    _backward_walk(walk, g_planes, lt_final, nproc, zero, put, stats)
    return dout


def _backward_walk(walk: _Walk, g_planes, lt_final, nproc, on_walked, on_gated,
                   stats: dict | None) -> None:
    """The plain backward's walk: on_walked(pairs, j), if given, for every
    walked block; on_gated(pairs, j, instance indices [S, 128], grad
    [S, 128, 10] zero outside the segment) for those that pass the gate."""
    dev = walk.lanes.device
    vt = walk.vt
    nproc_f = nproc.reshape(vt).long()
    planes = g_planes.reshape(vt, 8, N_PIX)
    g_rgbd = planes[:, 0:4].transpose(1, 2)  # [vt, 2048, 4]
    lt = lt_final.reshape(vt, N_PIX)
    gt_term = planes[:, 4] * torch.exp(lt)
    suffix = torch.zeros(vt, N_PIX, dtype=torch.float32, device=dev)
    a_psi = torch.zeros(vt, N_PIX, dtype=torch.float32, device=dev)
    st = {"blocks_walked": 0, "blocks_gated": 0, "pairs_walked": 0, "pairs_gated": 0,
          "rows_written": 0}
    for rj in range(int(nproc_f.max().item()) if vt else 0):
        for live in (nproc_f > rj).nonzero().squeeze(1).split(_PLAIN_TILES_PER_STEP):
            j = nproc_f[live] - 1 - rj
            g, inseg, data, alpha, dx, dy, gate = walk.block(live, j)
            if on_walked is not None:
                on_walked(live, j)
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
            g, inseg, data = g[keep], inseg[keep], data[keep]
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
            on_gated(sel, j[keep], g, grad)
    if stats is not None:
        stats.update(st)


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


class _CompositeUnfused(torch.autograd.Function):
    """pack_instances + composite_forward_unfused with the unfused backward
    as its VJP (the contract of `_render_core`'s custom_vjp): the backward's
    tile-owned blocks are scattered into per-Gaussian gradients of attrs."""

    @staticmethod
    def forward(ctx, attrs, gidx, tile_ids, starts, counts, nty, ntx, w_img, wrap_x):
        inst = pack_instances(attrs, gidx, tile_ids, nty * ntx)
        planes = composite_forward_unfused(inst, starts, counts, nty, ntx, w_img, wrap_x)
        lt_final = planes[:, :, 5].clone()
        nproc = planes[:, :, 6, 0].to(torch.int32)
        ctx.save_for_backward(inst, gidx, starts, counts, lt_final, nproc)
        ctx.n = attrs.shape[1]
        ctx.args = (nty, ntx, w_img, wrap_x)
        return planes

    @staticmethod
    def backward(ctx, g_planes):
        inst, gidx, starts, counts, lt_final, nproc = ctx.saved_tensors
        dout = composite_backward_unfused(inst, starts, counts, g_planes.contiguous(), lt_final,
                                          nproc, *ctx.args)
        g_attrs = scatter_out_blocks(dout, gidx, starts, counts, nproc, ctx.n)
        return g_attrs, None, None, None, None, None, None, None, None


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
    Differentiable in attrs (rows 0-9). The fused kernels composite while
    use_fused(N), the unfused ones beyond, as composite_tiles_pallas does."""
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
    if use_fused(attrs.shape[1]):
        planes = _CompositeFused.apply(attrs, gidx, starts, counts, nty, ntx,
                                       float(image_shape[1]), wrap_x)
    else:
        tile_ids = torch.stack([a.tile_ids for a in assignments])
        planes = _CompositeUnfused.apply(attrs, gidx, tile_ids, starts, counts, nty, ntx,
                                         float(image_shape[1]), wrap_x)
    return compose_planes(planes, image_shape, nty, ntx, background)
