"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure ends in a non-zero exit and no result line):
  1. print the card's name and power limit; build every CUDA kernel (one
     nvcc per source, all at once);
  2. hold the forward compositor kernel against its plain PyTorch version at
     the flagship render shapes (512x1024 ERP, N = 2*512*1024 Gaussians), and
     (2b) the backward kernel against its plain version there, with a seeded
     cotangent;
  2c. hold the unfused forward kernel (the path past the fused kernels'
     table budget) against its plain version and against the fused kernel
     at the 3-view flagship shapes (N = 3*512*1024, one view), and (2d) the
     unfused backward kernel, with the block map and scatter, against its
     plain version and against the fused backward there;
  3. serve N_REQUESTS HM3D-width requests through the port's entry points
     (2 context panoramas -> encode -> N Gaussians -> 4 target ERP views with
     depth), counting kernel launches, and (3b) compare the GPU serving path
     with the CPU path on a small input;
  3c. take N_STEPS HM3D-width train steps (ERP supervision, LPIPS, depth L1,
     clip + Adam) through train.state's entry points, counting kernel calls
     and timing each stage; hold the backward kernel against its plain
     version on the last step's Gaussians (4 target views); (3d) compare a
     GPU train step with a CPU one on a small input;
  3e-3g. the same with 3 context panoramas, where N = 3*512*1024 takes the
     unfused kernels: serving (3e), train steps (3f), GPU vs CPU train step
     on a small input with both on the unfused path (3g);
  4. time each kernel and its plain version with CUDA events, the unfused
     path's pack and scatter apart, the fused kernels on the 3-view inputs,
     and the serving render stage by stage.
It prints one JSON line of per-kernel numbers, the nvidia-smi line, and as
its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

H, W = 512, 1024
N_CTX, N_TGT = 2, 4
# context panoramas of the unfused path: N = 3*H*W is past the fused budget
N_CTX3 = 3
N_REQUESTS = 3
N_STEPS = 3
# compositor tolerances: the bars the JAX package holds its two compositor
# backends to (tests/test_pallas_composite.py:47-49)
ATOL_RGB, ATOL_DEPTH = 1e-4, 5e-4
# H100 SXM data-sheet peaks (dense): FP32 outside the tensor cores, HBM3
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
# compositor operations these inputs need: a 6-op radius-box cull per
# (instance, tile) of a processed block, and the alpha/transmittance/
# accumulate chain (20 flops + 3 transcendentals) per (pixel, instance) pair
# that passes the gate; pairs outside an instance's box need no work
OPS_BOX_TEST, OPS_LIVE_PAIR = 6, 23
# backward, per (pixel, instance) pair that passes the gate, counted once:
# in a walked block that fails the tile-wide gate, the alpha chain (13 flops
# + exp), log1p and the add into the block's sum; in a block that passes it,
# also the transmittance, gamma, psi, g_alpha and the ten per-pixel gradient
# terms (59 ops). The kernel's second alpha chain is its design, not work
# the function needs.
OPS_BWD_SUM, OPS_BWD_GATED = 16, 59
# bytes of an instance the compositor must read: rows u v a b c o r g b depth
# rx ry of the 16-row layout (rows 12-15 are padding), and of its gradient
# the backward must write: rows 0-9
INST_READ_BYTES, GRAD_WRITE_BYTES = 12 * 4, 10 * 4
# the backward bar: 2e-3 of max|g| per row of g_attrs, the bar between the JAX
# package's two compositor backends (tests/test_pallas_composite.py:66-71)
GRAD_TOL = 2e-3
# and, per row, |g_kernel - g_plain|_2 / |g_plain|_2: a kernel right only on
# the few largest gradients fails it, float atomics (~2e-8 of max|g|) do not
L2_TOL = 1e-5

failures: list[str] = []


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
                return out
            except Exception:
                traceback.print_exc()
                failures.append(name)
                print(f"== {name}: FAILED", flush=True)
                return None
        return run
    return wrap


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bench_scene(seed: int, n: int, sh_degree: int = 4):
    """numpy-seeded copy of bench.py's scene: Gaussians around the origin,
    radius 0.5-8, scales 0.004-0.03, sym6 covariances."""
    from splatter360_tpu_torch.geometry.transforms import build_covariance_sym6

    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    means = dirs * rng.uniform(0.5, 8.0, (n, 1)).astype(np.float32)
    scales = rng.uniform(0.004, 0.03, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = (0.3 * rng.normal(size=(n, 3, (sh_degree + 1) ** 2))).astype(np.float32)
    sh[..., 0] += 0.5
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    dev = torch.device("cuda")
    t = {k: torch.as_tensor(v, device=dev) for k, v in
         dict(means=means, scales=scales, quats=quats, sh=sh, opac=opac).items()}
    covs = build_covariance_sym6(t["scales"], t["quats"])
    return t["means"], covs, t["sh"], t["opac"]


def render_inputs(means, covs, sh, opac, c2ws, near):
    """attrs [V, N, 16], gidx, starts, counts and the tiling of V ERP views,
    built as render_erp_batch builds them."""
    from splatter360_tpu_torch.ops.cuda.composite import build_attrs
    from splatter360_tpu_torch.ops.projection import project_erp, sh_colors
    from splatter360_tpu_torch.ops.tiling import assign_tiles

    attrs, asg = [], []
    for c2w in c2ws:
        proj = project_erp(means, covs, c2w, (H, W), near, opacities=opac)
        colors = sh_colors(sh, means, c2w[:3, 3], 4)
        asg.append(assign_tiles(proj, (H, W), wrap_x=True))
        attrs.append(build_attrs(proj.mean2d, proj.conic, colors, opac, proj.depth, proj.radius))
    return dict(
        attrs=torch.stack(attrs),
        gidx=torch.stack([a.gaussian_idx for a in asg]),
        tile_ids=torch.stack([a.tile_ids for a in asg]),
        starts=torch.stack([a.tile_starts for a in asg]),
        counts=torch.stack([a.tile_counts for a in asg]),
        nty=asg[0].num_tiles_y, ntx=asg[0].num_tiles_x,
        dropped=[int(a.dropped) for a in asg],
    )


def with_inst(inp):
    """inp with the unfused path's instance blocks (pack_instances)."""
    from splatter360_tpu_torch.ops.cuda.composite import pack_instances

    return dict(inp, inst=pack_instances(inp["attrs"], inp["gidx"], inp["tile_ids"],
                                         inp["nty"] * inp["ntx"]))


def fwd_calls(inp, unfused=False):
    """(kernel, plain) forward calls on inp: the fused ones on attrs + gidx,
    the unfused ones on inp["inst"]."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    seg = (inp["starts"], inp["counts"], inp["nty"], inp["ntx"], float(W), True)
    if unfused:
        return (lambda: comp.composite_forward_unfused(inp["inst"], *seg),
                lambda **kw: comp.composite_forward_unfused_plain(inp["inst"], *seg, **kw))
    return (lambda: comp.composite_forward(inp["attrs"], inp["gidx"], *seg),
            lambda **kw: comp.composite_forward_plain(inp["attrs"], inp["gidx"], *seg, **kw))


def compare_kernel_plain(inp, label, unfused=False):
    """Kernel vs plain planes on the same inputs; returns (max_abs_err,
    stats), stats holding the plain version's work counts and its ms."""
    from splatter360_tpu_torch.ops.cuda.composite import compose_planes

    kernel, plain = fwd_calls(inp, unfused)
    pk = kernel()
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp = plain(stats=stats)
    torch.cuda.synchronize()
    stats["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    bg = torch.zeros(3, device="cuda")
    rk, ak, dk = compose_planes(pk, (H, W), inp["nty"], inp["ntx"], bg)
    rp, ap, dp = compose_planes(pp, (H, W), inp["nty"], inp["ntx"], bg)
    err_rgb = float((rk - rp).abs().max())
    err_a = float((ak - ap).abs().max())
    err_d = float((dk - dp).abs().max())
    nk, npl = pk[:, :, 6, 0], pp[:, :, 6, 0]
    diff = (nk != npl).nonzero().tolist()
    per_tile = nk.flatten().sort(descending=True).values
    top = per_tile[: max(1, per_tile.numel() // 100)]
    print(f"[{label}] views={pk.shape[0]} max|rgb| err={err_rgb:.3e} alpha err={err_a:.3e} "
          f"depth err={err_d:.3e}; tiles with differing n_processed: {diff[:20]} "
          f"({len(diff)} total); blocks processed {int(nk.sum())} of "
          f"{int(((inp['starts'] + inp['counts'] + 127) // 128 - inp['starts'] // 128).sum())}; "
          f"per tile: max {int(per_tile[0])}, median {int(per_tile.median())}, "
          f"top 1% of tiles hold {float(top.sum() / per_tile.sum().clamp(min=1)):.1%}")
    ok = (err_rgb <= ATOL_RGB and err_a <= ATOL_RGB and err_d <= ATOL_DEPTH and not diff
          and bool(torch.isfinite(pk).all()))
    if not ok:
        raise AssertionError(f"[{label}] kernel disagrees with the plain version")
    stats["blocks_processed"] = int(nk.sum())
    return max(err_rgb, err_a, err_d), stats


def bound_ms(inp, stats, unfused=False):
    """Least time for the compositor on these inputs: the larger of
    operations over FP32 peak and bytes over HBM peak. Returns
    (bound ms, what sets it, ms of operations, ms of bytes)."""
    blocks = stats["blocks_processed"]
    ops = blocks * 128 * OPS_BOX_TEST + stats["pairs_alive"] * OPS_LIVE_PAIR
    v, t = inp["starts"].shape
    row_bytes = INST_READ_BYTES + (0 if unfused else 4)  # + gidx when gathered
    nbytes = (blocks * 128 * row_bytes
              + v * t * 8 * 2048 * 4          # output planes
              + 2 * v * t * 4)                # starts, counts
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def bwd_args(inp, seed):
    """The backward's inputs for `inp`: the kernel's forward planes (equal to
    the plain version's) and a seeded normal cotangent on planes 0-4."""
    from splatter360_tpu_torch.ops.cuda.composite import composite_forward

    planes = composite_forward(inp["attrs"], inp["gidx"], inp["starts"], inp["counts"],
                               inp["nty"], inp["ntx"], float(W), True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_planes = torch.zeros_like(planes)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen, device="cuda")
    return (inp["attrs"], inp["gidx"], inp["starts"], inp["counts"], g_planes,
            planes[:, :, 5].contiguous(), planes[:, :, 6, 0].to(torch.int32),
            inp["nty"], inp["ntx"], float(W), True)


def compare_bwd_plain(inp, label, seed):
    """Backward kernel (twice) vs plain on the same inputs: per-row error
    relative to the row's max|g| against GRAD_TOL, the largest absolute
    error, the largest difference between the two kernel runs (atomics),
    the plain version's ms and its work counts."""
    from splatter360_tpu_torch.ops.cuda.composite import (
        N_GRAD, composite_backward, composite_backward_plain)

    args = bwd_args(inp, seed)
    gk = composite_backward(*args)
    gk2 = composite_backward(*args)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = composite_backward_plain(*args, stats=stats)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    rel, l2 = row_errors(gk, gp)
    rows_p = gp[..., :N_GRAD].reshape(-1, N_GRAD)
    scale = rows_p.abs().amax(dim=0)
    touched = rows_p != 0
    median = [float(rows_p[touched[:, i], i].abs().median()) if bool(touched[:, i].any()) else 0.0
              for i in range(N_GRAD)]
    err = float((gk - gp).abs().max())
    repeat = float((gk - gk2).abs().max())
    repeat_rel, _ = row_errors(gk2, gk)
    print(f"[{label}] backward: views={gk.shape[0]}, per row (u v a b c o r g b depth): "
          f"max|kernel-plain|/max|plain| {[f'{x:.2e}' for x in rel]} (bar {GRAD_TOL:g}); "
          f"|kernel-plain|_2/|plain|_2 {[f'{x:.2e}' for x in l2]} (bar {L2_TOL:g}); "
          f"max|plain| {[f'{x:.3e}' for x in scale.tolist()]}; median |plain| over the "
          f"instances it touches {[f'{x:.3e}' for x in median]}; max abs err {err:.3e}; two "
          f"kernel runs differ by {repeat:.3e}, per row /max|g| "
          f"{[f'{x:.2e}' for x in repeat_rel]}; plain {plain_ms:.1f} ms; {stats}")
    ok = (max(rel) <= GRAD_TOL and max(l2) <= L2_TOL and bool(torch.isfinite(gk).all())
          and not bool(gk[..., N_GRAD:].any()))
    if not ok:
        raise AssertionError(f"[{label}] backward kernel disagrees with the plain version")
    return dict(args=args, err=err, rel=max(rel), l2=max(l2), repeat=repeat, plain_ms=plain_ms,
                stats=stats)


def bwd_bound_ms(inp, st, unfused=False):
    """Least time for the backward on these inputs (see bound_ms): one box
    cull per instance and tile of the walked blocks, OPS_BWD_SUM per gated
    pair of a walked block that fails the tile-wide gate and OPS_BWD_GATED
    per gated pair of one that passes it; bytes: the cotangent planes 0-4
    and logT, the segments, and either (fused) the gathered rows and gidx of
    the walked blocks and one gradient write per (instance, tile) of a gated
    block, or (unfused) the instance rows read and the gradient rows written
    per walked block, and obase."""
    ops = (st["blocks_walked"] * 128 * OPS_BOX_TEST
           + (st["pairs_walked"] - st["pairs_gated"]) * OPS_BWD_SUM
           + st["pairs_gated"] * OPS_BWD_GATED)
    v, t = inp["starts"].shape
    nbytes = v * t * 6 * 2048 * 4 + 3 * v * t * 4
    if unfused:
        nbytes += st["blocks_walked"] * 128 * (INST_READ_BYTES + GRAD_WRITE_BYTES) + v * t * 4
    else:
        nbytes += (st["blocks_walked"] * 128 * (INST_READ_BYTES + 4)
                   + st["rows_written"] * GRAD_WRITE_BYTES)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


def unfused_bwd_args(inp, seed):
    """The unfused backward's inputs for with_inst(inp): the unfused
    kernel's forward planes (equal to the plain version's) and a seeded
    normal cotangent on planes 0-4."""
    from splatter360_tpu_torch.ops.cuda.composite import composite_forward_unfused

    seg = (inp["starts"], inp["counts"])
    planes = composite_forward_unfused(inp["inst"], *seg, inp["nty"], inp["ntx"], float(W), True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_planes = torch.zeros_like(planes)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen, device="cuda")
    return (inp["inst"], *seg, g_planes, planes[:, :, 5].contiguous(),
            planes[:, :, 6, 0].to(torch.int32), inp["nty"], inp["ntx"], float(W), True)


def row_errors(got, ref):
    """Per row of g_attrs (u v a b c o r g b depth): max|got-ref|/max|ref|
    and |got-ref|_2/|ref|_2."""
    from splatter360_tpu_torch.ops.cuda.composite import N_GRAD

    rows_g, rows_r = got[..., :N_GRAD].reshape(-1, N_GRAD), ref[..., :N_GRAD].reshape(-1, N_GRAD)
    rel = ((rows_g - rows_r).abs().amax(dim=0) / rows_r.abs().amax(dim=0).clamp(min=1e-30)).tolist()
    l2 = ((rows_g - rows_r).norm(dim=0) / rows_r.norm(dim=0).clamp(min=1e-30)).tolist()
    return rel, l2


def compare_unfused_bwd_plain(inp, label, seed):
    """The unfused backward (kernel, block map, scatter; twice) against its
    plain version through the same map and scatter, and against the fused
    backward kernel on the same inputs: per row against GRAD_TOL and L2_TOL.
    Returns the largest absolute error, the repeat differences of the
    kernel's blocks and of the scattered gradients, the plain version's ms
    and its work counts."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    args = unfused_bwd_args(inp, seed)
    inst, starts, counts, g_planes, lt, nproc = args[:6]
    n = inp["attrs"].shape[1]

    def scatter(dout):
        return comp.scatter_out_blocks(dout, inp["gidx"], starts, counts, nproc, n)

    dk, dk2 = comp.composite_backward_unfused(*args), comp.composite_backward_unfused(*args)
    gk, gk2 = scatter(dk), scatter(dk2)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp = comp.composite_backward_unfused_plain(*args, stats=stats)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    gp = scatter(dp)
    gf = comp.composite_backward(inp["attrs"], inp["gidx"], starts, counts, *args[3:])
    _, live = comp.out_block_map(starts, counts, nproc, dk.shape[1])
    blocks_repeat = float((dk[live] - dk2[live]).abs().max())
    repeat = float((gk - gk2).abs().max())
    repeat_rel, _ = row_errors(gk2, gk)
    rel, l2 = row_errors(gk, gp)
    rel_f, l2_f = row_errors(gk, gf)
    err = float((gk - gp).abs().max())
    scale = gp[..., :comp.N_GRAD].reshape(-1, comp.N_GRAD).abs().amax(dim=0)
    print(f"[{label}] unfused backward: views={gk.shape[0]}, per row (u v a b c o r g b depth) "
          f"against the plain version: max|kernel-plain|/max|plain| {[f'{x:.2e}' for x in rel]} "
          f"(bar {GRAD_TOL:g}), L2 {[f'{x:.2e}' for x in l2]} (bar {L2_TOL:g}); against the fused "
          f"backward kernel: {[f'{x:.2e}' for x in rel_f]}, L2 {[f'{x:.2e}' for x in l2_f]}; "
          f"max|plain| {[f'{x:.3e}' for x in scale.tolist()]}; max abs err {err:.3e}; two runs: "
          f"live out-blocks differ by {blocks_repeat:.3e}, scattered gradients by {repeat:.3e}, "
          f"per row /max|g| {[f'{x:.2e}' for x in repeat_rel]}; live out-blocks "
          f"{int(live.sum())} of {live.numel()}; plain {plain_ms:.1f} ms; {stats}")
    ok = (max(rel + rel_f) <= GRAD_TOL and max(l2 + l2_f) <= L2_TOL
          and bool(torch.isfinite(gk).all()) and not bool(gk[..., comp.N_GRAD:].any())
          and blocks_repeat == 0.0)
    if not ok:
        raise AssertionError(f"[{label}] unfused backward disagrees with the plain version, "
                             f"the fused backward, or itself")
    return dict(args=args, err=err, rel=max(rel), l2=max(l2), repeat=repeat,
                blocks_repeat=blocks_repeat, plain_ms=plain_ms, stats=stats)


def time_cuda(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@phase("1. build kernels")
def phase_build():
    from splatter360_tpu_torch.ops.cuda.build import build_all

    t0 = time.perf_counter()
    logs = build_all()
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log.strip()}")
    print(f"built in {time.perf_counter() - t0:.1f} s")


@phase("2. compositor kernel vs plain at flagship shapes")
def phase_kernel_check(seed):
    means, covs, sh, opac = bench_scene(seed, N_CTX * H * W)
    inp = render_inputs(means, covs, sh, opac, [torch.eye(4, device="cuda")], 0.1)
    print(f"N={means.shape[0]} K={inp['gidx'].shape[1]} dropped={inp['dropped']}")
    err, stats = compare_kernel_plain(inp, "bench scene, 1 view")
    return dict(inp=inp, err=err, stats=stats)


@phase("2b. backward kernel vs plain at flagship shapes")
def phase_bwd_check(check, seed):
    return dict(inp=check["inp"], **compare_bwd_plain(check["inp"], "bench scene, 1 view", seed + 2))


@phase("2c. unfused forward kernel vs plain and vs the fused kernel, 3-view flagship shapes")
def phase_unfused_check(seed):
    from splatter360_tpu_torch.ops.cuda.composite import use_fused

    means, covs, sh, opac = bench_scene(seed, N_CTX3 * H * W)
    if use_fused(means.shape[0]):
        raise AssertionError(f"N={means.shape[0]} should be past the fused budget")
    inp = with_inst(render_inputs(means, covs, sh, opac, [torch.eye(4, device="cuda")], 0.1))
    print(f"N={means.shape[0]} K={inp['gidx'].shape[1]} dropped={inp['dropped']}")
    err, stats = compare_kernel_plain(inp, "3-view bench scene, 1 view, unfused", unfused=True)
    fused_vs_unfused = max_fused_difference(inp, "3-view bench scene, 1 view")
    return dict(inp=inp, err=err, stats=stats, fused_vs_unfused=fused_vs_unfused)


def max_fused_difference(inp, label):
    """The unfused forward kernel against the fused one on the same
    instances: both walk each pixel's instances in order with -fmad=false,
    so they must agree bit for bit."""
    unfused = fwd_calls(inp, unfused=True)[0]()
    fused = fwd_calls(inp)[0]()
    diff = float((unfused - fused).abs().max())
    print(f"[{label}] unfused vs fused forward kernel: max difference {diff:.3e}, "
          f"bit-equal {torch.equal(unfused, fused)}")
    if not torch.equal(unfused, fused):
        raise AssertionError(f"[{label}] the unfused and fused forward kernels differ")
    return diff


@phase("2d. unfused backward (kernel, map, scatter) vs plain and vs the fused backward")
def phase_unfused_bwd_check(check, seed):
    return dict(inp=check["inp"], **compare_unfused_bwd_plain(
        check["inp"], "3-view bench scene, 1 view", seed + 2))


def request_data(gen, near=0.1, far=10.0, n_ctx=N_CTX):
    """One request: n_ctx seeded panoramas with poses, N_TGT target poses."""
    dev = torch.device("cuda")
    img = torch.rand((1, n_ctx, H // 8, W // 8, 3), generator=gen, device=dev)
    img = torch.nn.functional.interpolate(
        img[0].permute(0, 3, 1, 2), size=(H, W), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)[None].contiguous()

    def poses(n, spread):
        p = torch.eye(4, device=dev).repeat(1, n, 1, 1)
        p[..., :3, 3] = spread * torch.randn((1, n, 3), generator=gen, device=dev)
        return p

    return dict(
        image=img, ctx_pose=poses(n_ctx, 0.3), tgt_pose=poses(N_TGT, 0.2),
        near=torch.full((1, n_ctx), near, device=dev), far=torch.full((1, n_ctx), far, device=dev),
        tgt_near=torch.full((1, N_TGT), near, device=dev), tgt_far=torch.full((1, N_TGT), far, device=dev),
    )


def path_kernels(n):
    """The forward and backward kernel names N Gaussians take."""
    from splatter360_tpu_torch.ops.cuda import composite as comp

    if comp.use_fused(n):
        return comp.KERNEL_NAME, comp.BWD_KERNEL_NAME
    return comp.UNFUSED_KERNEL_NAME, comp.UNFUSED_BWD_KERNEL_NAME


def serve_requests(seed, n_ctx):
    """N_REQUESTS requests of n_ctx context panoramas through the serving
    entry points; each must launch exactly one forward kernel, of the path
    its N takes. Returns the launch counts over the run and the last
    request's Gaussians and target poses."""
    from splatter360_tpu_torch.models.encoder import HM3D
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.serve import build_model, encode, render_erp_views

    fwd_name, _ = path_kernels(n_ctx * H * W)
    model = build_model(HM3D, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    reqs = [request_data(gen, n_ctx=n_ctx) for _ in range(N_REQUESTS)]
    torch.cuda.synchronize()

    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    gaussians = out = None
    times = []
    for i, r in enumerate(reqs):
        before = dict(comp.launch_counts)
        t0 = time.perf_counter()
        gaussians, depth_map = encode(model, r["image"], r["ctx_pose"], r["near"], r["far"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = render_erp_views(gaussians, r["tgt_pose"], r["tgt_near"], r["tgt_far"],
                               (H, W), render_depth=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        delta = {k: comp.launch_counts[k] - before[k] for k in before}
        n = gaussians.means.shape[1]
        times.append((1e3 * (t1 - t0), 1e3 * (t2 - t1)))
        print(f"request {i}: {n_ctx} context panoramas, encoder {times[-1][0]:.1f} ms, render "
              f"{N_TGT} views {times[-1][1]:.1f} ms, N={n}, dropped={out.dropped.tolist()}, "
              f"kernel launches {delta}")
        if n != n_ctx * H * W:
            raise AssertionError(f"expected {n_ctx * H * W} Gaussians, got {n}")
        if delta != {k: int(k == fwd_name) for k in delta}:
            raise AssertionError(f"expected 1 {fwd_name} launch for {N_TGT} views, got {delta}")
        check_outputs(gaussians, depth_map, out, r)
    launches = dict(comp.launch_counts)
    print(f"launch counts over the serving run: {launches}")
    return dict(launches=launches, gaussians=gaussians, tgt_pose=reqs[-1]["tgt_pose"][0],
                times=times)


def target_inputs(gaussians, tgt_pose):
    """render_inputs of one item's Gaussians into its target views."""
    return render_inputs(gaussians.means[0], gaussians.covariances[0], gaussians.harmonics[0],
                         gaussians.opacities[0], list(tgt_pose), 0.1)


@phase("3. serve HM3D-width requests")
def phase_serve(seed):
    res = serve_requests(seed, N_CTX)
    # the encoder's own Gaussians through the kernel and the plain version
    inp = target_inputs(res["gaussians"], res["tgt_pose"])
    one = {k: (v[:1] if torch.is_tensor(v) and v.dim() > 1 else v) for k, v in inp.items()}
    err1, _ = compare_kernel_plain(one, "encoder Gaussians, view 0")
    err4, stats = compare_kernel_plain(inp, f"encoder Gaussians, {N_TGT} views")
    return dict(res, inp=inp, err=max(err1, err4), stats=stats)


@phase("3e. serve HM3D-width requests with 3 context panoramas (unfused path)")
def phase_serve3(seed):
    res = serve_requests(seed, N_CTX3)
    inp = with_inst(target_inputs(res["gaussians"], res["tgt_pose"]))
    err, stats = compare_kernel_plain(inp, f"3-view encoder Gaussians, {N_TGT} views, unfused",
                                      unfused=True)
    return dict(res, inp=inp, err=err, stats=stats)


def render_breakdown(gaussians, c2ws, iters=3):
    """The render of N_TGT views stage by stage, as render_erp_batch runs it:
    median ms per stage over `iters` runs (CUDA events)."""
    from splatter360_tpu_torch.ops.cuda.composite import build_attrs, composite_tiles
    from splatter360_tpu_torch.ops.projection import project_erp, sh_colors
    from splatter360_tpu_torch.ops.tiling import assign_tiles

    means, covs, sh, opac = (x[0] for x in gaussians)
    bg = torch.zeros(3, device="cuda")
    stages = ("projection + SH colours", "binning (assign_tiles)", "attribute table",
              "compositor (kernel + compose)")
    times = {s: [] for s in stages}
    for _ in range(iters + 1):  # the first run warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        ev[0].record()
        projs = [project_erp(means, covs, c2w, (H, W), 0.1, opacities=opac) for c2w in c2ws]
        colors = [sh_colors(sh, means, c2w[:3, 3], 4) for c2w in c2ws]
        ev[1].record()
        asg = [assign_tiles(p, (H, W), wrap_x=True) for p in projs]
        ev[2].record()
        attrs = torch.stack([build_attrs(p.mean2d, p.conic, c, opac, p.depth, p.radius)
                             for p, c in zip(projs, colors)])
        ev[3].record()
        composite_tiles(asg, attrs, (H, W), bg, wrap_x=True)
        ev[4].record()
        torch.cuda.synchronize()
        for i, s in enumerate(stages):
            times[s].append(ev[i].elapsed_time(ev[i + 1]))
    return {s: float(np.median(t[1:])) for s, t in times.items()}


def check_outputs(gaussians, depth_map, out, r):
    near, far = float(r["near"].min()), float(r["far"].max())
    for name, x in (("means", gaussians.means), ("covariances", gaussians.covariances),
                    ("harmonics", gaussians.harmonics), ("opacities", gaussians.opacities),
                    ("depth_map", depth_map), ("color", out.color), ("alpha", out.alpha),
                    ("depth", out.depth)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name}")
    assert tuple(out.color.shape) == (1, N_TGT, H, W, 3), out.color.shape
    assert tuple(depth_map.shape) == (1, r["image"].shape[1], H, W), depth_map.shape
    assert float(depth_map.min()) >= near - 1e-5 and float(depth_map.max()) <= far + 1e-4
    assert float(out.alpha.min()) >= -1e-6 and float(out.alpha.max()) <= 1.0 + 1e-6


@phase("3b. GPU serving path vs CPU serving path, small input")
def phase_small_reference(seed):
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.serve import build_model, encode, render_erp_views

    cfg = EncoderConfig(
        d_feature=32, num_depth_candidates=16, costvolume_unet_feat_dim=32,
        costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
        depth_unet_feat_dim=8, depth_unet_attn_res=(8,), depth_unet_channel_mult=(1, 1, 1, 1),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1),
    )
    rng = np.random.default_rng(seed)
    h, w = 64, 256
    img = rng.uniform(0, 1, (1, 2, h, w, 3)).astype(np.float32)
    pose = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    pose[..., :3, 3] = rng.normal(0, 0.2, (1, 2, 3))
    tgt = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    tgt[..., :3, 3] = rng.normal(0, 0.1, (1, 2, 3))
    nf = (np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32))
    enc, views = {}, {}
    for dev in ("cpu", "cuda"):
        t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        model = build_model(cfg, seed=seed, device=dev)
        enc[dev] = encode(model, t(img), t(pose), t(nf[0]), t(nf[1]), device=dev)
        views[dev] = render_erp_views(enc[dev][0], t(tgt), t(nf[0]), t(nf[1]), (h, w),
                                      render_depth=True, device=dev)
    # the CPU Gaussians rendered on the card: the renderer alone, on equal inputs
    views["cuda_from_cpu"] = render_erp_views(enc["cpu"][0], tgt, nf[0], nf[1], (h, w),
                                              render_depth=True, device="cuda")

    # encoder: float32 on both sides with TF32 off; cuDNN's convolution
    # algorithms sum in another order than the CPU's, ~1e-4 of max|x| after
    # the deep random network (the port meets 1e-4 against JAX on the CPU)
    (g_cpu, d_cpu), (g_gpu, d_gpu) = enc["cpu"], enc["cuda"]
    for name, a, b in zip(("means", "covariances", "harmonics", "opacities", "depth_map"),
                          (*g_cpu, d_cpu), (*g_gpu, d_gpu)):
        rel = float((a - b.cpu()).abs().max()) / (float(a.abs().max()) + 1e-12)
        print(f"  encoder {name}: max|cpu-gpu|/max|cpu| = {rel:.2e}")
        if rel > 1e-3:
            raise AssertionError(f"encoder {name}: GPU differs from the CPU path ({rel:.2e})")

    # renderer on the same Gaussians: the compositor bars, except where the
    # weight gate T (1 - alpha) >= 1e-4 flips on a last-bit difference of the
    # card's atan2/exp in the projection (one weight of at most ~1e-2)
    ref, got = views["cpu"], views["cuda_from_cpu"]
    for name, atol in (("color", ATOL_RGB), ("alpha", ATOL_RGB), ("depth", ATOL_DEPTH)):
        a, b = getattr(ref, name), getattr(got, name).cpu()
        diff = (a - b).abs()
        share = float((diff > atol).float().mean())
        scale = float(a.abs().max())
        print(f"  render {name}: max|cpu-gpu| = {float(diff.max()):.2e}, share over {atol:g} = {share:.2e}")
        if share > 1e-3 or float(diff.max()) > 1e-2 * max(scale, 1.0):
            raise AssertionError(f"render {name}: GPU renderer differs from the CPU path")

    # the whole chain: ~1e-4 differences in the Gaussians move a few radius
    # and binning decisions, so the images are held by their mean error
    for name in ("color", "alpha", "depth"):
        a, b = getattr(views["cpu"], name), getattr(views["cuda"], name).cpu()
        mean = float((a - b).abs().mean()) / (float(a.abs().max()) + 1e-12)
        print(f"  chain {name}: mean|cpu-gpu|/max|cpu| = {mean:.2e}")
        if mean > 1e-3:
            raise AssertionError(f"chain {name}: GPU serving path differs from the CPU path")


def train_batch(gen, near=0.1, far=10.0, n_ctx=N_CTX):
    """One train batch: request_data's context panoramas and poses, target
    panoramas made the same way, and context depth in [0.5, 5] with ~8%
    holes (0), all seeded."""
    r = request_data(gen, near, far, n_ctx)
    tgt = torch.rand((N_TGT, H // 8, W // 8, 3), generator=gen, device="cuda")
    tgt = torch.nn.functional.interpolate(tgt.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1)[None]
    depth = 0.5 + 4.5 * torch.rand((1, n_ctx, H, W), generator=gen, device="cuda")
    holes = torch.rand((1, n_ctx, H // 16, W // 16), generator=gen, device="cuda") < 0.08
    holes = holes.repeat_interleave(16, dim=2).repeat_interleave(16, dim=3)
    return dict(
        context=dict(image_sphere=r["image"], extrinsics_sphere=r["ctx_pose"],
                     depth_sphere=torch.where(holes, torch.zeros_like(depth), depth),
                     near=r["near"], far=r["far"]),
        target=dict(image_sphere=tgt.contiguous(), extrinsics_sphere=r["tgt_pose"],
                    near=r["tgt_near"], far=r["tgt_far"]),
    )


STAGES = ("encoder", "render", "losses", "backward", "optimizer")


def train_steps(seed, n_ctx):
    """N_STEPS HM3D-width train steps with n_ctx context panoramas: per-step
    metrics, CUDA-event stage times (and the backward kernel's, and on the
    unfused path the scatter's, inside the backward), kernel calls (exactly
    one forward and one backward of the path N takes) and peak memory; then
    the backward kernel against its plain version on the last step's
    Gaussians rendered into its N_TGT target views."""
    from splatter360_tpu_torch.models.encoder import HM3D
    from splatter360_tpu_torch.models.types import Gaussians
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.serve import context_cubes
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step

    fwd_name, bwd_name = path_kernels(n_ctx * H * W)
    unfused = fwd_name == comp.UNFUSED_KERNEL_NAME
    state = create_train_state(HM3D, TrainConfig(), seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    batches = [train_batch(gen, n_ctx=n_ctx) for _ in range(N_STEPS)]
    torch.cuda.synchronize()

    # CUDA events around the backward kernel's calls (and the scatter's)
    # inside each step
    kernel_events = {"backward kernel": [], "scatter": []}
    timed = {"backward kernel": "composite_backward_unfused" if unfused else "composite_backward"}
    if unfused:
        timed["scatter"] = "scatter_out_blocks"
    originals = {label: getattr(comp, name) for label, name in timed.items()}

    def timing(label, fn):
        def run(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            kernel_events[label].append(ev)
            return out
        return run

    for label, name in timed.items():
        setattr(comp, name, timing(label, originals[label]))
    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    steps = []
    try:
        for i, batch in enumerate(batches):
            before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            calls = dict(comp.launch_counts)
            for evs in kernel_events.values():
                evs.clear()
            torch.cuda.reset_peak_memory_stats()
            events = {"start": torch.cuda.Event(enable_timing=True)}

            def mark(stage):
                events[stage] = torch.cuda.Event(enable_timing=True)
                events[stage].record()

            t0 = time.perf_counter()
            events["start"].record()
            metrics = train_step(state, batch, on_stage=mark)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            ms, prev = {}, "start"
            for stage in STAGES:
                ms[stage] = events[prev].elapsed_time(events[stage])
                prev = stage
            for label in timed:
                ms[label] = sum(a.elapsed_time(b) for a, b in kernel_events[label])
            delta = {k: comp.launch_counts[k] - calls[k] for k in calls}
            vals = {k: float(v) for k, v in metrics.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"step {i} ({n_ctx} context panoramas): "
                  + ", ".join(f"{k} {v:.6g}" for k, v in sorted(vals.items()))
                  + f"; {wall:.1f} ms: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                  + f"; kernel calls {delta}; peak memory {peak:.2f} GiB", flush=True)
            if not all(math.isfinite(v) for v in vals.values()):
                raise AssertionError(f"step {i}: non-finite metrics {vals}")
            if delta != {k: int(k in (fwd_name, bwd_name)) for k in delta}:
                raise AssertionError(f"step {i}: expected 1 {fwd_name} and 1 {bwd_name} call, "
                                     f"got {delta}")
            still = [n for n, p in state.model.named_parameters() if torch.equal(p, before[n])]
            if still:
                raise AssertionError(f"step {i}: parameters unchanged: {still[:10]}")
            if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
                raise AssertionError(f"step {i}: non-finite parameters")
            steps.append(dict(wall=wall, ms=ms, peak_gib=peak, **vals))
    finally:
        for label, name in timed.items():
            setattr(comp, name, originals[label])
    launches = dict(comp.launch_counts)
    print(f"launch counts over the training run: {launches}")

    # the last step's Gaussians, rendered into its target views: backward
    # kernel vs plain at the training shapes
    ctx, tgt = batches[-1]["context"], batches[-1]["target"]
    with torch.no_grad():
        g, _ = state.model(ctx["image_sphere"], context_cubes(ctx["image_sphere"], H // 2),
                           ctx["extrinsics_sphere"], ctx["near"], ctx["far"], state.step)
    del state
    g = Gaussians(*(x[0] for x in g))
    inp = render_inputs(g.means, g.covariances, g.harmonics, g.opacities,
                        list(tgt["extrinsics_sphere"][0]), 0.1)
    label = f"train-step Gaussians ({n_ctx} context panoramas), {N_TGT} views"
    if unfused:
        inp = with_inst(inp)
        res = compare_unfused_bwd_plain(inp, label, seed + 4)
    else:
        res = compare_bwd_plain(inp, label, seed + 4)
    return dict(steps=steps, launches=launches, inp=inp, **res)


@phase("3c. HM3D-width train steps")
def phase_train(seed):
    return train_steps(seed, N_CTX)


@phase("3f. HM3D-width train steps with 3 context panoramas (unfused path)")
def phase_train3(seed):
    torch.cuda.empty_cache()
    return train_steps(seed, N_CTX3)


def small_train(seed, n_ctx):
    """A GPU and a CPU train step at 64x256 with n_ctx context panoramas
    from the same seeded weights and batch: the loss at 1e-3 relative, each
    leaf's gradient within GRAD_TOL of the global max|g|."""
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step

    cfg = EncoderConfig(
        d_feature=32, num_depth_candidates=16, costvolume_unet_feat_dim=32,
        costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
        depth_unet_feat_dim=8, depth_unet_attn_res=(8,), depth_unet_channel_mult=(1, 1, 1, 1),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1),
    )
    rng = np.random.default_rng(seed)
    h, w = 64, 256
    fwd_name, bwd_name = path_kernels(n_ctx * h * w)
    batch = {}
    for part, v in (("context", n_ctx), ("target", 2)):
        pose = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
        pose[..., :3, 3] = rng.normal(0, 0.2, (1, v, 3))
        depth = rng.uniform(0.5, 5.0, (1, v, h, w))
        depth[rng.uniform(size=depth.shape) < 0.05] = 0.0
        batch[part] = dict(image_sphere=rng.uniform(0, 1, (1, v, h, w, 3)), extrinsics_sphere=pose,
                           depth_sphere=depth, near=np.full((1, v), 0.1), far=np.full((1, v), 10.0))
    out = {}
    for dev in ("cpu", "cuda"):
        state = create_train_state(cfg, TrainConfig(), seed=seed, device=dev)
        grads = {}

        def keep(stage):
            if stage == "backward":
                grads.update({k: p.grad.detach().cpu().clone()
                              for k, p in state.model.named_parameters()})

        calls = dict(comp.launch_counts)
        metrics = train_step(state, batch, on_stage=keep)
        delta = {k: comp.launch_counts[k] - calls[k] for k in calls}
        if dev == "cuda" and delta != {k: int(k in (fwd_name, bwd_name)) for k in delta}:
            raise AssertionError(f"GPU step: expected 1 {fwd_name} and 1 {bwd_name} call, "
                                 f"got {delta}")
        out[dev] = ({k: float(v) for k, v in metrics.items()}, grads)
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out["cuda"]
    print(f"  {n_ctx} context panoramas, kernels {fwd_name}, {bwd_name}; metrics cpu / gpu: "
          + ", ".join(f"{k} {m_cpu[k]:.6g} / {m_gpu[k]:.6g}" for k in sorted(m_cpu)))
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    worst = max((float((g_gpu[k] - g).abs().max()) / scale, k) for k, g in g_cpu.items())
    rel_loss = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    print(f"  loss: |gpu-cpu|/|cpu| = {rel_loss:.2e}; gradients: worst leaf {worst[1]} at "
          f"{worst[0]:.2e} of max|g| (bar {GRAD_TOL:g})")
    # cuDNN sums in another order than the CPU (~1e-4 of max|x| in the
    # encoder, phase 3b): the loss is held at 1e-3 relative, each leaf's
    # gradient within 2e-3 of the global max|g|
    if rel_loss > 1e-3 or worst[0] > GRAD_TOL:
        raise AssertionError("GPU train step differs from the CPU one")


@phase("3d. GPU train step vs CPU train step, small input")
def phase_small_train(seed):
    small_train(seed, N_CTX)


@phase("3g. GPU train step vs CPU train step, small input, 3 context panoramas (unfused path)")
def phase_small_train3(seed):
    from splatter360_tpu_torch.ops.cuda import composite as comp

    # the fused budget at this scale: 2 context panoramas of 64x256 fused, 3 unfused
    budget = comp.FUSED_TABLE_BUDGET
    comp.FUSED_TABLE_BUDGET = comp.fused_table_bytes(N_CTX3 * 64 * 256) - 1
    try:
        small_train(seed, N_CTX3)
    finally:
        comp.FUSED_TABLE_BUDGET = budget


@phase("4. timing")
def phase_timing(check, serve, bcheck, train, ucheck, ubcheck, serve3, train3):
    from splatter360_tpu_torch.ops.cuda import composite as comp

    rows = {}
    for label, res, unfused in (("flagship 1 view", check, False),
                                ("serving 4 views", serve, False),
                                ("unfused 3-view flagship 1 view", ucheck, True),
                                ("unfused serving 4 views", serve3, True)):
        if res is None:
            continue
        inp = res["inp"]
        ms = time_cuda(fwd_calls(inp, unfused)[0], iters=20)
        plain_ms = res["stats"]["plain_ms"]
        b_ms, b_by, ops_ms, bytes_ms = bound_ms(inp, res["stats"], unfused)
        print(f"[{label}] kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
              f"set by {b_by} (operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), "
              f"blocks {res['stats']['blocks_processed']}, "
              f"gated pairs {res['stats']['pairs_alive']}")
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        if unfused:
            # what the JAX threshold costs here: the fused kernel on the same
            # Gaussians, against the unfused path's pack + kernel
            pack_ms = time_cuda(lambda: comp.pack_instances(
                inp["attrs"], inp["gidx"], inp["tile_ids"], inp["nty"] * inp["ntx"]), iters=10)
            fused_ms = time_cuda(fwd_calls(inp)[0], iters=20)
            print(f"[{label}] pack_instances {pack_ms:.3f} ms; unfused path (pack + kernel) "
                  f"{pack_ms + ms:.3f} ms; the fused kernel on the same inputs {fused_ms:.3f} ms")
            rows[label].update(pack_ms=pack_ms, fused_ms=fused_ms)
    for label, res, unfused in (("backward flagship 1 view", bcheck, False),
                                ("backward train 4 views", train, False),
                                ("unfused backward 3-view flagship 1 view", ubcheck, True),
                                ("unfused backward train 4 views", train3, True)):
        if res is None:
            continue
        args, inp = res["args"], res["inp"]
        backward = comp.composite_backward_unfused if unfused else comp.composite_backward
        ms = time_cuda(lambda: backward(*args), iters=10)
        b_ms, b_by, ops_ms, bytes_ms = bwd_bound_ms(inp, res["stats"], unfused)
        print(f"[{label}] kernel {ms:.3f} ms, plain {res['plain_ms']:.1f} ms, bound {b_ms:.4f} ms "
              f"set by {b_by} (operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), "
              f"{res['stats']}")
        rows[label] = dict(ms=ms, plain_ms=res["plain_ms"], bound_ms=b_ms, bound_by=b_by)
        if unfused:
            # the scatter apart, and the fused backward kernel on the same
            # inputs (what the JAX threshold costs here)
            dout = comp.composite_backward_unfused(*args)
            inst, starts, counts, g_planes, lt, nproc = args[:6]
            n = inp["attrs"].shape[1]
            scatter_ms = time_cuda(lambda: comp.scatter_out_blocks(
                dout, inp["gidx"], starts, counts, nproc, n), iters=10)
            fused_ms = time_cuda(lambda: comp.composite_backward(
                inp["attrs"], inp["gidx"], starts, counts, *args[3:]), iters=10)
            print(f"[{label}] scatter_out_blocks {scatter_ms:.3f} ms; unfused path (kernel + "
                  f"scatter) {ms + scatter_ms:.3f} ms; the fused backward kernel on the same "
                  f"inputs {fused_ms:.3f} ms")
            rows[label].update(scatter_ms=scatter_ms, fused_ms=fused_ms)
    if serve is not None:
        parts = render_breakdown(serve["gaussians"], list(serve["tgt_pose"]))
        print(f"[render breakdown, {N_TGT} views] " +
              ", ".join(f"{s} {t:.3f} ms" for s, t in parts.items()))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import splatter360_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = smi_line()
    print(f"card: {smi}", flush=True)
    phase_build()
    built = not failures
    check = phase_kernel_check(args.seed) if built else None
    bcheck = phase_bwd_check(check, args.seed) if check is not None else None
    ucheck = phase_unfused_check(args.seed) if built else None
    ubcheck = phase_unfused_bwd_check(ucheck, args.seed) if ucheck is not None else None
    serve = phase_serve(args.seed)
    phase_small_reference(args.seed)
    train = phase_train(args.seed)
    phase_small_train(args.seed)
    serve3 = phase_serve3(args.seed)
    train3 = phase_train3(args.seed)
    phase_small_train3(args.seed)
    rows = phase_timing(check, serve, bcheck, train, ucheck, ubcheck, serve3, train3) or {}
    # each path's own kernels, counted over its own run
    for label, res, names in (
            ("serving", serve, ("composite_forward_fused",)),
            ("training", train, ("composite_forward_fused", "composite_backward_fused")),
            ("3-view serving", serve3, ("composite_forward_unfused",)),
            ("3-view training", train3, ("composite_forward_unfused",
                                         "composite_backward_unfused"))):
        if res is None:
            failures.append(f"{label} run missing")
        elif min(res["launches"].get(k, 0) for k in names) == 0:
            failures.append(f"a kernel of {names} never launched on the {label} path")
    if failures:
        print(f"chip_smoke FAILED: {failures}", file=sys.stderr)
        sys.exit(1)

    def row(name, source, replaces, res, err, timing):
        return dict(name=name, route="cuda", source=f"splatter360_tpu_torch/csrc/{source}",
                    replaces=f"splatter360_tpu/ops/pallas/composite.py:{replaces}",
                    launches=res["launches"][name], max_abs_err=err, ms=timing["ms"],
                    plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                    bound_by=timing["bound_by"], library_ms=None)

    kernels = [
        row("composite_forward_fused", "composite_fwd.cu", 370, serve,
            max(check["err"], serve["err"]), rows["serving 4 views"]),
        row("composite_backward_fused", "composite_bwd.cu", 517, train,
            max(bcheck["err"], train["err"]), rows["backward train 4 views"]),
        row("composite_forward_unfused", "composite_fwd_unfused.cu", 289, serve3,
            max(ucheck["err"], serve3["err"]), rows["unfused serving 4 views"]),
        row("composite_backward_unfused", "composite_bwd_unfused.cu", 705, train3,
            max(ubcheck["err"], train3["err"]), rows["unfused backward train 4 views"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
