"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure ends in a non-zero exit and no result line):
  1. print the card's name and power limit; build every CUDA kernel (one
     nvcc per source, all at once);
  2. hold the forward compositor kernel against its plain PyTorch version at
     the flagship render shapes (512x1024 ERP, N = 2*512*1024 Gaussians), and
     the backward kernel against its plain version there, with a seeded
     cotangent;
  3. serve N_REQUESTS HM3D-width requests through the port's entry points
     (2 context panoramas -> encode -> N Gaussians -> 4 target ERP views with depth),
     counting kernel launches, and compare the GPU serving path with the CPU
     path on a small input;
  3c. take N_STEPS HM3D-width train steps (ERP supervision, LPIPS, depth L1,
     clip + Adam) through train.state's entry points, counting kernel calls
     and timing each stage; hold the backward kernel against its plain
     version on the last step's Gaussians (4 target views);
  3d. compare a GPU train step with a CPU one on a small input;
  4. time each kernel and its plain version with CUDA events, and the
     serving render stage by stage.
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
        starts=torch.stack([a.tile_starts for a in asg]),
        counts=torch.stack([a.tile_counts for a in asg]),
        nty=asg[0].num_tiles_y, ntx=asg[0].num_tiles_x,
        dropped=[int(a.dropped) for a in asg],
    )


def compare_kernel_plain(inp, label):
    """Kernel vs plain planes on the same inputs; returns (max_abs_err, stats)."""
    from splatter360_tpu_torch.ops.cuda.composite import (
        compose_planes, composite_forward, composite_forward_plain)

    args = (inp["attrs"], inp["gidx"], inp["starts"], inp["counts"],
            inp["nty"], inp["ntx"], float(W), True)
    pk = composite_forward(*args)
    stats: dict = {}
    pp = composite_forward_plain(*args, stats=stats)
    torch.cuda.synchronize()
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


def bound_ms(inp, stats):
    """Least time for the compositor on these inputs: the larger of
    operations over FP32 peak and bytes over HBM peak. Returns
    (bound ms, what sets it, ms of operations, ms of bytes)."""
    blocks = stats["blocks_processed"]
    ops = blocks * 128 * OPS_BOX_TEST + stats["pairs_alive"] * OPS_LIVE_PAIR
    v, t = inp["starts"].shape
    nbytes = (blocks * 128 * (16 * 4 + 4)     # attrs rows gathered + gidx
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
    rows_k, rows_p = gk[..., :N_GRAD].reshape(-1, N_GRAD), gp[..., :N_GRAD].reshape(-1, N_GRAD)
    scale = rows_p.abs().amax(dim=0)
    rel = ((rows_k - rows_p).abs().amax(dim=0) / scale.clamp(min=1e-30)).tolist()
    l2 = ((rows_k - rows_p).norm(dim=0) / rows_p.norm(dim=0).clamp(min=1e-30)).tolist()
    touched = rows_p != 0
    median = [float(rows_p[touched[:, i], i].abs().median()) if bool(touched[:, i].any()) else 0.0
              for i in range(N_GRAD)]
    err = float((gk - gp).abs().max())
    repeat = float((gk - gk2).abs().max())
    print(f"[{label}] backward: views={gk.shape[0]}, per row (u v a b c o r g b depth): "
          f"max|kernel-plain|/max|plain| {[f'{x:.2e}' for x in rel]} (bar {GRAD_TOL:g}); "
          f"|kernel-plain|_2/|plain|_2 {[f'{x:.2e}' for x in l2]} (bar {L2_TOL:g}); "
          f"max|plain| {[f'{x:.3e}' for x in scale.tolist()]}; median |plain| over the "
          f"instances it touches {[f'{x:.3e}' for x in median]}; max abs err {err:.3e}; two "
          f"kernel runs differ by {repeat:.3e}; plain {plain_ms:.1f} ms; {stats}")
    ok = (max(rel) <= GRAD_TOL and max(l2) <= L2_TOL and bool(torch.isfinite(gk).all())
          and not bool(gk[..., N_GRAD:].any()))
    if not ok:
        raise AssertionError(f"[{label}] backward kernel disagrees with the plain version")
    return dict(args=args, err=err, rel=max(rel), l2=max(l2), repeat=repeat, plain_ms=plain_ms,
                stats=stats)


def bwd_bound_ms(inp, st):
    """Least time for the backward on these inputs (see bound_ms): one box
    cull per instance and tile of the walked blocks, OPS_BWD_SUM per gated
    pair of a walked block that fails the tile-wide gate and OPS_BWD_GATED
    per gated pair of one that passes it; bytes: the gathered rows and gidx
    of the walked blocks, the cotangent planes 0-4 and logT, the segments,
    and one 40-byte gradient write per (instance, tile) of a gated block."""
    ops = (st["blocks_walked"] * 128 * OPS_BOX_TEST
           + (st["pairs_walked"] - st["pairs_gated"]) * OPS_BWD_SUM
           + st["pairs_gated"] * OPS_BWD_GATED)
    v, t = inp["starts"].shape
    nbytes = (st["blocks_walked"] * 128 * (16 * 4 + 4) + v * t * 6 * 2048 * 4
              + st["rows_written"] * 10 * 4 + 3 * v * t * 4)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_ops, t_bytes


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


def request_data(gen, near=0.1, far=10.0):
    """One request: N_CTX seeded panoramas with poses, N_TGT target poses."""
    dev = torch.device("cuda")
    img = torch.rand((1, N_CTX, H // 8, W // 8, 3), generator=gen, device=dev)
    img = torch.nn.functional.interpolate(
        img[0].permute(0, 3, 1, 2), size=(H, W), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)[None].contiguous()

    def poses(n, spread):
        p = torch.eye(4, device=dev).repeat(1, n, 1, 1)
        p[..., :3, 3] = spread * torch.randn((1, n, 3), generator=gen, device=dev)
        return p

    return dict(
        image=img, ctx_pose=poses(N_CTX, 0.3), tgt_pose=poses(N_TGT, 0.2),
        near=torch.full((1, N_CTX), near, device=dev), far=torch.full((1, N_CTX), far, device=dev),
        tgt_near=torch.full((1, N_TGT), near, device=dev), tgt_far=torch.full((1, N_TGT), far, device=dev),
    )


@phase("3. serve HM3D-width requests")
def phase_serve(seed):
    from splatter360_tpu_torch.models.encoder import HM3D
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.serve import build_model, encode, render_erp_views

    model = build_model(HM3D, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    reqs = [request_data(gen) for _ in range(N_REQUESTS)]
    torch.cuda.synchronize()

    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    gaussians = out = None
    for i, r in enumerate(reqs):
        before = comp.launch_counts[comp.KERNEL_NAME]
        t0 = time.perf_counter()
        gaussians, depth_map = encode(model, r["image"], r["ctx_pose"], r["near"], r["far"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = render_erp_views(gaussians, r["tgt_pose"], r["tgt_near"], r["tgt_far"],
                               (H, W), render_depth=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        delta = comp.launch_counts[comp.KERNEL_NAME] - before
        n = gaussians.means.shape[1]
        print(f"request {i}: encoder {1e3 * (t1 - t0):.1f} ms, render {N_TGT} views "
              f"{1e3 * (t2 - t1):.1f} ms, N={n}, dropped={out.dropped.tolist()}, "
              f"kernel launches +{delta}")
        if n != N_CTX * H * W:
            raise AssertionError(f"expected {N_CTX * H * W} Gaussians, got {n}")
        if delta != 1:
            raise AssertionError(f"expected 1 compositor launch for {N_TGT} views, got {delta}")
        check_outputs(gaussians, depth_map, out, r)
    launches = dict(comp.launch_counts)
    print(f"launch counts over the serving run: {launches}")

    # the encoder's own Gaussians through the kernel and the plain version
    r = reqs[-1]
    inp = render_inputs(gaussians.means[0], gaussians.covariances[0], gaussians.harmonics[0],
                        gaussians.opacities[0], list(r["tgt_pose"][0]), 0.1)
    one = {k: (v[:1] if torch.is_tensor(v) and v.dim() > 1 else v) for k, v in inp.items()}
    err1, _ = compare_kernel_plain(one, "encoder Gaussians, view 0")
    err4, stats = compare_kernel_plain(inp, f"encoder Gaussians, {N_TGT} views")
    return dict(inp=inp, err=max(err1, err4), stats=stats, launches=launches, gaussians=gaussians,
                tgt_pose=r["tgt_pose"][0])


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
    assert tuple(depth_map.shape) == (1, N_CTX, H, W), depth_map.shape
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


def train_batch(gen, near=0.1, far=10.0):
    """One train batch: request_data's context panoramas and poses, target
    panoramas made the same way, and context depth in [0.5, 5] with ~8%
    holes (0), all seeded."""
    r = request_data(gen, near, far)
    tgt = torch.rand((N_TGT, H // 8, W // 8, 3), generator=gen, device="cuda")
    tgt = torch.nn.functional.interpolate(tgt.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1)[None]
    depth = 0.5 + 4.5 * torch.rand((1, N_CTX, H, W), generator=gen, device="cuda")
    holes = torch.rand((1, N_CTX, H // 16, W // 16), generator=gen, device="cuda") < 0.08
    holes = holes.repeat_interleave(16, dim=2).repeat_interleave(16, dim=3)
    return dict(
        context=dict(image_sphere=r["image"], extrinsics_sphere=r["ctx_pose"],
                     depth_sphere=torch.where(holes, torch.zeros_like(depth), depth),
                     near=r["near"], far=r["far"]),
        target=dict(image_sphere=tgt.contiguous(), extrinsics_sphere=r["tgt_pose"],
                    near=r["tgt_near"], far=r["tgt_far"]),
    )


STAGES = ("encoder", "render", "losses", "backward", "optimizer")


@phase("3c. HM3D-width train steps")
def phase_train(seed):
    from splatter360_tpu_torch.models.encoder import HM3D
    from splatter360_tpu_torch.models.types import Gaussians
    from splatter360_tpu_torch.ops.cuda import composite as comp
    from splatter360_tpu_torch.serve import context_cubes
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step

    state = create_train_state(HM3D, TrainConfig(), seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    batches = [train_batch(gen) for _ in range(N_STEPS)]
    torch.cuda.synchronize()

    # CUDA events around the backward kernel's calls inside each step
    kernel_events = []
    orig_bwd = comp.composite_backward

    def timed_bwd(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig_bwd(*a, **kw)
        ev[1].record()
        kernel_events.append(ev)
        return out

    comp.composite_backward = timed_bwd
    for k in comp.launch_counts:
        comp.launch_counts[k] = 0
    steps = []
    try:
        for i, batch in enumerate(batches):
            before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            calls = dict(comp.launch_counts)
            kernel_events.clear()
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
            ms["backward kernel"] = sum(a.elapsed_time(b) for a, b in kernel_events)
            delta = {k: comp.launch_counts[k] - calls[k] for k in calls}
            vals = {k: float(v) for k, v in metrics.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(vals.items()))
                  + f"; {wall:.1f} ms: " + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                  + f"; kernel calls {delta}; peak memory {peak:.2f} GiB", flush=True)
            if not all(math.isfinite(v) for v in vals.values()):
                raise AssertionError(f"step {i}: non-finite metrics {vals}")
            if delta[comp.KERNEL_NAME] != 1 or delta[comp.BWD_KERNEL_NAME] != 1:
                raise AssertionError(f"step {i}: expected 1 forward and 1 backward kernel call, "
                                     f"got {delta}")
            still = [n for n, p in state.model.named_parameters() if torch.equal(p, before[n])]
            if still:
                raise AssertionError(f"step {i}: parameters unchanged: {still[:10]}")
            if not all(bool(torch.isfinite(p).all()) for p in state.model.parameters()):
                raise AssertionError(f"step {i}: non-finite parameters")
            steps.append(dict(wall=wall, ms=ms, peak_gib=peak, **vals))
    finally:
        comp.composite_backward = orig_bwd
    launches = dict(comp.launch_counts)
    print(f"launch counts over the training run: {launches}")

    # the last step's Gaussians, rendered into its 4 target views: backward
    # kernel vs plain at the training shapes
    ctx, tgt = batches[-1]["context"], batches[-1]["target"]
    with torch.no_grad():
        g, _ = state.model(ctx["image_sphere"], context_cubes(ctx["image_sphere"], H // 2),
                           ctx["extrinsics_sphere"], ctx["near"], ctx["far"], state.step)
    g = Gaussians(*(x[0] for x in g))
    inp = render_inputs(g.means, g.covariances, g.harmonics, g.opacities,
                        list(tgt["extrinsics_sphere"][0]), 0.1)
    res = compare_bwd_plain(inp, f"train-step Gaussians, {N_TGT} views", seed + 4)
    return dict(steps=steps, launches=launches, inp=inp, **res)


@phase("3d. GPU train step vs CPU train step, small input")
def phase_small_train(seed):
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.train.state import TrainConfig, create_train_state, train_step

    cfg = EncoderConfig(
        d_feature=32, num_depth_candidates=16, costvolume_unet_feat_dim=32,
        costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
        depth_unet_feat_dim=8, depth_unet_attn_res=(8,), depth_unet_channel_mult=(1, 1, 1, 1),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1),
    )
    rng = np.random.default_rng(seed)
    h, w = 64, 256
    batch = {}
    for part, v in (("context", 2), ("target", 2)):
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

        metrics = train_step(state, batch, on_stage=keep)
        out[dev] = ({k: float(v) for k, v in metrics.items()}, grads)
    (m_cpu, g_cpu), (m_gpu, g_gpu) = out["cpu"], out["cuda"]
    print("  metrics cpu / gpu: " + ", ".join(f"{k} {m_cpu[k]:.6g} / {m_gpu[k]:.6g}"
                                              for k in sorted(m_cpu)))
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


@phase("4. timing")
def phase_timing(check, serve, bcheck, train):
    from splatter360_tpu_torch.ops.cuda.composite import (
        composite_backward, composite_forward, composite_forward_plain)

    rows = {}
    for label, res in (("flagship 1 view", check), ("serving 4 views", serve)):
        if res is None:
            continue
        inp = res["inp"]
        args = (inp["attrs"], inp["gidx"], inp["starts"], inp["counts"],
                inp["nty"], inp["ntx"], float(W), True)
        ms = time_cuda(lambda: composite_forward(*args), iters=20)
        plain_ms = time_cuda(lambda: composite_forward_plain(*args), iters=1, warmup=0)
        b_ms, b_by, ops_ms, bytes_ms = bound_ms(inp, res["stats"])
        print(f"[{label}] kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
              f"set by {b_by} (operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), "
              f"blocks {res['stats']['blocks_processed']}, "
              f"gated pairs {res['stats']['pairs_alive']}")
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    for label, res in (("backward flagship 1 view", bcheck), ("backward train 4 views", train)):
        if res is None:
            continue
        ms = time_cuda(lambda: composite_backward(*res["args"]), iters=10)
        b_ms, b_by, ops_ms, bytes_ms = bwd_bound_ms(res["inp"], res["stats"])
        print(f"[{label}] kernel {ms:.3f} ms, plain {res['plain_ms']:.1f} ms, bound {b_ms:.4f} ms "
              f"set by {b_by} (operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), "
              f"{res['stats']}")
        rows[label] = dict(ms=ms, plain_ms=res["plain_ms"], bound_ms=b_ms, bound_by=b_by)
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
    check = phase_kernel_check(args.seed) if not failures else None
    bcheck = phase_bwd_check(check, args.seed) if check is not None else None
    serve = phase_serve(args.seed)
    phase_small_reference(args.seed)
    train = phase_train(args.seed)
    phase_small_train(args.seed)
    rows = phase_timing(check, serve, bcheck, train) or {}
    if serve is None:
        failures.append("serving run missing")
    elif serve["launches"].get("composite_forward_fused", 0) == 0:
        failures.append("compositor kernel never launched on the serving path")
    if train is None:
        failures.append("training run missing")
    elif min(train["launches"].get(k, 0) for k in ("composite_forward_fused",
                                                   "composite_backward_fused")) == 0:
        failures.append("a compositor kernel never launched on the training path")
    if failures:
        print(f"chip_smoke FAILED: {failures}", file=sys.stderr)
        sys.exit(1)

    fwd, bwd = rows["serving 4 views"], rows["backward train 4 views"]
    kernels = [dict(
        name="composite_forward_fused", route="cuda",
        source="splatter360_tpu_torch/csrc/composite_fwd.cu",
        replaces="splatter360_tpu/ops/pallas/composite.py:370",
        launches=serve["launches"]["composite_forward_fused"],
        max_abs_err=max(check["err"], serve["err"]),
        ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
        bound_by=fwd["bound_by"], library_ms=None,
    ), dict(
        name="composite_backward_fused", route="cuda",
        source="splatter360_tpu_torch/csrc/composite_bwd.cu",
        replaces="splatter360_tpu/ops/pallas/composite.py:517",
        launches=train["launches"]["composite_backward_fused"],
        max_abs_err=max(bcheck["err"], train["err"]),
        ms=bwd["ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"],
        bound_by=bwd["bound_by"], library_ms=None,
    )]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
