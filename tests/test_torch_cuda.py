"""The compositor's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch, numpy and the port, so it runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(tests/conftest.py imports JAX). On a host without a card every test skips.
Built with -fmad=false and walking each pixel's instances in the same order,
the kernel rounds as the plain version does; the bars are still the
compositor bars of tests/test_pallas_composite.py:47-49 (rgb/alpha 1e-4,
depth 5e-4), and `n_processed` must be equal. The backward kernel sums
over pixels and tiles with atomics, in another order than the plain
version: each row of g_attrs is held within 2e-3 of its max|g|, the bar of
tests/test_pallas_composite.py:66-71, and its error's L2 norm within 1e-5
of the row's, which a kernel right only on the largest gradients fails.
The unfused kernels (the path past the fused table budget) are held the
same way, through the pack, map and scatter around them. All four kernels
cut a heavy tile's blocks into spans of S blocks; each is held at spans of
1 and 3 blocks and the default against the plain version at the same span.
The pinhole cases hold all four at wrap_x=False (spans 1 and the default):
the 6 cube faces of a scene at 96x96 (one tile column, 32 columns off the
image) and a 64x256 view with splats across both side edges.
"""

import math

import numpy as np
import pytest
import torch

from splatter360_tpu_torch.geometry.transforms import build_covariance_sym6
from splatter360_tpu_torch.ops.cuda import composite as tc
from splatter360_tpu_torch.geometry.cubemap import cube_face_extrinsics, cube_face_intrinsics
from splatter360_tpu_torch.ops.projection import project_erp, project_pinhole, sh_colors
from splatter360_tpu_torch.ops.tiling import assign_tiles

ATOL_RGB, ATOL_DEPTH = 1e-4, 5e-4
GRAD_TOL = 2e-3
L2_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compositor kernel runs only on the card")
    return torch.device("cuda")


def random_scene(n, seed):
    """numpy-seeded Gaussians around the origin (bench.py's recipe)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    means = d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(0.5, 6.0, (n, 1))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    sh = 0.3 * rng.normal(size=(n, 3, 9))
    sh[..., 0] += 0.5
    return (64, 256), means, rng.uniform(0.01, 0.12, (n, 3)), q, sh, rng.uniform(0.3, 0.95, n)


def saturating_scene():
    """Dense opaque blobs over every pixel of a 32x256 view, so tiles
    saturate and the per-tile early exit fires (the scene of
    tests/test_pallas_composite.py::_saturating_scene)."""
    hh, ww = 32, 256
    focal = ww / (2 * math.pi)
    means, scales = [], []
    for d in np.linspace(1.0, 6.0, 40):
        for u in np.arange(6.0, 128.0, 12.0):
            for vv in np.arange(2.5, 32.0, 5.0):
                theta = (0.5 - (u + 0.5) / ww) * 2 * math.pi
                phi = (0.5 - (vv + 0.5) / hh) * math.pi
                means.append(d * np.array([math.cos(phi) * math.sin(theta), math.sin(phi),
                                           math.cos(phi) * math.cos(theta)]))
                scales.append([10.0 * d / focal] * 3)
    n = len(means)
    sh = 0.3 * np.random.default_rng(8).normal(size=(n, 3, 9))
    sh[..., 0] += 0.5
    quats = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    return (hh, ww), np.array(means), np.array(scales), quats, sh, np.full(n, 0.92)


def scene_inputs(kind, device):
    """The compositor's inputs (one view) for a scene: attrs, gidx, starts,
    counts, nty, ntx, w_img, wrap_x, and the assignment (whose tile_ids the
    unfused pack reads)."""
    shape, *arrays = random_scene(20000, seed=5) if kind == "random" else saturating_scene()
    means, scales, quats, sh, op = (torch.as_tensor(np.asarray(x, np.float32), device=device)
                                    for x in arrays)
    covs = build_covariance_sym6(scales, quats)
    c2w = torch.eye(4, device=device)
    proj = project_erp(means, covs, c2w, shape, 0.1, opacities=op)
    asg = assign_tiles(proj, shape, True)
    attrs = tc.build_attrs(proj.mean2d, proj.conic, sh_colors(sh, means, c2w[:3, 3], 2), op,
                           proj.depth, proj.radius)
    args = (attrs[None], asg.gaussian_idx[None], asg.tile_starts[None], asg.tile_counts[None],
            asg.num_tiles_y, asg.num_tiles_x, float(shape[1]), True)
    return args, asg


FWD_SPANS = [1, 3, tc.FWD_SPAN]


@pytest.fixture
def cut_every_tile(monkeypatch):
    """No tile of these scenes holds FWD_HEAVY_OVER_MEAN times the mean
    segment; with that floor at 0 the forward cuts every tile past the
    call's segment blocks over the slots, a few blocks here, so its spans,
    scan and combine run."""
    monkeypatch.setattr(tc, "FWD_HEAVY_OVER_MEAN", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("span", FWD_SPANS)
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_kernel_matches_plain_on_card(cuda_device, cut_every_tile, kind, span):
    args, asg = scene_inputs(kind, cuda_device)
    before = tc.launch_counts[tc.KERNEL_NAME]
    got = tc.composite_forward(*args, span=span)
    assert tc.launch_counts[tc.KERNEL_NAME] == before + 1
    ref = tc.composite_forward_plain(*args, span=span)
    assert tc.launch_counts[tc.KERNEL_NAME] == before + 1  # the plain version is no launch
    torch.cuda.synchronize()
    got, ref = got[0].cpu().numpy(), ref[0].cpu().numpy()
    for plane, tol in ((0, ATOL_RGB), (1, ATOL_RGB), (2, ATOL_RGB), (3, ATOL_DEPTH), (4, ATOL_RGB)):
        np.testing.assert_allclose(got[:, plane], ref[:, plane], atol=tol)
    np.testing.assert_array_equal(got[:, 6], ref[:, 6])
    if kind == "saturating":
        starts, counts = asg.tile_starts.cpu().numpy(), asg.tile_counts.cpu().numpy()
        n_blocks = (starts + counts + 127) // 128 - starts // 128
        assert (got[:, 6, 0] < n_blocks).any(), "the per-tile early exit never fired"


SPANS = [1, 3, tc.BWD_SPAN]


@pytest.mark.cuda
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_backward_kernel_matches_plain_on_card(cuda_device, kind, span):
    """The backward kernel against the plain backward on the same forward
    planes and a seeded cotangent on planes 0-4, both at `span`."""
    args, _ = scene_inputs(kind, cuda_device)
    attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x = args
    planes = tc.composite_forward(*args)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    g_planes = torch.zeros_like(planes)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen, device=cuda_device)
    bwd = (attrs, gidx, starts, counts, g_planes, planes[:, :, 5].contiguous(),
           planes[:, :, 6, 0].to(torch.int32), nty, ntx, w_img, wrap_x)
    before = tc.launch_counts[tc.BWD_KERNEL_NAME]
    got = tc.composite_backward(*bwd, span=span)
    ref = tc.composite_backward_plain(*bwd, span=span)
    assert tc.launch_counts[tc.BWD_KERNEL_NAME] == before + 1
    torch.cuda.synchronize()
    got, ref = got[0].cpu().numpy(), ref[0].cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 10:], 0.0)
    for row in range(tc.N_GRAD):
        scale = np.abs(ref[:, row]).max() + 1e-12
        np.testing.assert_allclose(got[:, row] / scale, ref[:, row] / scale, atol=GRAD_TOL,
                                   err_msg=f"row {row}")
        l2 = np.linalg.norm(got[:, row] - ref[:, row]) / (np.linalg.norm(ref[:, row]) + 1e-30)
        assert l2 <= L2_TOL, (row, l2)


@pytest.mark.cuda
def test_backward_launches_once_per_backward(cuda_device):
    """composite_tiles under autograd: one forward and one backward kernel
    call per render of (all views) and backward()."""
    args, asg = scene_inputs("random", cuda_device)
    attrs = args[0].clone().requires_grad_(True)
    shape = (asg.num_tiles_y * 16, int(args[6]))
    counts = dict(tc.launch_counts)
    rgb, alpha, depth = tc.composite_tiles([asg], attrs, shape, torch.zeros(3, device=cuda_device),
                                           True)
    (rgb.sum() + alpha.sum() + depth.sum()).backward()
    torch.cuda.synchronize()
    assert tc.launch_counts[tc.KERNEL_NAME] == counts[tc.KERNEL_NAME] + 1
    assert tc.launch_counts[tc.BWD_KERNEL_NAME] == counts[tc.BWD_KERNEL_NAME] + 1
    assert torch.isfinite(attrs.grad).all() and bool((attrs.grad[..., :10] != 0).any())


def unfused_args(args, asg):
    """The unfused kernels' inputs for scene_inputs' args: the packed
    instance blocks, starts, counts, nty, ntx, w_img, wrap_x."""
    attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x = args
    inst = tc.pack_instances(attrs, gidx, asg.tile_ids[None], nty * ntx)
    return inst, starts, counts, nty, ntx, w_img, wrap_x


@pytest.mark.cuda
@pytest.mark.parametrize("span", FWD_SPANS)
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_unfused_kernel_matches_plain_on_card(cuda_device, cut_every_tile, kind, span):
    """The unfused forward kernel against its plain version at the
    compositor bars, n_processed equal, and against the fused kernel on the
    same instances: bit for bit, all at `span`."""
    args, asg = scene_inputs(kind, cuda_device)
    uargs = unfused_args(args, asg)
    before = tc.launch_counts[tc.UNFUSED_KERNEL_NAME]
    got = tc.composite_forward_unfused(*uargs, span=span)
    ref = tc.composite_forward_unfused_plain(*uargs, span=span)
    fused = tc.composite_forward(*args, span=span)
    assert tc.launch_counts[tc.UNFUSED_KERNEL_NAME] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, fused)
    got, ref = got[0].cpu().numpy(), ref[0].cpu().numpy()
    for plane, tol in ((0, ATOL_RGB), (1, ATOL_RGB), (2, ATOL_RGB), (3, ATOL_DEPTH), (4, ATOL_RGB)):
        np.testing.assert_allclose(got[:, plane], ref[:, plane], atol=tol)
    np.testing.assert_array_equal(got[:, 6], ref[:, 6])


@pytest.mark.cuda
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_unfused_backward_kernel_matches_plain_on_card(cuda_device, kind, span):
    """The unfused backward kernel, map and scatter against the plain
    backward's blocks through the same map and scatter, per row of g_attrs
    at the bars above, both at `span`; its live out-blocks equal bit for bit
    from run to run (no atomics in the kernel)."""
    args, asg = scene_inputs(kind, cuda_device)
    inst, starts, counts, nty, ntx, w_img, wrap_x = unfused_args(args, asg)
    planes = tc.composite_forward_unfused(inst, starts, counts, nty, ntx, w_img, wrap_x)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    g_planes = torch.zeros_like(planes)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen, device=cuda_device)
    nproc = planes[:, :, 6, 0].to(torch.int32)
    bwd = (inst, starts, counts, g_planes, planes[:, :, 5].contiguous(), nproc, nty, ntx, w_img,
           wrap_x)
    before = tc.launch_counts[tc.UNFUSED_BWD_KERNEL_NAME]
    dout = tc.composite_backward_unfused(*bwd, span=span)
    dout2 = tc.composite_backward_unfused(*bwd, span=span)
    ref_dout = tc.composite_backward_unfused_plain(*bwd, span=span)
    assert tc.launch_counts[tc.UNFUSED_BWD_KERNEL_NAME] == before + 2
    _, live = tc.out_block_map(starts, counts, nproc, dout.shape[1])
    assert torch.equal(dout[live], dout2[live])
    n = args[0].shape[1]
    got = tc.scatter_out_blocks(dout, args[1], starts, counts, nproc, n)[0].cpu().numpy()
    ref = tc.scatter_out_blocks(ref_dout, args[1], starts, counts, nproc, n)[0].cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 10:], 0.0)
    for row in range(tc.N_GRAD):
        scale = np.abs(ref[:, row]).max() + 1e-12
        np.testing.assert_allclose(got[:, row] / scale, ref[:, row] / scale, atol=GRAD_TOL,
                                   err_msg=f"row {row}")
        l2 = np.linalg.norm(got[:, row] - ref[:, row]) / (np.linalg.norm(ref[:, row]) + 1e-30)
        assert l2 <= L2_TOL, (row, l2)


@pytest.mark.cuda
def test_composite_tiles_takes_the_unfused_kernels_past_the_budget(cuda_device, monkeypatch):
    """Past FUSED_TABLE_BUDGET composite_tiles launches one unfused forward
    and, under backward(), one unfused backward, and no fused kernel."""
    monkeypatch.setattr(tc, "FUSED_TABLE_BUDGET", 0)
    args, asg = scene_inputs("random", cuda_device)
    attrs = args[0].clone().requires_grad_(True)
    shape = (asg.num_tiles_y * 16, int(args[6]))
    counts = dict(tc.launch_counts)
    rgb, alpha, depth = tc.composite_tiles([asg], attrs, shape, torch.zeros(3, device=cuda_device),
                                           True)
    (rgb.sum() + alpha.sum() + depth.sum()).backward()
    torch.cuda.synchronize()
    delta = {k: tc.launch_counts[k] - counts[k] for k in counts}
    assert delta == {tc.KERNEL_NAME: 0, tc.BWD_KERNEL_NAME: 0, tc.UNFUSED_KERNEL_NAME: 1,
                     tc.UNFUSED_BWD_KERNEL_NAME: 1}
    assert torch.isfinite(attrs.grad).all() and bool((attrs.grad[..., :10] != 0).any())


def test_unfused_kernels_refuse_bad_inputs():
    """The unfused wrappers check layout and dtype before any launch (on any
    host)."""
    inst = torch.zeros(1, 2, 16, 128)
    seg = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="inst"):
        tc.composite_forward_unfused(inst[..., :64], seg, seg, 1, 2, 256.0, True)
    with pytest.raises(ValueError, match="counts"):
        tc.composite_forward_unfused(inst, seg, seg[:, :1], 1, 2, 256.0, True)
    for span in (0, -1, 2.0, True):
        with pytest.raises(ValueError, match="span"):
            tc.composite_forward_unfused(inst, seg, seg, 1, 2, 256.0, True, span=span)
    g_planes = torch.zeros(1, 2, 8, 2048)
    lt = torch.zeros(1, 2, 2048)
    with pytest.raises(ValueError, match="inst"):
        tc.composite_backward_unfused(inst.double(), seg, seg, g_planes, lt, seg, 1, 2, 256.0, True)
    with pytest.raises(ValueError, match="nproc"):
        tc.composite_backward_unfused(inst, seg, seg, g_planes, lt, seg.long(), 1, 2, 256.0, True)


def test_kernel_refuses_bad_inputs():
    """The wrappers check layout and dtype before any launch (on any host)."""
    attrs = torch.zeros(1, 8, 16)
    gidx = torch.zeros(1, 128, dtype=torch.int32)
    seg = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="attrs"):
        tc.composite_forward(attrs[..., :12], gidx, seg, seg, 1, 2, 256.0, True)
    with pytest.raises(ValueError, match="gidx"):
        tc.composite_forward(attrs, gidx[:, :100], seg, seg, 1, 2, 256.0, True)
    with pytest.raises(ValueError, match="starts"):
        tc.composite_forward(attrs, gidx, seg.long(), seg, 1, 2, 256.0, True)
    for span in (0, -1, 2.0, True):
        with pytest.raises(ValueError, match="span"):
            tc.composite_forward(attrs, gidx, seg, seg, 1, 2, 256.0, True, span=span)
    g_planes = torch.zeros(1, 2, 8, 2048)
    lt = torch.zeros(1, 2, 2048)
    bwd = (attrs, gidx, seg, seg, g_planes, lt, seg)
    with pytest.raises(ValueError, match="attrs"):
        tc.composite_backward(attrs[..., :12], *bwd[1:], 1, 2, 256.0, True)
    with pytest.raises(ValueError, match="g_planes"):
        tc.composite_backward(*bwd[:4], g_planes[:, :, :5], lt, seg, 1, 2, 256.0, True)
    with pytest.raises(ValueError, match="lt_final"):
        tc.composite_backward(*bwd[:5], lt.double(), seg, 1, 2, 256.0, True)
    with pytest.raises(ValueError, match="nproc"):
        tc.composite_backward(*bwd[:6], seg.float(), 1, 2, 256.0, True)
    for span in (0, -1, 2.0, True):
        with pytest.raises(ValueError, match="span"):
            tc.composite_backward(*bwd, 1, 2, 256.0, True, span=span)


def pinhole_inputs(kind, device, bin_wrapped=False):
    """The compositor's inputs at wrap_x=False and the views' tile_ids:
    "faces", the 6 cube faces (96x96) of random_scene's Gaussians from the
    origin, each face's instance list capped at max(N, 4096) as the cube
    renderer caps it; "edge", one 64x256 view (fx = fy = 128 px) of
    Gaussians of which a quarter sit on the left and right image edges,
    binned with the wrap when `bin_wrapped` (each edge splat also lands in
    the far edge's tile)."""
    rng = np.random.default_rng(9)
    if kind == "faces":
        shape, means, scales, quats, sh, op = random_scene(20000, seed=5)
        c2ws = cube_face_extrinsics(torch.eye(4, device=device))
        intr = cube_face_intrinsics(device=device)
        shape = (96, 96)
    else:
        shape, n = (64, 256), 1000
        z = rng.uniform(1.0, 6.0, n)
        u = np.concatenate([rng.uniform(-6, 6, n // 8), rng.uniform(250, 262, n // 8),
                            rng.uniform(-20, 276, n - n // 4)])
        v = rng.uniform(-4, 68, n)
        means = np.stack([(u - 127.5) / 128 * z, (v - 31.5) / 128 * z, z], -1)
        scales = rng.uniform(0.01, 0.04, (n, 3)) * z[:, None]
        quats = rng.normal(size=(n, 4))
        quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
        sh = 0.3 * rng.normal(size=(n, 3, 9))
        sh[..., 0] += 0.5
        op = rng.uniform(0.3, 0.95, n)
        c2ws = torch.eye(4, device=device)[None]
        intr = torch.tensor([[0.5, 0, 0.5], [0, 2.0, 0.5], [0, 0, 1]], device=device)
    means, scales, quats, sh, op = (torch.as_tensor(np.asarray(x, np.float32), device=device)
                                    for x in (means, scales, quats, sh, op))
    covs = build_covariance_sym6(scales, quats)
    colors = sh_colors(sh, means, c2ws[0, :3, 3], 2)
    attrs, asgs = [], []
    for c2w in c2ws:
        proj = project_pinhole(means, covs, c2w, intr, shape, 0.1, opacities=op)
        cap = max(means.shape[0], 4096) if kind == "faces" else None
        asgs.append(assign_tiles(proj, shape, bin_wrapped, instance_cap=cap))
        attrs.append(tc.build_attrs(proj.mean2d, proj.conic, colors, op, proj.depth,
                                    proj.radius))
    args = (torch.stack(attrs), *(torch.stack([getattr(a, k) for a in asgs])
                                  for k in ("gaussian_idx", "tile_starts", "tile_counts")),
            asgs[0].num_tiles_y, asgs[0].num_tiles_x, float(shape[1]), False)
    return args, torch.stack([a.tile_ids for a in asgs])


PINHOLE_FWD_SPANS = [1, tc.FWD_SPAN]


@pytest.mark.cuda
@pytest.mark.parametrize("span", PINHOLE_FWD_SPANS)
@pytest.mark.parametrize("kind", ["faces", "edge"])
def test_pinhole_forward_kernels_match_plain_on_card(cuda_device, cut_every_tile, kind, span):
    """Both forward kernels at wrap_x=False against their plain versions,
    all 8 planes bit for bit, and the unfused kernel bit-equal to the fused
    one. On the edge view binned with the wrap, the kernel at wrap_x=True
    carries the splats across the edges and at wrap_x=False it does not:
    the two differ in the edge columns, so the flag reaches the kernel."""
    args, tile_ids = pinhole_inputs(kind, cuda_device)
    attrs, gidx, starts, counts, nty, ntx, w_img, _ = args
    inst = tc.pack_instances(attrs, gidx, tile_ids, nty * ntx)
    uargs = (inst, starts, counts, nty, ntx, w_img, False)
    before = dict(tc.launch_counts)
    got = tc.composite_forward(*args, span=span)
    got_u = tc.composite_forward_unfused(*uargs, span=span)
    assert tc.launch_counts[tc.KERNEL_NAME] == before[tc.KERNEL_NAME] + 1
    assert tc.launch_counts[tc.UNFUSED_KERNEL_NAME] == before[tc.UNFUSED_KERNEL_NAME] + 1
    assert torch.equal(got, tc.composite_forward_plain(*args, span=span))
    assert torch.equal(got_u, tc.composite_forward_unfused_plain(*uargs, span=span))
    assert torch.equal(got, got_u)
    assert bool((got[:, :, 4] < 1.0).any())  # something was composited
    if kind == "edge":
        wrapped, _ = pinhole_inputs(kind, cuda_device, bin_wrapped=True)
        bg = torch.zeros(3, device=cuda_device)
        alpha = {flag: tc.compose_planes(tc.composite_forward(*wrapped[:-1], flag, span=span),
                                         (64, 256), nty, ntx, bg)[1][0]
                 for flag in (False, True)}
        diff = (alpha[True] - alpha[False]).abs().amax(dim=0)
        assert float(diff[:12].max()) > 0.1 and float(diff[-12:].max()) > 0.1
        # the middle gets only zero alphas more: its T moves only where the
        # tile's exit does, below 1e-4
        assert float(diff[64:192].max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("span", [1, tc.BWD_SPAN])
@pytest.mark.parametrize("kind", ["faces", "edge"])
def test_pinhole_backward_kernels_match_plain_on_card(cuda_device, kind, span):
    """Both backward kernels at wrap_x=False against their plain versions on
    the kernel's forward planes and a seeded cotangent on planes 0-4 (zero
    on the faces' off-image pixels, as compose_planes' crop gives them), per
    row of g_attrs at the bars above."""
    args, tile_ids = pinhole_inputs(kind, cuda_device)
    attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x = args
    planes = tc.composite_forward(*args)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    g_planes = torch.zeros_like(planes)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen, device=cuda_device)
    side = 96 if kind == "faces" else 256
    col = torch.arange(2048, device=cuda_device) % 128 + 128 * (
        torch.arange(nty * ntx, device=cuda_device) % ntx)[:, None]
    g_planes = g_planes * (col < side)[None, :, None, :]
    lt, nproc = planes[:, :, 5].contiguous(), planes[:, :, 6, 0].to(torch.int32)
    bwd = (g_planes, lt, nproc, nty, ntx, w_img, wrap_x)
    inst = tc.pack_instances(attrs, gidx, tile_ids, nty * ntx)
    before = dict(tc.launch_counts)
    got = tc.composite_backward(attrs, gidx, starts, counts, *bwd, span=span)
    ref = tc.composite_backward_plain(attrs, gidx, starts, counts, *bwd, span=span)
    dout = tc.composite_backward_unfused(inst, starts, counts, *bwd, span=span)
    ref_dout = tc.composite_backward_unfused_plain(inst, starts, counts, *bwd, span=span)
    assert tc.launch_counts[tc.BWD_KERNEL_NAME] == before[tc.BWD_KERNEL_NAME] + 1
    assert tc.launch_counts[tc.UNFUSED_BWD_KERNEL_NAME] == before[tc.UNFUSED_BWD_KERNEL_NAME] + 1
    n = attrs.shape[1]
    got_u = tc.scatter_out_blocks(dout, gidx, starts, counts, nproc, n)
    ref_u = tc.scatter_out_blocks(ref_dout, gidx, starts, counts, nproc, n)
    torch.cuda.synchronize()
    for kernel, plain in ((got, ref), (got_u, ref_u)):
        kernel, plain = kernel.cpu().numpy(), plain.cpu().numpy()
        assert np.isfinite(kernel).all()
        np.testing.assert_array_equal(kernel[..., 10:], 0.0)
        for row in range(tc.N_GRAD):
            k_row, p_row = kernel[..., row].ravel(), plain[..., row].ravel()
            scale = np.abs(p_row).max() + 1e-12
            np.testing.assert_allclose(k_row / scale, p_row / scale, atol=GRAD_TOL,
                                       err_msg=f"row {row}")
            l2 = np.linalg.norm(k_row - p_row) / (np.linalg.norm(p_row) + 1e-30)
            assert l2 <= L2_TOL, (row, l2)


# the scan compositor (render_backend "jax", and ERP views under 2 tiles
# wide) is plain PyTorch: on the card it must give the CPU's planes (the
# compositor bars) and gradients (GRAD_TOL of each row's max|g|) on the same
# inputs; its sums run in another order there (cuBLAS einsum, atomics in the
# gather's backward)


def scan_case(kind, device):
    """(attrs [V, N, 16], assignments, image shape, wrap_x) on `device`: a
    64x256 ERP view of the random scene, or the 6 32x32 faces of one pose."""
    from splatter360_tpu_torch.models.decoder import cube_face_batch
    from splatter360_tpu_torch.ops.rasterizer import batch_inputs

    shape, *arrays = random_scene(3000, seed=9)
    means, scales, quats, sh, op = (torch.as_tensor(np.asarray(x, np.float32)) for x in arrays)
    covs = build_covariance_sym6(scales, quats)
    c2w = torch.eye(4)[None]
    if kind == "faces":
        c2w, near, far, kw = cube_face_batch(c2w, torch.tensor([0.1]), torch.tensor([100.0]),
                                             means.shape[0])
        shape = (32, 32)
    else:
        near, far, kw = 0.1, 100.0, {}
    attrs, asg, wrap_x = batch_inputs(means, covs, sh, op, c2w, shape, near, far, **kw)
    asg = [type(a)(*(f.to(device) if torch.is_tensor(f) else f for f in a)) for a in asg]
    return attrs.to(device), asg, shape, wrap_x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["erp", "faces"])
def test_scan_compositor_card_vs_cpu(cuda_device, kind):
    from splatter360_tpu_torch.ops import composite_scan as ts

    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        attrs, asg, shape, wrap_x = scan_case(kind, dev)
        attrs.requires_grad_(True)
        before = dict(tc.launch_counts)
        rgb, alpha, depth = ts.composite_tiles_scan(asg, attrs, shape,
                                                    torch.zeros(3, device=dev), wrap_x)
        (((rgb - 0.5) ** 2).sum() + 0.1 * alpha.sum() + 0.01 * depth.sum()).backward()
        assert tc.launch_counts == before  # no kernel on this path
        out[dev.type] = [x.detach().cpu() for x in (rgb, alpha, depth, attrs.grad)]
    for i, atol in enumerate((ATOL_RGB, ATOL_RGB, ATOL_DEPTH)):
        torch.testing.assert_close(out["cuda"][i], out["cpu"][i], rtol=0, atol=atol)
    assert float(out["cpu"][1].max()) > 0.5
    g_cpu, g_gpu = out["cpu"][3], out["cuda"][3]
    for row in range(tc.N_GRAD):
        scale = float(g_cpu[..., row].abs().max()) + 1e-30
        assert float((g_gpu[..., row] - g_cpu[..., row]).abs().max()) <= GRAD_TOL * scale, row


@pytest.mark.cuda
def test_narrow_erp_takes_the_scan_on_card(cuda_device):
    """render_tiled(backend="pallas") of a 64x128 ERP view: the scan
    compositor renders it on the card, no kernel launches."""
    from splatter360_tpu_torch.ops import composite_scan as ts
    from splatter360_tpu_torch.ops.rasterizer import render_tiled

    _, *arrays = random_scene(3000, seed=9)
    means, scales, quats, sh, op = (torch.as_tensor(np.asarray(x, np.float32), device=cuda_device)
                                    for x in arrays)
    covs = build_covariance_sym6(scales, quats)
    before, calls = ts.scan_counts[ts.SCAN_NAME], dict(tc.launch_counts)
    out = render_tiled(means, covs, sh, op, torch.eye(4, device=cuda_device), (64, 128),
                       backend="pallas", render_depth=True)
    torch.cuda.synchronize()
    assert ts.scan_counts[ts.SCAN_NAME] == before + 1 and tc.launch_counts == calls
    assert out.color.is_cuda and bool(torch.isfinite(out.color).all())
