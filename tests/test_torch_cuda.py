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
same way, through the pack, map and scatter around them.
"""

import math

import numpy as np
import pytest
import torch

from splatter360_tpu_torch.geometry.transforms import build_covariance_sym6
from splatter360_tpu_torch.ops.cuda import composite as tc
from splatter360_tpu_torch.ops.projection import project_erp, sh_colors
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_kernel_matches_plain_on_card(cuda_device, kind):
    args, asg = scene_inputs(kind, cuda_device)
    before = tc.launch_counts[tc.KERNEL_NAME]
    got = tc.composite_forward(*args)
    assert tc.launch_counts[tc.KERNEL_NAME] == before + 1
    ref = tc.composite_forward_plain(*args)
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_backward_kernel_matches_plain_on_card(cuda_device, kind):
    """The backward kernel against the plain backward on the same forward
    planes and a seeded cotangent on planes 0-4."""
    args, _ = scene_inputs(kind, cuda_device)
    attrs, gidx, starts, counts, nty, ntx, w_img, wrap_x = args
    planes = tc.composite_forward(*args)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    g_planes = torch.zeros_like(planes)
    g_planes[:, :, :5] = torch.randn(planes[:, :, :5].shape, generator=gen, device=cuda_device)
    bwd = (attrs, gidx, starts, counts, g_planes, planes[:, :, 5].contiguous(),
           planes[:, :, 6, 0].to(torch.int32), nty, ntx, w_img, wrap_x)
    before = tc.launch_counts[tc.BWD_KERNEL_NAME]
    got = tc.composite_backward(*bwd)
    ref = tc.composite_backward_plain(*bwd)
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
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_unfused_kernel_matches_plain_on_card(cuda_device, kind):
    """The unfused forward kernel against its plain version at the
    compositor bars, n_processed equal, and against the fused kernel on the
    same instances: bit for bit."""
    args, asg = scene_inputs(kind, cuda_device)
    uargs = unfused_args(args, asg)
    before = tc.launch_counts[tc.UNFUSED_KERNEL_NAME]
    got = tc.composite_forward_unfused(*uargs)
    ref = tc.composite_forward_unfused_plain(*uargs)
    fused = tc.composite_forward(*args)
    assert tc.launch_counts[tc.UNFUSED_KERNEL_NAME] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, fused)
    got, ref = got[0].cpu().numpy(), ref[0].cpu().numpy()
    for plane, tol in ((0, ATOL_RGB), (1, ATOL_RGB), (2, ATOL_RGB), (3, ATOL_DEPTH), (4, ATOL_RGB)):
        np.testing.assert_allclose(got[:, plane], ref[:, plane], atol=tol)
    np.testing.assert_array_equal(got[:, 6], ref[:, 6])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_unfused_backward_kernel_matches_plain_on_card(cuda_device, kind):
    """The unfused backward kernel, map and scatter against the plain
    backward's blocks through the same map and scatter, per row of g_attrs
    at the bars above; its live out-blocks equal bit for bit from run to
    run (no atomics in the kernel)."""
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
    dout = tc.composite_backward_unfused(*bwd)
    dout2 = tc.composite_backward_unfused(*bwd)
    ref_dout = tc.composite_backward_unfused_plain(*bwd)
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
