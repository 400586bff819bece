"""PyTorch port vs the JAX package: projection, binning, compositor, render.

The JAX compositor runs its Pallas kernels in interpret mode, as
tests/test_pallas_composite.py does. On the CPU the port's compositor takes
its plain PyTorch version; the CUDA kernel is held against that plain
version on the card (tests/test_torch_cuda.py, and chip_smoke.py).
Tolerances: rgb/alpha 1e-4 and depth 5e-4, the bars the JAX package holds
its own two compositor backends to (tests/test_pallas_composite.py:47-49);
the Pallas kernel forms its prefix sums with matrix products, the port
sequentially.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatter360_tpu.ops.pallas.composite as pc
from splatter360_tpu.geometry.transforms import build_covariance_sym6 as j_cov6
from splatter360_tpu.models.decoder import render_erp_views as j_render_views
from splatter360_tpu.models.types import Gaussians as JGaussians
from splatter360_tpu.ops.projection import project_erp as j_project
from splatter360_tpu.ops.projection import sh_colors as j_sh_colors
from splatter360_tpu.ops.rasterizer import render_tiled as j_render
from splatter360_tpu.ops.tiling import assign_tiles as j_assign
from splatter360_tpu_torch.models.decoder import render_erp_views as t_render_views
from splatter360_tpu_torch.models.types import Gaussians
from splatter360_tpu_torch.ops.cuda import composite as tc
from splatter360_tpu_torch.ops.projection import Projected
from splatter360_tpu_torch.ops.projection import project_erp as t_project
from splatter360_tpu_torch.ops.rasterizer import render_tiled as t_render
from splatter360_tpu_torch.ops.tiling import assign_tiles as t_assign

torch.set_num_threads(2)
H, W = 64, 256  # 4 x 2 tiles of 16 x 128
ATOL_RGB, ATOL_DEPTH = 1e-4, 5e-4


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pc.pl.pallas_call
    monkeypatch.setattr(pc.pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


def scene(n, sh_degree=2, seed=1):
    """numpy-seeded Gaussians around the origin (bench.py's recipe)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    means = d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(0.5, 6.0, (n, 1))
    q = rng.normal(size=(n, 4))
    covs = j_cov6(jnp.asarray(rng.uniform(0.01, 0.12, (n, 3)), jnp.float32),
                  jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True), jnp.float32))
    sh = 0.3 * rng.normal(size=(n, 3, (sh_degree + 1) ** 2))
    sh[..., 0] += 0.5
    g = dict(means=means, covariances=np.asarray(covs), harmonics=sh,
             opacities=rng.uniform(0.3, 0.95, n))
    return {k: np.asarray(v, np.float32) for k, v in g.items()}


def saturating_scene():
    """tests/test_pallas_composite.py::_saturating_scene, numpy-seeded SH: dense
    opaque blobs over every pixel of a 32x256 image, so tiles saturate and
    the per-tile early exit fires."""
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
    covs = j_cov6(jnp.asarray(scales, jnp.float32), jnp.tile(jnp.array([0.0, 0, 0, 1]), (n, 1)))
    sh = 0.3 * np.random.default_rng(8).normal(size=(n, 3, 9))
    sh[..., 0] += 0.5
    g = dict(means=np.array(means), covariances=np.asarray(covs), harmonics=sh,
             opacities=np.full(n, 0.92))
    return (hh, ww), {k: np.asarray(v, np.float32) for k, v in g.items()}


def pose(seed=2, spread=0.2):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = np.random.default_rng(seed).normal(0, spread, 3)
    return c2w


def tt(x):
    return torch.as_tensor(np.asarray(x))


def test_project_erp():
    g = scene(3000)
    c2w = pose()
    ref = j_project(g["means"], g["covariances"], c2w, (H, W), 0.1, opacities=g["opacities"])
    got = t_project(tt(g["means"]), tt(g["covariances"]), tt(c2w), (H, W), 0.1,
                    opacities=tt(g["opacities"]))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    # pixel coordinates up to W: a few ulps of atan2 at that magnitude
    np.testing.assert_allclose(got.mean2d.numpy()[v], np.asarray(ref.mean2d)[v], atol=1e-3)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), rtol=1e-6)
    np.testing.assert_allclose(got.conic.numpy()[v], np.asarray(ref.conic)[v], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.gate_s.numpy(), np.asarray(ref.gate_s), rtol=1e-6)
    # radii are ceil()ed: an ulp of the covariance may move one by a pixel
    dr = np.abs(got.radius.numpy()[v] - np.asarray(ref.radius)[v])
    assert dr.max() <= 1.0 and (dr > 0).mean() < 1e-3


@pytest.mark.parametrize("caps", ["default", "tight"])
def test_assign_tiles_exact(caps):
    """Given the same Projected, the sorted instance list (real prefix),
    segments and dropped count are identical. 'tight' caps force tier
    overflow and post-sort truncation."""
    g = scene(3000)
    p = j_project(g["means"], g["covariances"], pose(), (H, W), 0.1, opacities=g["opacities"])
    kw = {} if caps == "default" else dict(instance_cap=2048, tier_caps=(64, 32, 8))
    ref = j_assign(p, (H, W), True, **kw)
    got = t_assign(Projected(*(tt(x) for x in p)), (H, W), True, **kw)
    real = np.asarray(ref.tile_ids) < ref.num_tiles_x * ref.num_tiles_y
    assert real.sum() > 1000
    np.testing.assert_array_equal(got.tile_ids.numpy()[real], np.asarray(ref.tile_ids)[real])
    np.testing.assert_array_equal(got.gaussian_idx.numpy()[real], np.asarray(ref.gaussian_idx)[real])
    np.testing.assert_array_equal(got.tile_starts.numpy(), np.asarray(ref.tile_starts))
    np.testing.assert_array_equal(got.tile_counts.numpy(), np.asarray(ref.tile_counts))
    assert int(got.dropped) == int(ref.dropped)
    assert (int(ref.dropped) > 0) == (caps == "tight")


def _fused_inputs(g, shape, c2w):
    """Projection, binning and attribute table as the JAX fused path builds them."""
    n = g["means"].shape[0]
    p = j_project(g["means"], g["covariances"], c2w, shape, 0.1, opacities=g["opacities"])
    asg = j_assign(p, shape, True)
    colors = j_sh_colors(jnp.asarray(g["harmonics"]), jnp.asarray(g["means"]), c2w[:3, 3], 2)
    attrs_p = pc._build_attrs_packed(p.mean2d, p.conic, colors, jnp.asarray(g["opacities"]),
                                     p.depth, p.radius)
    assert pc._use_fused(n)
    return asg, attrs_p, np.asarray(attrs_p).reshape(-1, 16)[:n]


@pytest.mark.parametrize("kind", ["random", "saturating"])
def test_plain_compositor_vs_pallas_fused(kind):
    if kind == "random":
        shape, g = (H, W), scene(3000)
    else:
        shape, g = saturating_scene()
    c2w = np.eye(4, dtype=np.float32)
    asg, attrs_p, attrs = _fused_inputs(g, shape, c2w)
    nty, ntx = asg.num_tiles_y, asg.num_tiles_x
    acc = pc._render_core_fused(
        g["means"].shape[0], attrs_p, asg.gaussian_idx.reshape(-1, 1, 128), asg.tile_starts,
        asg.tile_counts, nty, ntx, float(shape[1]), True)
    ref = np.asarray(acc).reshape(nty * ntx, 8, 2048)
    before = dict(tc.launch_counts)
    got = tc.composite_forward(tt(attrs)[None], tt(asg.gaussian_idx)[None],
                               tt(asg.tile_starts)[None], tt(asg.tile_counts)[None],
                               nty, ntx, float(shape[1]), True)[0].numpy()
    assert tc.launch_counts == before  # the plain version is not a launch
    for plane in (0, 1, 2, 4):  # r g b T
        np.testing.assert_allclose(got[:, plane], ref[:, plane], atol=ATOL_RGB)
    np.testing.assert_allclose(got[:, 3], ref[:, 3], atol=ATOL_DEPTH)
    nproc = got[:, 6, 0]
    starts, counts = np.asarray(asg.tile_starts), np.asarray(asg.tile_counts)
    n_blocks = (starts + counts + 127) // 128 - starts // 128
    if kind == "random":
        np.testing.assert_array_equal(nproc, ref[:, 6, 0])
    else:
        # The Pallas interpreter does not take the kernel's while-loop exit
        # (it walks all n_blocks of every tile); the blocks it walks past the
        # exit add nothing, since every pixel already has T < 1e-4 and the
        # T (1 - alpha) >= 1e-4 gate drops them, so the planes above agree.
        exited = nproc < n_blocks
        assert exited.any(), "the per-tile early exit never fired"
        assert (ref[:, 6, 0] >= nproc).all()
        # a tile stops exactly when every pixel's logT fell below log(1e-4)
        assert (got[exited, 5].max(axis=1) < tc._LOG_T_EPS).all()


def _views(g):
    return (tt(g["means"]), tt(g["covariances"]), tt(g["harmonics"]), tt(g["opacities"]))


def test_render_tiled_vs_jax():
    g = scene(3000)
    c2w = pose()
    ref = j_render(*(jnp.asarray(g[k]) for k in ("means", "covariances", "harmonics", "opacities")),
                   jnp.asarray(c2w), (H, W), camera_kind="erp", backend="pallas",
                   render_depth=True)
    got = t_render(*_views(g), tt(c2w), (H, W), render_depth=True)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color), atol=ATOL_RGB)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha), atol=ATOL_RGB)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=ATOL_DEPTH)
    assert int(got.dropped) == int(ref.dropped)


@pytest.mark.parametrize("mode", ["log", "disparity", "relative_disparity"])
def test_render_tiled_depth_modes_vs_jax(mode):
    """transform_depth's other modes through render_tiled; their values are no
    larger than the metric depths the 5e-4 bar holds."""
    g = scene(3000)
    c2w = pose()
    ref = j_render(*(jnp.asarray(g[k]) for k in ("means", "covariances", "harmonics", "opacities")),
                   jnp.asarray(c2w), (H, W), camera_kind="erp", near=0.1, far=10.0,
                   backend="pallas", render_depth=True, depth_mode=mode)
    got = t_render(*_views(g), tt(c2w), (H, W), near=0.1, far=10.0, render_depth=True,
                   depth_mode=mode)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=ATOL_DEPTH)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha), atol=ATOL_RGB)


def test_render_tiled_narrow_erp_raises():
    """Below two tile columns the per-tile seam re-centring is not exact:
    the kernels' composite_tiles raises for such an ERP view, and
    render_tiled(backend="pallas") composites it with the scan compositor,
    as the JAX package does (tests/test_torch_scan.py holds it to JAX)."""
    from splatter360_tpu_torch.ops import composite_scan as ts
    from splatter360_tpu_torch.ops.rasterizer import batch_inputs

    g = scene(200)
    attrs, asg, wrap_x = batch_inputs(*_views(g), torch.eye(4)[None], (32, 128), 0.1, 100.0)
    with pytest.raises(ValueError, match="2 tiles"):
        tc.composite_tiles(asg, attrs, (32, 128), torch.zeros(3), wrap_x)
    before = ts.scan_counts[ts.SCAN_NAME]
    out = t_render(*_views(g), torch.eye(4), (32, 128))
    assert ts.scan_counts[ts.SCAN_NAME] == before + 1
    assert out.color.shape == (32, 128, 3) and torch.isfinite(out.color).all()


def test_render_erp_views_vs_jax():
    g = scene(2000)
    b, v = 1, 2
    ext = np.stack([pose(3), pose(4)])[None]
    near = np.full((b, v), 0.1, np.float32)
    far = np.full((b, v), 10.0, np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jg = JGaussians(*(jnp.asarray(g[k])[None] for k in ("means", "covariances", "harmonics",
                                                        "opacities")))
    ref = j_render_views(jg, jnp.asarray(ext), near, far, (H, W), background=jnp.asarray(bg),
                         render_depth=True, backend="pallas")
    got = t_render_views(Gaussians(*(x[None] for x in _views(g))), tt(ext), tt(near), tt(far),
                         (H, W), background=tt(bg), render_depth=True)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(ref.color), atol=ATOL_RGB)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha), atol=ATOL_RGB)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=ATOL_DEPTH)
    np.testing.assert_array_equal(got.dropped.numpy(), np.asarray(ref.dropped))
