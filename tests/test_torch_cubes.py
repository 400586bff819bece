"""The port's cube-face (pinhole) render path vs the JAX package: cube rigs,
pinhole and orthographic projection, binning and the compositor at
wrap_x=False, render_cube_views, the dense oracle and a train step with
cube supervision.

The JAX side runs its Pallas kernels in interpret mode; on the CPU the port
takes its plain compositor versions. Inputs are made from seeds with numpy
and fed to both. Bars: rgb/alpha 1e-4, depth 5e-4 and gradients 2e-3 of
max|g|, the bars the JAX package holds its two compositor backends to
(tests/test_pallas_composite.py:44-71).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_render import ATOL_DEPTH, ATOL_RGB, scene, tt
from test_torch_train import (GRAD_TOL, JUMP_TOL, assert_grads_close, keep_grads, lpips_params,
                              step_batch)

import splatter360_tpu.ops.pallas.composite as pc
from splatter360_tpu.geometry import cubemap as jcube
from splatter360_tpu.geometry.transforms import build_covariance_sym6 as j_cov6
from splatter360_tpu.ops import projection as jproj
from splatter360_tpu.ops.rasterizer import render_tiled as j_render
from splatter360_tpu.ops.rasterizer_ref import render_dense as j_dense
from splatter360_tpu.ops.tiling import assign_tiles as j_assign
from splatter360_tpu_torch.geometry import cubemap as tcube
from splatter360_tpu_torch.models.types import Gaussians
from splatter360_tpu_torch.ops import projection as tproj
from splatter360_tpu_torch.ops.cuda import composite as tc
from splatter360_tpu_torch.ops.projection import Projected
from splatter360_tpu_torch.ops.rasterizer import render_tiled as t_render
from splatter360_tpu_torch.ops.rasterizer_ref import render_dense as t_dense
from splatter360_tpu_torch.ops.tiling import assign_tiles as t_assign

torch.set_num_threads(2)
FACE = 32  # test faces: narrower than a 128-pixel tile, so ntx = 1
EDGE_SHAPE = (64, 256)  # a pinhole view two tiles wide
# square pixels on EDGE_SHAPE: fx = fy = 128 px, a 90-degree horizontal FoV
EDGE_INTR = np.array([[0.5, 0, 0.5], [0, 2.0, 0.5], [0, 0, 1]], np.float32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pc.pl, "pallas_call", functools.partial(pc.pl.pallas_call, interpret=True))


def poses(n, seed, spread=0.2):
    """n seeded ERP poses: random rotations, translations N(0, spread)."""
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    c2w[:, :3, :3] = np.stack([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]).transpose(2, 0, 1)
    c2w[:, :3, 3] = rng.normal(0, spread, (n, 3))
    return c2w


def test_cube_rigs_vs_jax():
    """Face poses, intrinsics, rotations, the distance -> z-depth factor and
    zdepth_to_distance; 1e-6."""
    c2w = poses(6, 0).reshape(2, 3, 4, 4)
    close = functools.partial(np.testing.assert_allclose, rtol=1e-6, atol=1e-6)
    got = tcube.cube_face_extrinsics(tt(c2w)).numpy()
    assert got.shape == (2, 3, 6, 4, 4)
    close(got, np.asarray(jcube.cube_face_extrinsics(jnp.asarray(c2w))))
    close(tcube.cube_face_intrinsics().numpy(), np.asarray(jcube.cube_face_intrinsics()))
    close(tcube.cube_face_rotations().numpy(), np.asarray(jcube.cube_face_rotations()))
    close(tcube.erp_distance_to_cube_zdepth_factor(FACE).numpy(),
          np.asarray(jcube.erp_distance_to_cube_zdepth_factor(FACE)))
    z = np.random.default_rng(1).uniform(0.5, 5.0, (6, FACE, 24)).astype(np.float32)
    for intr in ((0.5, 0.5, 0.5, 0.5), (0.6, 0.4, 0.45, 0.55)):
        close(tcube.zdepth_to_distance(tt(z), *intr).numpy(),
              np.asarray(jcube.zdepth_to_distance(jnp.asarray(z), *intr)))


def projection_scene(n=3000, seed=3):
    """Gaussians around the origin with opacities down to below 1/255, and
    some on the near test's edge: camera z just past and just short of
    0.2 near (0.02) for the first face's camera, and behind it."""
    g = scene(n, seed=seed)
    rng = np.random.default_rng(seed)
    k = n // 20
    z = np.concatenate([0.02 + rng.uniform(1e-6, 1e-3, k), 0.02 - rng.uniform(1e-6, 1e-3, k),
                        -rng.uniform(0.1, 3.0, k)])
    g["means"][:3 * k] = np.stack([rng.normal(0, 0.3, 3 * k), rng.normal(0, 0.3, 3 * k), z], -1)
    g["opacities"][-k:] = rng.uniform(0.0, 2.0 / 255.0, k)
    return g


def assert_projected_close(got, ref):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(ref.radius))
    for name in ("mean2d", "conic"):
        np.testing.assert_allclose(getattr(got, name).numpy()[valid],
                                   np.asarray(getattr(ref, name))[valid], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), rtol=1e-5)
    if ref.gate_s is not None:
        np.testing.assert_allclose(got.gate_s.numpy(), np.asarray(ref.gate_s), rtol=1e-6)


@pytest.mark.parametrize("opacity_cull", [True, False])
def test_project_pinhole_vs_jax(opacity_cull):
    """Every face of a cube rig at 32x32 and the 64x256 edge camera, with
    Gaussians behind the camera and on either side of z = 0.2 near."""
    g = projection_scene()
    op = g["opacities"] if opacity_cull else None
    faces = np.asarray(jcube.cube_face_extrinsics(jnp.eye(4)))
    cams = [(c2w, np.asarray(jcube.cube_face_intrinsics()), (FACE, FACE)) for c2w in faces]
    cams.append((np.eye(4, dtype=np.float32), EDGE_INTR, EDGE_SHAPE))
    for c2w, intr, shape in cams:
        ref = jproj.project_pinhole(g["means"], g["covariances"], c2w, intr, shape, 0.1,
                                    opacities=op)
        got = tproj.project_pinhole(tt(g["means"]), tt(g["covariances"]), tt(c2w), tt(intr),
                                    shape, 0.1, opacities=None if op is None else tt(op))
        assert_projected_close(got, ref)
    valid = np.asarray(ref.valid)
    k = g["means"].shape[0] // 20
    assert valid[:k].all() and not valid[k:3 * k].any()


def test_project_ortho_vs_jax():
    g = projection_scene()
    c2w = poses(1, 4)[0]
    for covs in (g["covariances"], full_covs(g["covariances"])):
        ref = jproj.project_ortho(g["means"], covs, c2w, 3.0, (32, 64), 0.1, 5.0)
        got = tproj.project_ortho(tt(g["means"]), tt(covs), tt(c2w), 3.0, (32, 64), 0.1, 5.0)
        assert_projected_close(got, ref)


def full_covs(sym6):
    """[N, 6] sym6 -> [N, 3, 3]."""
    s = sym6
    rows = [[s[:, 0], s[:, 1], s[:, 2]], [s[:, 1], s[:, 3], s[:, 4]], [s[:, 2], s[:, 4], s[:, 5]]]
    return np.stack([np.stack(r, -1) for r in rows], -2)


def edge_scene(n=800, seed=5):
    """Gaussians in front of the identity pinhole camera of EDGE_SHAPE: a
    random field, and splats of 8-20 px radius centred within 6 px of the
    left and right image edges, so that a wrapping compositor would carry
    each onto the other edge. Depths are 6 mm apart, past the resolution of
    the binning's 20-bit depth key (2 mm below 8 m), so the tiled
    compositor walks the true depth order, as the dense oracle does."""
    rng = np.random.default_rng(seed)
    h, w = EDGE_SHAPE
    n_edge = n // 4
    z = rng.permutation(np.linspace(1.0, 6.0, n))
    u = np.concatenate([rng.uniform(-6, 6, n_edge // 2), rng.uniform(w - 7, w + 5, n_edge // 2),
                        rng.uniform(-20, w + 20, n - n_edge)])
    v = rng.uniform(-4, h + 4, n)
    means = np.stack([(u + 0.5 - w / 2) / 128 * z, (v + 0.5 - h / 2) / 128 * z, z], -1)
    scales = rng.uniform(0.01, 0.04, (n, 3)) * z[:, None]
    q = rng.normal(size=(n, 4))
    covs = j_cov6(jnp.asarray(scales, jnp.float32),
                  jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True), jnp.float32))
    sh = 0.3 * rng.normal(size=(n, 3, 9))
    sh[..., 0] += 0.5
    g = dict(means=means, covariances=np.asarray(covs), harmonics=sh,
             opacities=rng.uniform(0.3, 0.95, n))
    return {k: np.asarray(x, np.float32) for k, x in g.items()}


def face_scene():
    """A random scene around the origin, seen by the F face at 32x32."""
    g = scene(800, seed=6)
    return g, np.asarray(jcube.cube_face_extrinsics(jnp.asarray(poses(1, 7)[0])))[0]


def pinhole_case(case):
    """(scene, c2w, intrinsics, shape) of a compositor case."""
    if case == "edge":
        return edge_scene(), np.eye(4, dtype=np.float32), EDGE_INTR, EDGE_SHAPE
    g, c2w = face_scene()
    return g, c2w, np.asarray(jcube.cube_face_intrinsics()), (FACE, FACE)


LEAVES = ("means", "covariances", "harmonics", "opacities")


@pytest.mark.parametrize("case", ["face", "edge"])
def test_assign_tiles_no_wrap_exact(case):
    """Binning at wrap_x=False with the face renderer's cap max(N, 4096):
    the real entries (tile_ids < T), segments and dropped count equal."""
    g, c2w, intr, shape = pinhole_case(case)
    n = g["means"].shape[0]
    p = jproj.project_pinhole(g["means"], g["covariances"], c2w, intr, shape, 0.1,
                              opacities=g["opacities"])
    ref = j_assign(p, shape, False, instance_cap=max(n, 4096))
    got = t_assign(Projected(*(tt(x) for x in p)), shape, False, instance_cap=max(n, 4096))
    real = np.asarray(ref.tile_ids) < ref.num_tiles_x * ref.num_tiles_y
    assert real.sum() > 200
    np.testing.assert_array_equal(got.tile_ids.numpy()[real], np.asarray(ref.tile_ids)[real])
    np.testing.assert_array_equal(got.gaussian_idx.numpy()[real],
                                  np.asarray(ref.gaussian_idx)[real])
    np.testing.assert_array_equal(got.tile_starts.numpy(), np.asarray(ref.tile_starts))
    np.testing.assert_array_equal(got.tile_counts.numpy(), np.asarray(ref.tile_counts))
    assert int(got.dropped) == int(ref.dropped) == 0


def smooth_loss(color, alpha, depth):
    return ((color - 0.5) ** 2).sum() + 0.1 * alpha.sum() + 0.01 * depth.sum()


@pytest.mark.parametrize("path", ["fused", "unfused"])
@pytest.mark.parametrize("case", ["face", "edge"])
def test_pinhole_render_vs_pallas(interpret, monkeypatch, case, path):
    """render_tiled(camera_kind="pinhole") forward and backward, the port's
    plain compositor at wrap_x=False against Pallas in interpret mode:
    colour/alpha 1e-4, depth 5e-4, gradients of a colour MSE + alpha +
    depth loss to means, covariances, harmonics and opacities at 2e-3 of
    max|g|. "face": 32x32, one tile column with off-image pixels; "edge":
    64x256, splats across both side edges."""
    if path == "unfused":
        monkeypatch.setattr(pc, "_FUSED_PACK", False)
        monkeypatch.setattr(tc, "FUSED_TABLE_BUDGET", 0)
    g, c2w, intr, shape = pinhole_case(case)

    def j_loss(*x):
        out = j_render(*x, jnp.asarray(c2w), shape, camera_kind="pinhole",
                       intrinsics=jnp.asarray(intr), backend="pallas", render_depth=True)
        return smooth_loss(out.color, out.alpha, out.depth), (out.color, out.alpha, out.depth,
                                                              out.dropped)

    (_, ref), grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(g[k]) for k in LEAVES))
    x = [torch.tensor(g[k], requires_grad=True) for k in LEAVES]
    before = dict(tc.launch_counts)
    out = t_render(*x, tt(c2w), shape, camera_kind="pinhole", intrinsics=tt(intr),
                   render_depth=True)
    smooth_loss(out.color, out.alpha, out.depth).backward()
    assert tc.launch_counts == before  # CPU tensors take the plain versions
    for name, atol, want in zip(("color", "alpha", "depth"), (ATOL_RGB, ATOL_RGB, ATOL_DEPTH),
                                ref):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(), np.asarray(want),
                                   atol=atol, err_msg=name)
    assert float(out.alpha.max()) > 0.5
    assert int(out.dropped) == int(ref[3]) == 0
    assert_grads_close([np.asarray(a) for a in grads], [a.grad.numpy() for a in x], LEAVES)


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_off_image_cotangents_are_zero(monkeypatch, path):
    """A 32x32 face fills a third of its 128-pixel tile column: compose_planes
    crops the rest, so the cotangent planes reaching the backward are exact
    zeros on the off-image pixels (the forward composites them all the
    same, and counts them in the tile's exit test)."""
    if path == "unfused":
        monkeypatch.setattr(tc, "FUSED_TABLE_BUDGET", 0)
    name = "composite_backward" if path == "fused" else "composite_backward_unfused"
    seen = []
    orig = getattr(tc, name)

    def spy(*a, **kw):
        seen.append(a[4] if path == "fused" else a[3])
        return orig(*a, **kw)

    monkeypatch.setattr(tc, name, spy)
    g, c2w, intr, shape = pinhole_case("face")
    x = [torch.tensor(g[k], requires_grad=True) for k in LEAVES]
    out = t_render(*x, tt(c2w), shape, camera_kind="pinhole", intrinsics=tt(intr),
                   render_depth=True)
    smooth_loss(out.color, out.alpha, out.depth).backward()
    (g_planes,) = seen
    cols = g_planes[0, :, :5].reshape(2, 5, 16, 128)
    assert bool((cols[..., :FACE] != 0).all())
    assert not bool(cols[..., FACE:].any())


def test_pinhole_edges_do_not_wrap():
    """On the 64x256 edge scene the compositor with wrap_x=True carries the
    splats across the side edges and the pinhole render does not: the two
    differ in the edge columns, and the pinhole render equals the dense
    oracle (which never wraps a pinhole view) at the compositor bars."""
    g, c2w, intr, shape = pinhole_case("edge")
    x = [tt(g[k]) for k in LEAVES]
    got = t_render(*x, tt(c2w), shape, camera_kind="pinhole", intrinsics=tt(intr),
                   render_depth=True)
    dense = t_dense(*x, tt(c2w), shape, camera_kind="pinhole", intrinsics=tt(intr),
                    render_depth=True)
    for name, atol in (("color", ATOL_RGB), ("alpha", ATOL_RGB), ("depth", ATOL_DEPTH)):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(dense, name).numpy(),
                                   atol=atol, err_msg=name)

    proj = tproj.project_pinhole(*x[:2], tt(c2w), tt(intr), shape, 0.1, opacities=x[3])
    colors = tproj.sh_colors(x[2], x[0], tt(c2w)[:3, 3], 2)
    attrs = tc.build_attrs(proj.mean2d, proj.conic, colors, x[3], proj.depth, proj.radius)[None]
    images = {}
    for wrap in (False, True):
        asg = t_assign(proj, shape, wrap, instance_cap=4096)
        images[wrap] = tc.composite_tiles([asg], attrs, shape, torch.zeros(3), wrap)[1][0]
    np.testing.assert_allclose(images[False].numpy(), got.alpha.numpy(), atol=1e-6)
    diff = (images[True] - images[False]).abs().amax(dim=0)
    assert float(diff[:12].max()) > 0.1 and float(diff[-12:].max()) > 0.1  # the edges differ
    assert float(diff[64:192].max()) < 1e-6  # the middle does not


def test_render_cube_views_vs_jax(interpret):
    """decoder.render_cube_views (all 12 faces of 2 target views in one
    compositor launch) against JAX's, with depth and a background; dropped
    equal per face."""
    from splatter360_tpu.models.decoder import render_cube_views as j_cubes
    from splatter360_tpu.models.types import Gaussians as JGaussians
    from splatter360_tpu_torch.models.decoder import render_cube_views as t_cubes

    g = scene(1500, seed=8)
    ext = poses(2, 9)[None]
    near, far = np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = j_cubes(JGaussians(*(jnp.asarray(g[k])[None] for k in LEAVES)), jnp.asarray(ext),
                  near, far, (FACE, FACE), background=jnp.asarray(bg), render_depth=True)
    before = dict(tc.launch_counts)
    got = t_cubes(Gaussians(*(tt(g[k])[None] for k in LEAVES)), tt(ext), tt(near), tt(far),
                  (FACE, FACE), background=tt(bg), render_depth=True)
    assert tc.launch_counts == before
    assert tuple(got.color.shape) == (1, 2, 6, FACE, FACE, 3)
    assert tuple(got.depth.shape) == tuple(got.alpha.shape) == (1, 2, 6, FACE, FACE)
    np.testing.assert_array_equal(got.dropped.numpy(), np.asarray(ref.dropped))
    for name, atol in (("color", ATOL_RGB), ("alpha", ATOL_RGB), ("depth", ATOL_DEPTH)):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=atol, err_msg=name)
    assert float(got.alpha.min()) < 0.5 < float(got.alpha.max())


def test_serve_render_cube_views(monkeypatch):
    """serve.render_cube_views goes to the card unless told device="cpu",
    and raises without one; on the CPU it is decoder.render_cube_views at
    H // 2 faces under no_grad, with the JAX shapes."""
    from splatter360_tpu_torch import serve
    from splatter360_tpu_torch.models.decoder import render_cube_views as t_cubes

    g = scene(500, seed=14)
    gs = Gaussians(*(g[k][None] for k in LEAVES))
    ext = poses(2, 15)[None]
    near, far = np.full((1, 2), 0.1, np.float32), np.full((1, 2), 10.0, np.float32)
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.render_cube_views(gs, ext, near, far, FACE)
    got = serve.render_cube_views(gs, ext, near, far, FACE, render_depth=True, device="cpu")
    want = t_cubes(Gaussians(*(tt(x) for x in gs)), tt(ext), tt(near), tt(far), (FACE, FACE),
                   render_depth=True)
    assert tuple(got.color.shape) == (1, 2, 6, FACE, FACE, 3)
    assert tuple(got.dropped.shape) == (1, 2, 6) and got.dropped.dtype == torch.int32
    for name in ("color", "depth", "alpha", "dropped"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not got.color.requires_grad


def test_remat_faces_same_values():
    """remat_faces (a checkpointed launch per target view) gives the one
    launch's images and gradients; grouping moves only the spans' last
    bits, so at the compositor and gradient bars."""
    from splatter360_tpu_torch.models.decoder import render_cube_views as t_cubes

    g = scene(1500, seed=10)
    ext = tt(poses(2, 11)[None])
    near, far = torch.full((1, 2), 0.1), torch.full((1, 2), 10.0)
    outs, grads = [], []
    for remat in (False, True):
        x = [torch.tensor(g[k])[None].requires_grad_(True) for k in LEAVES]
        out = t_cubes(Gaussians(*x), ext, near, far, (FACE, FACE), render_depth=True,
                      remat_faces=remat)
        smooth_loss(out.color, out.alpha, out.depth).backward()
        outs.append(out)
        grads.append([a.grad[0].numpy() for a in x])
    for name, atol in (("color", ATOL_RGB), ("alpha", ATOL_RGB), ("depth", ATOL_DEPTH)):
        np.testing.assert_allclose(getattr(outs[1], name).detach().numpy(),
                                   getattr(outs[0], name).detach().numpy(), atol=atol)
    np.testing.assert_array_equal(outs[1].dropped.numpy(), outs[0].dropped.numpy())
    assert_grads_close(grads[0], grads[1], LEAVES)


@pytest.mark.parametrize("kind", ["erp", "pinhole", "ortho"])
def test_render_dense_vs_jax(kind):
    """The dense oracle on each camera: 1e-5 (both walk the same sorted
    Gaussians in the same order; exp and the sums round alike)."""
    g = scene(300, seed=12)
    c2w = poses(1, 13)[0]
    shape = {"erp": (16, 64), "pinhole": (24, 24), "ortho": (16, 32)}[kind]
    kw = dict(camera_kind=kind, near=0.1, far=10.0, render_depth=True)
    if kind == "pinhole":
        kw["intrinsics"] = np.asarray(jcube.cube_face_intrinsics())
    if kind == "ortho":
        kw["ortho_extent"] = 6.0
    ref = j_dense(*(jnp.asarray(g[k]) for k in LEAVES), jnp.asarray(c2w), shape,
                  **{k: jnp.asarray(v) if k == "intrinsics" else v for k, v in kw.items()})
    got = t_dense(*(tt(g[k]) for k in LEAVES), tt(c2w), shape,
                  **{k: tt(v) if k == "intrinsics" else v for k, v in kw.items()})
    for name in ("color", "alpha", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-5, err_msg=name)
    assert float(got.alpha.max()) > 0.3


def test_train_config_defaults_agree():
    """TrainConfig() names the same step in both packages: cube supervision
    at H // 2 faces, with the JAX remat default."""
    from splatter360_tpu.train.state import TrainConfig as JTrainConfig
    from splatter360_tpu_torch.train.state import TrainConfig

    ours, theirs = TrainConfig(), JTrainConfig()
    shared = {f.name for f in dataclasses.fields(TrainConfig)} & {
        f.name for f in dataclasses.fields(JTrainConfig)}
    assert {"supervision", "cube_face_size", "remat_faces"} <= shared
    for name in shared - {"optimizer", "loss"}:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.supervision == "cubes"


def jax_cube_step(batch):
    """One JAX make_train_step(supervision="cubes") on the tiny config of
    tests/test_torch_train.py, seeded random params, Pallas in interpret
    mode, vmapped faces (the quickest to compile; sequential_faces and
    remat_faces give the same values)."""
    from test_torch_serve import ENC_KW, rand_params

    from splatter360_tpu.models.adapter import GaussianAdapterConfig as JAdapterConfig
    from splatter360_tpu.models.encoder import EncoderConfig as JEncoderConfig
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train import state as js
    from splatter360_tpu.train.losses import LossConfig as JLossConfig
    from splatter360_tpu.train.lpips_jax import LPIPS as JLPIPS

    ctx = batch["context"]
    jcfg = JEncoderConfig(gaussian_adapter=JAdapterConfig(sh_degree=1), **ENC_KW)
    jm = JEncoder(jcfg)
    face = ctx["image_sphere"].shape[2] // 2
    cubes = js._context_cubes(jnp.asarray(ctx["image_sphere"]), face)
    params = rand_params(jm, ctx["image_sphere"], cubes, ctx["extrinsics_sphere"], ctx["near"],
                         ctx["far"], 0)
    tcfg = js.TrainConfig(optimizer=js.OptimizerConfig(max_steps=100),
                          loss=JLossConfig(lpips_weight=0.05, depth_weight=0.1),
                          supervision="cubes", sequential_faces=False, render_backend="pallas")
    tx = keep_grads(js.make_optimizer(tcfg.optimizer))
    lp = lpips_params()
    state = js.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                          lpips_params=lp, tx=tx, apply_fn=jm.apply, lpips_apply_fn=JLPIPS().apply)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pc.pl, "pallas_call", functools.partial(pc.pl.pallas_call, interpret=True))
        s1, m1 = jax.jit(js.make_train_step(jcfg, tcfg))(state, batch)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(params=to_np(params), lpips=to_np(lp), metrics=to_np(m1),
                grads=to_np(s1.opt_state[1]))


def port_cube_state(ref, state_dict=None):
    """The port's train state with the JAX run's config (TrainConfig's
    default supervision, "cubes"), LPIPS and (unless `state_dict` is given)
    encoder params, on the CPU."""
    from test_torch_serve import ENC_KW

    from splatter360_tpu_torch.convert import lpips_state_from_flax, torch_state_from_flax
    from splatter360_tpu_torch.models.adapter import GaussianAdapterConfig
    from splatter360_tpu_torch.models.encoder import EncoderConfig
    from splatter360_tpu_torch.train.losses import LossConfig
    from splatter360_tpu_torch.train.state import OptimizerConfig, TrainConfig, create_train_state

    cfg = EncoderConfig(gaussian_adapter=GaussianAdapterConfig(sh_degree=1), **ENC_KW)
    tcfg = TrainConfig(optimizer=OptimizerConfig(max_steps=100),
                       loss=LossConfig(lpips_weight=0.05, depth_weight=0.1), remat_faces=False)
    return create_train_state(cfg, tcfg, device="cpu",
                              state_dict=state_dict or torch_state_from_flax(ref["params"]),
                              lpips_state=lpips_state_from_flax(ref["lpips"]))


def test_cube_train_step_vs_jax():
    """One port train step with TrainConfig(supervision="cubes") (the 12
    32x32 faces of step_batch's 2 target views, plain compositor on the CPU)
    from the same params and batch as the JAX step: every metric at 1e-4
    relative, each gradient leaf within 2e-3 of the global max|g| except
    the one JUMP_TOL names, the ERP step's: it sits on a jump of the
    function (ROADMAP Queue 3), and running this file as a script moves it
    by its distance to JAX under a 1e-6 perturbation of the params."""
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train.state import train_step

    batch = step_batch()
    ref = jax_cube_step(batch)
    state = port_cube_state(ref)
    assert state.train_cfg.supervision == "cubes"
    grads = {}

    def keep(stage):
        if stage == "backward":
            grads.update({k: p.grad.clone() for k, p in state.model.named_parameters()})

    before = dict(tc.launch_counts)
    got = train_step(state, batch, on_stage=keep)
    assert tc.launch_counts == before
    assert set(got) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, err_msg=k)
    ref_g = torch_state_from_flax(ref["grads"])
    assert set(ref_g) == set(grads)
    scale = max(float(g.abs().max()) for g in ref_g.values())
    rows = sorted(((float((grads[k] - g).abs().max()) / scale, k) for k, g in ref_g.items()),
                  reverse=True)
    print("cube step gradient, leaves farthest from JAX (in max|g|):",
          [(f"{d:.2e}", k) for d, k in rows[:3]])
    for d, k in rows:
        assert d <= JUMP_TOL.get(k, GRAD_TOL), (k, d)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_cubes.py: how far
    # the port's cube-step gradient moves per leaf when its params are scaled
    # by 1 + 1e-6 N(0, 1) (two noise seeds), beside each leaf's distance to
    # JAX and the cosine between the two differences (~3 min).
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train.state import compute_losses

    batch = step_batch()
    ref = jax_cube_step(batch)
    params = torch_state_from_flax(ref["params"])
    ref_g = torch_state_from_flax(ref["grads"])
    scale = max(float(g.abs().max()) for g in ref_g.values())

    def port_grads(state_dict):
        state = port_cube_state(ref, state_dict)
        compute_losses(state, batch)[0].backward()
        return {k: p.grad for k, p in state.model.named_parameters()}

    base = port_grads(params)
    to_jax = {k: ref_g[k] - g for k, g in base.items()}
    for seed in (10, 11):
        gen = torch.Generator().manual_seed(seed)
        moved = port_grads({k: v * (1 + 1e-6 * torch.randn(v.shape, generator=gen))
                            for k, v in params.items()})
        rows = []
        for k, g in base.items():
            jump, dist = moved[k] - g, to_jax[k]
            cos = float((jump * dist).sum() / (jump.norm() * dist.norm()).clamp(min=1e-30))
            rows.append((float(jump.abs().max()) / scale, float(dist.abs().max()) / scale, cos, k))
        print(f"noise seed {seed}, the leaves that move most and the farthest from JAX (jump, "
              f"distance to JAX, cosine, in max|g|):")
        rows.sort(reverse=True)
        far = max(rows, key=lambda r: r[1])
        for jump, dist, cos, k in rows[:4] + [r for r in rows[4:] if r is far]:
            print(f"  {jump:.3e} {dist:.3e} {cos:+.3f} {k}")
