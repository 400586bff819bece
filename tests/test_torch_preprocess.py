"""The port's procedural dataset generation (splatter360_tpu_torch/preprocess/)
against the JAX package's, and the batched dense compositor against the walk
over one Gaussian at a time it replaced.

Worlds and trajectories are host numpy in both packages and held bit for bit;
rendered frames at the forward bars (colour and alpha 1e-4, depth 5e-4), with
the rare pixel whose weight gate flips on the last bit of exp bounded by its
share of pixels; stored scenes within 1 LSB and 1 mm on 99.9% of pixels.
"""

from __future__ import annotations

import importlib.util
import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from splatter360_tpu.data import scene_io as j_scene_io
from splatter360_tpu.preprocess import generate as j_generate
from splatter360_tpu.preprocess import scene_builder as j_builder
from splatter360_tpu.preprocess import trajectory as j_trajectory
from splatter360_tpu.preprocess import validate as j_validate
from splatter360_tpu_torch import preprocess as pre
from splatter360_tpu_torch.data import scene_io
from splatter360_tpu_torch.geometry.cubemap import cube_to_erp_grid
from splatter360_tpu_torch.ops import rasterizer_ref as rr
from splatter360_tpu_torch.ops.projection import project_erp, project_ortho, project_pinhole
from splatter360_tpu_torch.preprocess import __main__ as cli
from splatter360_tpu_torch.preprocess.generate import _render_frames

REPO = Path(__file__).resolve().parent.parent
# the forward bars between the JAX package's two compositor backends
# (tests/test_pallas_composite.py:47-49)
ATOL_RGB, ATOL_DEPTH = 1e-4, 5e-4
# a pixel past a bar is a gate flip (the last bit of exp or atan2 moves one
# alpha across 1/255 or one T across 1e-4); at most this share of pixels
FLIP_SHARE = 1e-3
SHAPE = (32, 64)
WORLD = dict(seed=3, spacing=0.25, sh_degree=1)  # 2,382 Gaussians


def walk_one_at_a_time(proj, colors, opacities, image_shape, background, wrap_x,
                       depth_vals):
    """The dense compositor as it was before it went in chunks: one step of
    full-image tensor ops a sorted Gaussian."""
    h, w = image_shape
    order = torch.argsort(torch.where(proj.valid, proj.depth,
                                      torch.full_like(proj.depth, math.inf)), stable=True)
    mean2d, conic, col = proj.mean2d[order], proj.conic[order], colors[order]
    op = torch.where(proj.valid, opacities, torch.zeros_like(opacities))[order]
    dep, rad = depth_vals[order], proj.radius[order]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=mean2d.dtype),
                            torch.arange(w, dtype=mean2d.dtype), indexing="ij")
    rgb = torch.zeros((h, w, col.shape[-1]))
    trans, dacc = torch.ones((h, w)), torch.zeros((h, w))
    for m, cn, c, o, d, r in zip(mean2d, conic, col, op, dep, rad):
        dx = xx - m[0]
        if wrap_x:
            dx = dx - w * torch.round(dx / w)
        dy = yy - m[1]
        power = -0.5 * (cn[0] * dx * dx + cn[2] * dy * dy) - cn[1] * dx * dy
        alpha = torch.clamp(o * torch.exp(power), max=0.99)
        inside = (torch.abs(dx) <= r[0]) & (torch.abs(dy) <= r[1])
        alpha = torch.where(inside & (power > -4.5) & (power <= 0.0) & (alpha >= 1.0 / 255.0),
                            alpha, torch.zeros_like(alpha))
        trans_new = trans * (1.0 - alpha)
        weight = torch.where(trans_new >= 1e-4, alpha * trans, torch.zeros_like(alpha))
        rgb = rgb + weight[..., None] * c
        dacc = dacc + weight * d
        trans = trans_new
    return rgb + trans[..., None] * background, trans, dacc


def gaussians_with_a_stack(seed, n):
    """n random Gaussians in front of the camera, and 8 opaque ones stacked
    on the view axis, 1 cm apart: their pixels' T falls past 1e-4 after the
    fourth or fifth of them."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1.5, (n + 8, 3))
    means[:, 2] = np.abs(means[:, 2]) + 1.5
    means[n:] = [[0.0, 0.0, 2.0 + 0.01 * i] for i in range(8)]
    a = rng.normal(0, 0.15, (n + 8, 3, 3))
    cov = a @ a.transpose(0, 2, 1) + 0.01 * np.eye(3)
    cov[n:] = 0.05 * np.eye(3)
    opac = rng.uniform(0.3, 1.0, n + 8)
    opac[n:] = 0.9
    cols = rng.uniform(0, 1, (n + 8, 3))
    return [torch.tensor(x, dtype=torch.float32) for x in (means, cov, cols, opac)]


def chunks_of(monkeypatch, k, shape):
    """composite_dense's chunks on the CPU at k Gaussians (None: the default)."""
    if k is not None:
        monkeypatch.setattr(rr, "HOST_CHUNK_BYTES", k * 4 * shape[0] * shape[1])


CHUNKS = {"one chunk (N below K)": None, "K = 7 (N not a multiple)": 7}


@pytest.mark.parametrize("kind", ["erp", "pinhole", "ortho"])
def test_batched_composite_is_the_walk_bit_for_bit(kind, monkeypatch):
    means, cov, cols, opac = gaussians_with_a_stack(0, 300)
    c2w = torch.eye(4)
    shape = {"erp": (32, 64), "pinhole": (24, 24), "ortho": (24, 32)}[kind]
    if kind == "erp":
        proj = project_erp(means, cov, c2w, shape, 0.1)
    elif kind == "pinhole":
        intr = torch.tensor([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5], [0.0, 0.0, 1.0]])
        proj = project_pinhole(means, cov, c2w, intr, shape, 0.1)
    else:
        proj = project_ortho(means, cov, c2w, 6.0, shape, 0.1, 10.0)
    bg = torch.tensor([0.1, 0.2, 0.3])
    ref = walk_one_at_a_time(proj, cols, opac, shape, bg, kind == "erp", proj.depth)
    # the stack's pixel: T falls past 1e-4 there, inside the default's one
    # chunk, and wherever the chunks of 7 cut the stack
    centre = {"erp": (16, 32), "pinhole": (12, 12), "ortho": (12, 16)}[kind]
    assert float(ref[1][centre]) < 1e-4
    for label, chunk in CHUNKS.items():
        chunks_of(monkeypatch, chunk, shape)
        got = rr.composite_dense(proj, cols, opac, shape, bg, kind == "erp", True,
                                 depth_vals=proj.depth)
        for name, a, b in zip(("colour", "transmittance", "depth"), got, ref):
            assert torch.equal(a, b), (label, name, float((a - b).abs().max()))


def test_batched_composite_gradients_follow_the_walk(monkeypatch):
    """Autograd through the chunks (scatter and gather) gives the walk's
    gradients, up to the order of their sums."""
    means, cov, cols, opac = gaussians_with_a_stack(1, 120)
    proj = project_erp(means, cov, torch.eye(4), (16, 32), 0.1)
    cot = torch.tensor(np.random.default_rng(2).normal(size=(16, 32, 3)), dtype=torch.float32)
    chunks_of(monkeypatch, 16, (16, 32))
    grads = []
    for fn in (lambda c, o: walk_one_at_a_time(proj, c, o, (16, 32), torch.zeros(3), True,
                                               proj.depth),
               lambda c, o: rr.composite_dense(proj, c, o, (16, 32), torch.zeros(3), True, True,
                                               depth_vals=proj.depth)):
        c, o = cols.clone().requires_grad_(), opac.clone().requires_grad_()
        rgb, trans, dacc = fn(c, o)
        ((rgb * cot).sum() + dacc.sum() + trans.sum()).backward()
        grads.append((c.grad, o.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(a.abs().max()))


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=1, n_panels=2),
                                dict(seed=2, scale_jitter=1.5, n_furniture=6)],
                         ids=["seed0", "panels", "jitter"])
def test_room_world_vs_jax(kw):
    kw = dict(spacing=0.3, sh_degree=2, **kw)
    ref, got = j_builder.build_room_world(**kw), pre.build_room_world(**kw)
    assert got._fields == ref._fields
    for name, a, b in zip(got._fields, got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.fixture(scope="module")
def world():
    return pre.build_room_world(**WORLD)


def test_trajectory_vs_jax(world):
    for seed, n in ((1, 24), (7, 5)):
        ref = j_trajectory.sample_trajectory(world, n, seed=seed)
        got = pre.sample_trajectory(world, n, seed=seed)
        assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


def face_sources(h, w, face_w):
    """The 4 face pixels (face, row, col) each ERP pixel of the stitch reads,
    border-clamped as ops/resample.bilinear_sample_3d_faces clamps them."""
    face_idx, coords = cube_to_erp_grid(face_w, h, w)
    x0, y0 = np.floor(coords[..., 0]).astype(int), np.floor(coords[..., 1]).astype(int)
    return {(y, x): {(int(face_idx[y, x]), min(max(r, 0), face_w - 1), min(max(c, 0), face_w - 1))
                     for r in (y0[y, x], y0[y, x] + 1) for c in (x0[y, x], x0[y, x] + 1)}
            for y in range(h) for x in range(w)}


def assert_frames_close(got, ref, via_cubes):
    """colour and alpha at 1e-4, expected depth at 5e-4. Past the bars only
    gate flips: on a direct render at most FLIP_SHARE of the pixels; on a
    stitched one the pixels that read at most FLIP_SHARE of the face pixels
    (one face pixel's flip reaches every ERP pixel whose bilinear footprint
    holds it, 6 near the back seam at 32x64)."""
    h, w = got[0][2].shape
    sources = face_sources(h, w, h // 2) if via_cubes else None
    for (gc, gd, ga), (rc, rd, ra) in zip(got, ref):
        bad = np.zeros((h, w), bool)
        for name, a, b, tol in (("colour", gc, rc, ATOL_RGB), ("depth", gd, rd, ATOL_DEPTH),
                                ("alpha", ga, ra, ATOL_RGB)):
            assert a.shape == b.shape and a.dtype == np.float32, name
            past = np.abs(a - np.asarray(b)) > tol
            bad |= past.any(-1) if past.ndim == 3 else past
        if not via_cubes:
            assert bad.mean() <= FLIP_SHARE, np.argwhere(bad).tolist()
            continue
        # the fewest face pixels whose readers cover every pixel past a bar
        allowed = math.ceil(FLIP_SHARE * 6 * (h // 2) ** 2)
        reads = [sources[tuple(p)] for p in np.argwhere(bad)]
        candidates = sorted(set().union(*reads))
        assert not reads or any(
            all(r & set(pick) for r in reads)
            for k in range(1, allowed + 1) for pick in itertools.combinations(candidates, k)), \
            np.argwhere(bad).tolist()


@pytest.mark.parametrize("via_cubes", [False, True], ids=["direct", "via_cubes"])
def test_render_frames_vs_jax(world, via_cubes):
    poses = pre.sample_trajectory(world, 2, seed=2)
    ref = j_generate._render_frames(world, poses, SHAPE, via_cubes=via_cubes, far=30.0)
    got = _render_frames(world, poses, SHAPE, via_cubes, 30.0, device="cpu")
    assert len(got) == len(ref) == 2
    assert_frames_close(got, ref, via_cubes)
    assert min(float(a.mean()) for _, _, a in got) > 0.9  # a closed room


GEN = dict(n_frames=6, image_shape=SHAPE, seed=5, spacing=0.25, sh_degree=1)


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """One scene written by each package from the same arguments."""
    root = tmp_path_factory.mktemp("gen")
    ref = j_generate.generate_scene(root / "jax", "train", "proc0", **GEN)
    got = pre.generate_scene(root / "torch", "train", "proc0", device="cpu", **GEN)
    return root, ref, got


def assert_scenes_agree(got, ref):
    """RGB u8 equal on 99.9% of pixels and within 1 LSB elsewhere, depth
    within 1 mm on 99.9%, poses equal."""
    assert got["rgb"].shape == ref["rgb"].shape and got["rgb"].dtype == np.uint8
    lsb = np.abs(got["rgb"].astype(int) - ref["rgb"].astype(int))
    assert lsb.max() <= 1 and (lsb == 0).mean() >= 0.999, (lsb.max(), (lsb > 0).mean())
    mm = np.abs(got["depth_m"] - ref["depth_m"]) * 1000.0
    assert (mm <= 1.0 + 1e-3).mean() >= 0.999, float(mm.max())
    np.testing.assert_array_equal(got["poses"], ref["poses"])


def test_generate_scene_vs_jax(stored):
    root, ref, got = stored
    assert got == ref
    assert scene_io.list_scenes(root / "torch", "train") == ["proc0"]
    ours = scene_io.load_scene(root / "torch", "train", "proc0")
    theirs = j_scene_io.load_scene(root / "jax", "train", "proc0")
    assert_scenes_agree(ours, theirs)
    valid = ours["depth_m"] > 0  # a closed room: essentially no holes
    assert valid.mean() > 0.97 and 0.1 < ours["depth_m"][valid].min()


def test_scene_consistency_vs_jax(stored):
    """The port's checker on the JAX package's stored scene, and JAX's on the
    same file, to 1e-6; the JAX test's corrupted depth collapses coverage."""
    root = stored[0]
    for n_pairs, seed in ((6, 0), (4, 3)):
        got = pre.check_scene_consistency(root / "jax", "train", "proc0", n_pairs=n_pairs,
                                          seed=seed)
        ref = j_validate.check_scene_consistency(root / "jax", "train", "proc0",
                                                 n_pairs=n_pairs, seed=seed)
        assert got.keys() == ref.keys() and got["n_pairs"] == n_pairs
        for k in ("color_mae", "depth_absrel", "coverage"):
            assert abs(got[k] - ref[k]) <= 1e-6, (k, got[k], ref[k])
    assert got["coverage"] > 0.1 and got["depth_absrel"] < 0.05
    data = scene_io.load_scene(root / "jax", "train", "proc0")
    scale = np.where(np.arange(data["depth_m"].shape[0]) % 2 == 0, 1.0, 1.6)
    bad = (data["depth_m"] * scale[:, None, None] * 1000).astype(np.uint16)
    scene_io.save_scene(root / "jax", "train", "bad0", data["rgb"], bad, data["poses"])
    worse = pre.check_scene_consistency(root / "jax", "train", "bad0", n_pairs=4, seed=3)
    assert worse["coverage"] < got["coverage"] * 0.5


def test_cli_vs_generate_dataset_script(tmp_path, monkeypatch, capsys):
    """python -m splatter360_tpu_torch.preprocess against
    scripts/generate_dataset.py: the same scenes, names and splits."""
    args = ["1", "1", "--frames", "4", "--shape", "32x64", "--spacing", "0.3", "--seed", "2",
            "--validate"]
    spec = importlib.util.spec_from_file_location("generate_dataset",
                                                  REPO / "scripts" / "generate_dataset.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["generate_dataset.py", str(tmp_path / "jax"), *args])
    script.main()
    infos = cli.main([str(tmp_path / "torch"), *args, "--device", "cpu"])
    assert [(i["scene"], i["n_frames"]) for i in infos] == [("proc00000", 4), ("proc10000", 4)]
    assert all(i["consistency"]["coverage"] > 0.05 for i in infos)
    for split, scene in (("train", "proc00000"), ("test", "proc10000")):
        assert scene_io.list_scenes(tmp_path / "torch", split) == [scene]
        assert_scenes_agree(scene_io.load_scene(tmp_path / "torch", split, scene),
                            j_scene_io.load_scene(tmp_path / "jax", split, scene))
    printed = capsys.readouterr().out
    assert "train consistency" in printed and "test consistency" in printed


def test_generation_needs_the_card_unless_told(tmp_path, monkeypatch, world):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pre.generate_scene(tmp_path, n_frames=2, image_shape=(8, 16), spacing=0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(tmp_path), "1", "0", "--frames", "2", "--shape", "8x16"])
    with pytest.raises(RuntimeError, match="CUDA"):
        _render_frames(world, np.eye(4, dtype=np.float32)[None], (8, 16), False, 30.0)
    assert not (tmp_path / "train").exists()
