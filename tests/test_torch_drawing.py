"""The port's figures and .ply export (utils/drawing.py, utils/ply_export.py)
against the JAX package's on the same inputs.

Every case of the JAX package's tests/test_drawing.py runs through both
packages, with its own assertions on the port's output; the images are
equal bit for bit below the panel banners, whose font is the port's own
(utils/image_io.add_label). render_projections is held at the forward bar
(1e-4) without labels, and the .ply files byte for byte.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from splatter360_tpu.utils import drawing as j_drawing
from splatter360_tpu.utils.ply_export import export_ply as j_export_ply
from splatter360_tpu_torch.utils import drawing
from splatter360_tpu_torch.utils.ply_export import export_ply

BANNER = 18  # add_label's banner rows above a labelled panel
ATOL_RGB = 1e-4


def lines_cover_segment(m):
    out = m.draw_lines(np.zeros((32, 64, 3), np.float32), [[4, 16]], [[60, 16]],
                       [[1.0, 0.0, 0.0]], width=3)
    assert out[16, 32, 0] > 0.9 and out[16, 32, 1] < 0.1
    assert np.all(out[2, :, :] == 0.0)
    assert out.min() >= 0.0 and out.max() <= 1.0
    return [out]


def points_disc(m):
    out = m.draw_points(np.zeros((16, 32, 3), np.float32), [[16, 8]], [[0.0, 1.0, 0.0]],
                        radius=3)
    assert out[8, 16, 1] > 0.9 and np.all(out[:, 28:, :] == 0.0)
    return [out]


def lines_cap_behavior(m):
    img = np.zeros((16, 32, 3), np.float32)
    args = ([[10, 8]], [[22, 8]], [[1.0, 1.0, 1.0]])
    butt = m.draw_lines(img, *args, width=4, cap="butt")
    square = m.draw_lines(img, *args, width=4, cap="square")
    rnd = m.draw_lines(img, *args, width=4, cap="round")
    assert butt[8, 23, 0] == 0.0
    assert rnd[8, 23, 0] > 0.5 and square[8, 23, 0] > 0.5
    assert square[9, 23, 0] > rnd[9, 23, 0]
    assert butt[8, 16, 0] > 0.9 and rnd[8, 16, 0] > 0.9
    return [butt, square, rnd]


def lines_broadcast_from_colors(m):
    out = m.draw_lines(np.zeros((16, 32, 3), np.float32), [[4, 8]], [[28, 8]],
                       [[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], width=2)
    assert out[8, 16, 0] > 0.9
    return [out]


def empty_inputs_noop(m):
    img = np.full((8, 8, 3), 0.5, np.float32)
    lines = m.draw_lines(img, np.zeros((0, 2)), np.zeros((0, 2)), np.zeros((0, 3)),
                         width=np.zeros((0,)))
    points = m.draw_points(img, np.zeros((0, 2)), np.zeros((0, 3)), radius=np.zeros((0,)))
    assert np.array_equal(lines, img) and np.array_equal(points, img)
    return [lines, points]


def aabb_margin_is_cubical(m):
    mn, mx = m.compute_equal_aabb_with_margin(np.array([0.0, 0.0, 0.0]),
                                              np.array([2.0, 1.0, 0.5]), margin=0.0)
    assert np.allclose(mx - mn, 2.0)
    return [mn, mx]


def cameras_three_panels(m):
    extr = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    extr[1, :3, 3] = [1.0, 0.5, -0.5]
    k = np.array([[0.5, 0, 0.5], [0, 0.5, 0.5], [0, 0, 1]], np.float32)
    out = m.draw_cameras(64, extr, np.broadcast_to(k, (2, 3, 3)),
                         np.ones((2, 3), np.float32), near=0.1, far=2.0)
    assert out.shape == (3, 64 + BANNER, 64, 3)
    assert out.max() > 0.2 and out.min() >= 0.0 and out.max() <= 1.0
    return [out]


def projection_gaussians():
    rng = np.random.default_rng(0)
    n = 200
    means = rng.normal(size=(n, 3)).astype(np.float32)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32) * 1e-3, (n, 3, 3))
    sh = rng.uniform(0.2, 0.8, size=(n, 3, 1)).astype(np.float32)
    op = np.full((n,), 0.8, np.float32)
    return means, eye, sh, op


def projections_shapes(m):
    kw = {} if m is j_drawing else {"device": "cpu"}
    out = m.render_projections(*projection_gaussians(), 48, draw_label=True,
                               extra_label="(test)", **kw)
    assert out.shape == (3, 48 + BANNER, 48, 3)
    assert out.max() > 0.05
    return [out]


def cameras_from_batch(m):
    extr = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 2, 4, 4)).copy()
    extr[0, 1, :3, 3] = [0.5, 0.0, 0.3]
    tgt_extr = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 1, 4, 4)).copy()
    tgt_extr[0, 0, :3, 3] = [-0.6, 0.4, 0.1]
    batch = {
        "context": {"extrinsics_sphere": extr, "near": np.full((1, 2), 0.1, np.float32),
                    "far": np.full((1, 2), 5.0, np.float32)},
        "target": {"extrinsics_sphere": tgt_extr, "near": np.full((1, 1), 0.1, np.float32),
                   "far": np.full((1, 1), 5.0, np.float32)},
    }
    if m is drawing:  # the port's batches hold tensors
        batch = {v: {k: torch.as_tensor(x) for k, x in d.items()} for v, d in batch.items()}
    out = m.render_cameras(batch, 48)
    assert out.shape == (3, 48 + BANNER, 48, 3)
    assert (out[..., 0] - out[..., 1]).max() > 0.5
    return [out]


CASES = {f.__name__: f for f in (
    lines_cover_segment, points_disc, lines_cap_behavior, lines_broadcast_from_colors,
    empty_inputs_noop, aabb_margin_is_cubical, cameras_three_panels, projections_shapes,
    cameras_from_batch)}
LABELLED = {"cameras_three_panels", "projections_shapes", "cameras_from_batch"}


@pytest.mark.parametrize("case", list(CASES))
def test_drawing_case_vs_jax(case):
    ref, got = CASES[case](j_drawing), CASES[case](drawing)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if case not in LABELLED:
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_array_equal(a[:, BANNER:], b[:, BANNER:])
        # each panel's banner: white with black glyphs, blank at its top rows
        # and left columns (tests/test_torch_validator.py's banner check)
        banner = np.round(a[:, :BANNER] * 255).astype(int)
        assert set(np.unique(banner)) == {0, 255}
        assert (banner[:, :2] == 255).all() and (banner[:, :, :4] == 255).all()


def test_render_projections_vs_jax():
    """Unlabelled panels at the forward bar, through the dense compositor on
    either side; tensors in come back from their device."""
    g = projection_gaussians()
    ref = j_drawing.render_projections(*g, 40, draw_label=False)
    got = drawing.render_projections(*(torch.tensor(x) for x in g), 40, draw_label=False)
    assert got.shape == ref.shape == (3, 40, 40, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL_RGB, rtol=0)
    assert got.max() > 0.05


def test_render_projections_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        drawing.render_projections(*projection_gaussians(), 8)


@pytest.mark.parametrize("d_sh", [1, 25])
@pytest.mark.parametrize("n", [5, 257])
def test_export_ply_bytes_vs_jax(tmp_path, n, d_sh):
    rng = np.random.default_rng(n + d_sh)
    q = rng.normal(size=(n, 4))
    args = (rng.normal(size=(n, 3)), rng.uniform(0.0, 0.3, (n, 3)),
            q / np.linalg.norm(q, axis=-1, keepdims=True), rng.normal(size=(n, 3, d_sh)),
            rng.uniform(0.0, 1.0, n))
    j_export_ply(*args, tmp_path / "jax" / "g.ply")
    export_ply(*args, tmp_path / "torch" / "g.ply")
    export_ply(*(torch.tensor(a, dtype=torch.float32) for a in args), tmp_path / "t.ply")
    j_export_ply(*(a.astype(np.float32) for a in args), tmp_path / "f32.ply")
    raw = (tmp_path / "torch" / "g.ply").read_bytes()
    assert raw == (tmp_path / "jax" / "g.ply").read_bytes()
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "f32.ply").read_bytes()
    header_end = raw.index(b"end_header\n") + len(b"end_header\n")
    assert raw.startswith(b"ply\n") and len(raw) - header_end == n * 17 * 4
