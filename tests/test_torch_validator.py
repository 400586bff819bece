"""The port's Validator against the JAX package's, and the helpers it
draws with: visualize_gaussians, interpolate_pose_6d, add_label and
save_video.

Both Validators score the same seeded `val` scene (64x256, the JAX
package's write_synthetic_scene) with the same weights (seeded random Flax
parameters, converted for the port) and the tiny encoder of
tests/test_torch_eval.py; the JAX render runs its Pallas kernels in
interpret mode, the port its plain compositor on the CPU. Bars: `val/psnr`
and `val/ssim` within tests/test_torch_eval.py's PSNR_TOL and SSIM_TOL, the
same artefact files, and comparison.png of the same shape, equal outside
its label banners within 1 LSB on at least 99.9% of its pixels (the ERP
poles, where last-bit differences flip whole weights: ROADMAP.md Queue 3).
The label banners differ by design: the port draws its text with its own
bitmap font.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import PIXEL_SHARE, PSNR_TOL, SSIM_TOL
from test_torch_serve import rand_params, zero_init
from test_torch_trainer import CONFIG, TINY

torch.set_num_threads(2)
H, W = 64, 256
STEP = 5
BANNER = 18


class Recorder:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars[(tag, step)] = float(value)


@pytest.fixture(scope="module")
def val_runs(tmp_path_factory):
    """Both Validators' run at step STEP: (metrics, recorded scalars, the
    step's artefact directory) of JAX, then of the port."""
    from splatter360_tpu.config import load_config as j_load_config
    from splatter360_tpu.data.dataset import SceneDataset, batch_examples
    from splatter360_tpu.data.scene_io import write_synthetic_scene
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train.state import _context_cubes
    from splatter360_tpu.train.state import create_train_state as j_create_train_state
    from splatter360_tpu.train.trainer import Validator as JValidator
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train.state import create_train_state
    from splatter360_tpu_torch.train.trainer import Validator

    root = tmp_path_factory.mktemp("validator")
    write_synthetic_scene(str(root / "data"), "val", "v0", n_frames=12, image_shape=(H, W),
                          n_gaussians=1500, seed=31)
    overrides = [f"dataset.roots=[{root / 'data'}]", *TINY]
    cfg = j_load_config(CONFIG, overrides)
    batch = batch_examples([next(iter(SceneDataset(cfg.dataset, split="val", stage="val")))])
    ctx = batch["context"]
    cubes = _context_cubes(jnp.asarray(ctx["image_sphere"]), H // 2)
    params = rand_params(JEncoder(cfg.model), ctx["image_sphere"], cubes,
                         ctx["extrinsics_sphere"], ctx["near"], ctx["far"], 0, seed=3)
    with zero_init(params):
        jstate = j_create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train,
                                      {k: v for k, v in batch.items() if k != "scene"})
    jstate = jstate.replace(params=params)
    rec_j, rec_p = Recorder(), Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPLAT360_PALLAS_INTERPRET", "1")
        m_j = JValidator(cfg, root / "out_jax").run(jstate, STEP, rec_j)

    pcfg = load_config(CONFIG, overrides)
    state = create_train_state(pcfg.model, pcfg.train, device="cpu",
                               state_dict=torch_state_from_flax(
                                   jax.tree_util.tree_map(np.asarray, params)))
    m_p = Validator(pcfg, root / "out_port", device="cpu").run(state, STEP, rec_p)
    vdir = Path("val") / f"{STEP:08d}"
    return ((m_j, rec_j.scalars, root / "out_jax" / vdir),
            (m_p, rec_p.scalars, root / "out_port" / vdir))


def banner_rows(height: int, block: int, pad: int = 0) -> np.ndarray:
    """Rows of a sheet of `height` rows that lie in a label banner: the
    first BANNER rows of each block of `block` rows, blocks `pad` apart."""
    rows = np.arange(height)
    return (rows % (block + pad)) < BANNER


def test_validator_vs_jax(val_runs):
    from splatter360_tpu_torch.utils.image_io import decode_png

    (m_j, rec_j, dir_j), (m_p, rec_p, dir_p) = val_runs
    print(f"psnr jax {m_j['psnr']:.6f} port {m_p['psnr']:.6f}; "
          f"ssim jax {m_j['ssim']:.6f} port {m_p['ssim']:.6f}")
    assert abs(m_j["psnr"] - m_p["psnr"]) <= PSNR_TOL
    assert abs(m_j["ssim"] - m_p["ssim"]) <= SSIM_TOL
    assert sorted(rec_j) == sorted(rec_p) == [("val/psnr", STEP), ("val/ssim", STEP)]
    assert rec_p[("val/psnr", STEP)] == m_p["psnr"]
    names = sorted(p.name for p in dir_j.iterdir())
    assert names == sorted(p.name for p in dir_p.iterdir())
    assert {"comparison.png", "encoder_depth.png", "encoder_vis.png"} <= set(names)
    assert "interpolation.mp4" in names or "interpolation" in names

    a, b = (decode_png((d / "comparison.png").read_bytes()).astype(int) for d in (dir_j, dir_p))
    assert a.shape == b.shape == (3 * (BANNER + H), 2 * W, 3)  # 2 target views
    keep = ~banner_rows(a.shape[0], BANNER + H)
    within = (np.abs(a - b) <= 1).all(axis=-1)[keep]
    print(f"comparison.png: {int((~within).sum())} of {within.size} pixels over 1 LSB")
    assert within.mean() >= PIXEL_SHARE
    for name in ("encoder_depth.png", "encoder_vis.png"):
        a, b = (decode_png((d / name).read_bytes()) for d in (dir_j, dir_p))
        assert a.shape == b.shape, name


def random_gaussians(rng, v, h, w, full_cov: bool):
    n = v * h * w
    scales = rng.uniform(0.01, 0.2, (n, 3))
    rot = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    cov = np.einsum("nij,nj,nkj->nik", rot, scales ** 2, rot)
    if not full_cov:
        cov = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    return [x[None].astype(np.float32) for x in (
        rng.normal(size=(n, 3)), cov, rng.normal(0, 0.5, (n, 3, 4)), rng.uniform(0, 1, n))]


@pytest.mark.parametrize("full_cov", [False, True])
def test_visualize_gaussians_vs_jax(full_cov):
    from splatter360_tpu.models.types import Gaussians as JGaussians
    from splatter360_tpu.models.visualizer import visualize_gaussians as j_vis
    from splatter360_tpu_torch.models.types import Gaussians
    from splatter360_tpu_torch.models.visualizer import visualize_gaussians

    rng = np.random.default_rng(4)
    v, h, w = 2, 16, 32
    g = random_gaussians(rng, v, h, w, full_cov)
    depth = rng.uniform(0.5, 8, (1, v, h, w, 1)).astype(np.float32)
    images = rng.uniform(0, 1, (1, v, h, w, 3)).astype(np.float32)
    ref = j_vis(JGaussians(*g), depth, images, (h, w))
    got = visualize_gaussians(Gaussians(*(torch.from_numpy(x) for x in g)),
                              torch.from_numpy(depth), torch.from_numpy(images), (h, w))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    keep = ~banner_rows(ref.shape[0], BANNER + h, pad=2)
    np.testing.assert_array_equal(got[keep], ref[keep])


def test_interpolate_pose_6d_vs_jax():
    from splatter360_tpu.geometry.transforms import interpolate_pose_6d as j_interp
    from splatter360_tpu_torch.geometry.transforms import interpolate_pose_6d

    rng = np.random.default_rng(6)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 5, 1, 1))
    rot = np.linalg.qr(rng.normal(size=(2, 5, 3, 3)))[0]
    rot[..., :, 0] *= np.sign(np.linalg.det(rot))[..., None]  # proper rotations
    poses[..., :3, :3] = rot
    poses[..., :3, 3] = rng.normal(size=(2, 5, 3))
    a, b = poses[0], poses[1]
    for t in (0.0, 0.3, 1.0, rng.uniform(0, 1, 5).astype(np.float32)):
        ref = np.asarray(j_interp(jnp.asarray(a), jnp.asarray(b), t))
        got = interpolate_pose_6d(torch.from_numpy(a), torch.from_numpy(b), t).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_add_label_shape_and_banner(dtype):
    from splatter360_tpu.utils.image_io import add_label as j_add_label
    from splatter360_tpu_torch.utils.image_io import add_label

    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (20, 90, 3)).astype(np.float32)
    if dtype == np.uint8:
        img = (img * 255).astype(np.uint8)
    ref, got = j_add_label(img, "target pred"), add_label(img, "target pred")
    assert got.shape == ref.shape == (20 + BANNER, 90, 3) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got[BANNER:], ref[BANNER:])
    banner = np.round(got[:BANNER] * (255 if dtype == np.float32 else 1)).astype(int)
    assert set(np.unique(banner)) == {0, 255}
    assert (banner[:2] == 255).all() and (banner[:, :4] == 255).all()


@pytest.mark.parametrize("with_cv2", [True, False])
def test_save_video(tmp_path, monkeypatch, with_cv2):
    """cv2's mp4v file where cv2 imports, else the PNG frame directory,
    whose frames equal those the JAX package writes there."""
    from splatter360_tpu.utils.image_io import save_video as j_save_video
    from splatter360_tpu_torch.utils.image_io import decode_png, save_video, to_uint8

    frames = list(np.random.default_rng(1).uniform(0, 1, (4, 16, 24, 3)).astype(np.float32))
    if not with_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)
    save_video(frames, tmp_path / "p" / "v.mp4", fps=8)
    j_save_video(frames, tmp_path / "j" / "v.mp4", fps=8)
    if with_cv2:
        assert (tmp_path / "p" / "v.mp4").stat().st_size > 0
        assert not (tmp_path / "p" / "v").exists()
        return
    assert not (tmp_path / "p" / "v.mp4").exists()
    names = sorted(p.name for p in (tmp_path / "p" / "v").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j" / "v").iterdir()) == [
        f"{i:04d}.png" for i in range(4)]
    for i, name in enumerate(names):
        got = decode_png((tmp_path / "p" / "v" / name).read_bytes())
        np.testing.assert_array_equal(got, decode_png((tmp_path / "j" / "v" / name).read_bytes()))
        np.testing.assert_array_equal(got, to_uint8(frames[i]))
