"""Trajectory videos (test.save_video, test.video_trajectory), the port
against the JAX package.

  * trajectory_wobble and trajectory_spin against JAX's at 1e-6, for
    scalar and array t about a pose with a rotation;
  * Evaluator.render_video of both packages on the same Gaussians and context
    poses (3 frames of 64x256 with depth, render_backend "pallas": JAX's fused
    Pallas compositor in interpret mode, the port's plain compositor) for
    each trajectory. The frames each evaluator hands to save_video are
    captured by replacing that name in its module: colour within 1e-4 (the
    compositor bar), the colour-mapped depth frames within 1 LSB on 99.9% of
    their pixels (tests/test_torch_eval.py's bar for written images);
  * a failed render propagates out of the port's render_video, where JAX's
    run prints a warning; a failed write is printed and skipped;
  * the port's CLI, mode=test with test.save_video and test.eval_depth,
    renders a video for each scene as JAX's run does and writes
    `<trajectory>` and `<trajectory>_depth`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import splatter360_tpu.train.evaluator as jev
import splatter360_tpu_torch.train.evaluator as pev
from splatter360_tpu.config import load_config as j_load_config
from splatter360_tpu.geometry import transforms as jt
from splatter360_tpu.models.types import Gaussians as JGaussians
from splatter360_tpu_torch.config import load_config
from splatter360_tpu_torch.geometry import transforms as pt
from splatter360_tpu_torch.models.types import Gaussians
from splatter360_tpu_torch.utils.image_io import to_uint8
from test_torch_eval import OVERRIDES, REPO

from chip_smoke import video_frames

torch.set_num_threads(2)
H, W = 64, 256
N_FRAMES = 3
TRAJECTORIES = ("interpolate", "wobble", "spin")
TOL_POSE, ATOL_RGB, PIXEL_SHARE = 1e-6, 1e-4, 0.999


def rotation(seed: int, spread: float = 10.0) -> np.ndarray:
    """A seeded rotation matrix: the quaternion (spread * N(0, 1)^3, 1),
    normalised (spread 10: about any rotation; 0.15: about 17 degrees)."""
    q = np.append(spread * np.random.default_rng(seed).normal(size=3), 1.0).astype(np.float32)
    return pt.quaternion_to_matrix(torch.from_numpy(q / np.linalg.norm(q))).numpy()


def pose(seed: int, spread: float = 0.3) -> np.ndarray:
    """A context c2w pose: a rotation of about 17 degrees, an offset of
    `spread` m."""
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = rotation(seed, 0.15)
    p[:3, 3] = np.random.default_rng(seed + 100).normal(0, spread, 3)
    return p


@pytest.mark.parametrize("name", ["wobble", "spin"])
def test_trajectory_vs_jax(name):
    base = np.eye(4, dtype=np.float32)
    base[:3, :3] = rotation(1)
    base[:3, 3] = (0.4, -1.2, 2.5)
    ts = (0.0, 0.3, 1.0, np.linspace(0, 1, 7, dtype=np.float32),
          np.array([[0.15], [0.85]], np.float32))
    for t in ts:
        if name == "wobble":
            ref = jt.trajectory_wobble(jnp.asarray(base), 0.37, t)
            got = pt.trajectory_wobble(torch.from_numpy(base), 0.37, t)
        else:
            ref = jt.trajectory_spin(jnp.asarray(base), t)
            got = pt.trajectory_spin(torch.from_numpy(base), t)
        ref = np.asarray(ref)
        assert ref.shape == tuple(got.shape) == (*np.shape(t), 4, 4)
        assert np.abs(ref - got.numpy()).max() <= TOL_POSE, (t, np.abs(ref - got.numpy()).max())


def scene(n: int = 3000, seed: int = 4):
    """numpy-seeded Gaussians on a shell of radius 1.5-5 around the context
    poses (sh_degree 1), as a batch of one."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    means = d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(1.5, 5.0, (n, 1))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    covs = pt.build_covariance_sym6(torch.as_tensor(rng.uniform(0.02, 0.15, (n, 3))),
                                    torch.as_tensor(q)).numpy()
    sh = 0.3 * rng.normal(size=(n, 3, 4))
    sh[..., 0] += 0.5
    return [x[None].astype(np.float32) for x in (means, covs, sh, rng.uniform(0.3, 0.95, n))]


def capture(monkeypatch, module) -> dict:
    """Replace `module.save_video` with a recorder of its frames by file name."""
    got = {}

    def record(frames, path, fps=30):
        got[path.name] = [np.asarray(f) for f in frames]

    monkeypatch.setattr(module, "save_video", record)
    return got


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    """Both packages' Evaluators at 64x256 with render_backend pallas (one
    of each, so that JAX's jitted render is traced once)."""
    root = tmp_path_factory.mktemp("video")
    ov = ["dataset.image_shape=[64,256]", "train.render_backend=pallas"]
    config = str(REPO / "configs" / "synthetic_smoke.yaml")
    jcfg = j_load_config(config, [*ov, f"test.output_path={root / 'jax'}"])
    pcfg = load_config(config, [*ov, f"test.output_path={root / 'port'}"])
    return jev.Evaluator(jcfg, None), pev.Evaluator(pcfg, None, device="cpu"), root


@pytest.mark.parametrize("trajectory", TRAJECTORIES)
def test_render_video_vs_jax(evaluators, trajectory, monkeypatch):
    """N_FRAMES frames with depth of both packages' render_video on the same
    Gaussians and context poses: colour within 1e-4, colour-mapped depth
    within 1 LSB on 99.9% of the pixels."""
    jevaluator, pevaluator, root = evaluators
    arrays = scene()
    ctx = np.stack([pose(1), pose(2)])
    near, far = 0.1, 10.0
    monkeypatch.setenv("SPLAT360_PALLAS_INTERPRET", "1")
    jframes, pframes = capture(monkeypatch, jev), capture(monkeypatch, pev)
    jevaluator.render_video(JGaussians(*(jnp.asarray(a) for a in arrays)), jnp.asarray(ctx),
                            near, far, root / "jax" / f"{trajectory}.mp4", n_frames=N_FRAMES,
                            trajectory=trajectory, with_depth=True)
    pevaluator.render_video(Gaussians(*(torch.from_numpy(a) for a in arrays)),
                            torch.from_numpy(ctx), near, far, root / "port" / f"{trajectory}.mp4",
                            n_frames=N_FRAMES, trajectory=trajectory, with_depth=True)
    assert sorted(jframes) == sorted(pframes) == sorted([f"{trajectory}.mp4",
                                                         f"{trajectory}_depth.mp4"])
    for a, b in zip(jframes[f"{trajectory}.mp4"], pframes[f"{trajectory}.mp4"]):
        assert a.shape == b.shape == (H, W, 3)
        err = float(np.abs(a - b).max())
        print(f"{trajectory} colour: max|port - JAX| {err:.2e}, non-black share "
              f"{float((a.sum(-1) > 0).mean()):.2f}")
        assert err <= ATOL_RGB, err
    assert len(jframes[f"{trajectory}.mp4"]) == N_FRAMES
    close = total = 0
    for a, b in zip(jframes[f"{trajectory}_depth.mp4"], pframes[f"{trajectory}_depth.mp4"]):
        assert a.shape == b.shape == (H, W, 3)
        within = (np.abs(to_uint8(a).astype(int) - to_uint8(b).astype(int)) <= 1).all(-1)
        close, total = close + int(within.sum()), total + within.size
    print(f"{trajectory} depth: {total - close} of {total} pixels over 1 LSB")
    assert close >= PIXEL_SHARE * total


def test_render_failure_propagates(evaluators, monkeypatch, capsys):
    """A render failure (here a stand-in for a kernel fault) leaves the
    port's render_video as it came; a failed write (OSError) is printed as
    a warning and the frames are not written."""
    _, pevaluator, root = evaluators
    g = Gaussians(*(torch.from_numpy(a) for a in scene(n=200)))
    ctx = torch.from_numpy(np.stack([pose(1), pose(2)]))

    def fault(*args, **kwargs):
        raise RuntimeError("composite_forward_fused launch failed: cudaError 700")

    with monkeypatch.context() as mp:
        mp.setattr(pev.decoder, "render_erp_views", fault)
        with pytest.raises(RuntimeError, match="cudaError 700"):
            pevaluator.render_video(g, ctx, 0.1, 10.0, root / "fault.mp4", n_frames=2)
    assert "warning" not in capsys.readouterr().out

    def full_disk(frames, path, fps=30):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(pev, "save_video", full_disk)
    pevaluator.render_video(g, ctx, 0.1, 10.0, root / "full.mp4", n_frames=2)
    assert "warning: writing the video" in capsys.readouterr().out


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """2 test scenes of 32x128 and a checkpoint of seeded random weights;
    the port's CLI argv for mode=test on them with test.save_video=true,
    test.eval_depth=true and test.video_trajectory=spin (without
    test.output_path)."""
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state

    root = tmp_path_factory.mktemp("video_cli")
    h, w = 32, 128
    for i, name in enumerate(("t0", "t1")):
        write_synthetic_scene(root / "data", "test", name, n_frames=12, image_shape=(h, w),
                              n_gaussians=300, seed=9 + i, device="cpu")
    argv = [str(REPO / "configs" / "synthetic_smoke.yaml"),
            *[o for o in OVERRIDES if not o.startswith("dataset.image_shape")],
            f"dataset.roots=[{root / 'data'}]", f"dataset.image_shape=[{h},{w}]",
            "test.save_video=true", "test.video_trajectory=spin",
            f"checkpointing.load={root / 'ckpt'}"]
    cfg = load_config(argv[0], argv[1:])
    ckpt.save_checkpoint(root / "ckpt", 1, create_train_state(cfg.model, cfg.train, seed=2,
                                                               device="cpu"))
    return argv, cfg


def test_cli_test_mode_writes_videos(cli_inputs, tmp_path, monkeypatch):
    """The port's CLI, mode=test on cli_inputs: run() renders each scene's
    video as JAX's does (the first context pose set, the first target's
    near and far, depth with eval_depth), and each scene gets spin and
    spin_depth (an mp4, or its PNG frame directory where cv2 is absent). A
    frame of these random-weight scenes takes ~0.5 s on the CPU, so the
    videos here have N_FRAMES frames; both packages' default is 60
    (chip_smoke.py counts 60 kernel launches a video)."""
    import inspect

    from splatter360_tpu_torch.main import main

    for fn in (jev.Evaluator.render_video, pev.Evaluator.render_video):
        assert inspect.signature(fn).parameters["n_frames"].default == 60
    argv, cfg = cli_inputs
    out = tmp_path / "out"
    calls = []
    render_video = pev.Evaluator.render_video

    def short(self, gaussians, ctx_extr, near, far, path, **kw):
        calls.append((tuple(ctx_extr.shape), near, far, path, kw))
        return render_video(self, gaussians, ctx_extr, near, far, path, n_frames=N_FRAMES, **kw)

    monkeypatch.setattr(pev.Evaluator, "render_video", short)
    scores = main([*argv, f"test.output_path={out}"], device="cpu")
    assert sorted(scores) == ["t0", "t1"]
    near, far = (float(np.float32(x)) for x in (cfg.dataset.near, cfg.dataset.far))
    assert calls == [((2, 4, 4), near, far, out / name / "spin.mp4",
                      dict(trajectory="spin", with_depth=True)) for name in ("t0", "t1")]
    for name in scores:
        for stem in ("spin", "spin_depth"):
            kind, n = video_frames(out / name / f"{stem}.mp4")
            assert kind in ("mp4", "png") and n == N_FRAMES, (name, stem, kind, n)


def test_cli_video_render_failure_fails_the_run(cli_inputs, tmp_path, monkeypatch, capsys):
    """A render failure in a scene's video ends the port's mode=test with
    that error, where JAX's run prints a warning and goes on: the first
    video frame's render raises (the scenes' scoring renders pass)."""
    from splatter360_tpu_torch.main import main

    argv, _ = cli_inputs
    render = pev.decoder.render_erp_views

    def fault_on_frames(gaussians, extrinsics, *args, **kwargs):
        if extrinsics.shape[1] == 1:  # a video frame: one view
            raise RuntimeError("composite_forward_fused launch failed: cudaError 700")
        return render(gaussians, extrinsics, *args, **kwargs)

    monkeypatch.setattr(pev.decoder, "render_erp_views", fault_on_frames)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        main([*argv, f"test.output_path={tmp_path / 'out'}"], device="cpu")
    assert "warning: video" not in capsys.readouterr().out
    assert not (tmp_path / "out" / "scores_all_avg.json").exists()
