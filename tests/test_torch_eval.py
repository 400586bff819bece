"""`mode=test` of the port's CLI against the JAX package's, ERP scoring.

Both CLIs evaluate the same two seeded test scenes (64x256, written by the
JAX package's write_synthetic_scene) with the same weights: seeded random
Flax parameters saved with the JAX package's save_checkpoint, and the same
parameters converted and saved with the port's. Both compute in float32
(configs/synthetic_smoke.yaml has no bf16_compute) with the tiny encoder of
test_torch_serve.py; the JAX render runs its Pallas kernels in interpret
mode, the port its plain compositor on the CPU. LPIPS: both use the VGG
features make_lpips_fn draws (PRNGKey(0)), carried into the port with
convert.lpips_state_from_flax. tests/test_torch_eval_cubes.py does the same
with test.eval_on_cubes.

Bars: every score of every scene (PSNR 1e-2 dB; SSIM, LPIPS 1e-4; MSE 1e-5;
depth metrics 5e-4 relative), the written colour PNGs within 1 LSB on at
least 99.9% of their pixels (all of a run's colour PNGs together: the ERP
poles, where the projection is singular, are where last-bit differences
flip whole weights, ROADMAP.md Queue 3; seen: 29 pixels of rows 0-2 and
62-63 of one view, up to 10 LSB), and the same JSON files with the same keys. The
depth shares (a1, a2, a3; a5, a10, a25 in percent) count pixels whose depth
ratio is under a threshold, so a pixel whose ratio sits at a threshold
moves them by one pixel's share when the last bits of its depth differ
(seen: one pixel of 32,768 at a ratio of 1.25, 5.4e-4 of a1): they may also
differ by up to DEPTH_FLIPS pixels.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve import rand_params, zero_init

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
H, W = 64, 256
SCENES = ("t0", "t1")
OVERRIDES = [
    "dataset.image_shape=[64,256]", "dataset.view_sampler.max_distance_between_context_views=5",
    "model.d_feature=32", "model.num_depth_candidates=16", "model.costvolume_unet_feat_dim=32",
    "model.costvolume_unet_channel_mult=[1,1]", "model.costvolume_unet_attn_res=[2]",
    "model.depth_unet_feat_dim=8", "model.depth_unet_attn_res=[8]",
    "model.depth_unet_channel_mult=[1,1,1,1]", "model.gaussian_adapter.sh_degree=1",
    "train.render_backend=pallas", "mode=test", "test.eval_depth=true",
]
PSNR_TOL, SSIM_TOL, LPIPS_TOL, MSE_TOL, DEPTH_RTOL = 1e-2, 1e-4, 1e-4, 1e-5, 5e-4
PIXEL_SHARE = 0.999
DEPTH_FLIPS = 2


def write_inputs(root: Path) -> dict:
    """The scenes and both packages' checkpoints under `root`."""
    from splatter360_tpu.config import load_config as j_load_config
    from splatter360_tpu.data.dataset import SceneDataset, batch_examples
    from splatter360_tpu.data.scene_io import write_synthetic_scene
    from splatter360_tpu.models.encoder import EncoderCostVolume360 as JEncoder
    from splatter360_tpu.train import checkpoint as jckpt
    from splatter360_tpu.train.state import _context_cubes
    from splatter360_tpu.train.state import create_train_state as j_create_train_state
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.convert import torch_state_from_flax
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state

    data = root / "data"
    for i, scene in enumerate(SCENES):
        write_synthetic_scene(str(data), "test", scene, n_frames=12, image_shape=(H, W),
                              n_gaussians=1500, seed=9 + i)
    overrides = [f"dataset.roots=[{data}]", *OVERRIDES]
    cfg = j_load_config(str(REPO / "configs" / "synthetic_smoke.yaml"), overrides)
    batch = batch_examples([next(iter(SceneDataset(cfg.dataset, split="test", stage="test")))])
    ctx = batch["context"]
    cubes = _context_cubes(jnp.asarray(ctx["image_sphere"]), H // 2)
    params = rand_params(JEncoder(cfg.model), ctx["image_sphere"], cubes,
                         ctx["extrinsics_sphere"], ctx["near"], ctx["far"], 0, seed=3)
    with zero_init(params):
        jstate = j_create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train,
                                      {k: v for k, v in batch.items() if k != "scene"})
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jckpt.save_checkpoint(str(root / "ckpt_jax"), 1, jstate)

    pcfg = load_config(str(REPO / "configs" / "synthetic_smoke.yaml"), overrides)
    state = create_train_state(pcfg.model, pcfg.train, device="cpu",
                               state_dict=torch_state_from_flax(
                                   jax.tree_util.tree_map(np.asarray, params)))
    ckpt.save_checkpoint(root / "ckpt_port", 1, state)
    return dict(overrides=overrides, params=params)


def jax_lpips_state():
    from splatter360_tpu.train.lpips_jax import LPIPS as JLPIPS
    from splatter360_tpu_torch.convert import lpips_state_from_flax

    probe = jnp.zeros((1, 64, 64, 3))
    params = JLPIPS().init(jax.random.PRNGKey(0), probe, probe)
    return lpips_state_from_flax(jax.tree_util.tree_map(np.asarray, params))


def run_both(root: Path, inputs: dict, extra: list, monkeypatch) -> tuple[Path, Path]:
    """Run both CLIs' mode=test; returns their output directories."""
    import splatter360_tpu.main as jmain
    import splatter360_tpu_torch.main as pmain
    import splatter360_tpu_torch.train.lpips as plpips

    config = str(REPO / "configs" / "synthetic_smoke.yaml")
    out_j, out_p = root / "out_jax", root / "out_port"
    with monkeypatch.context() as mp, zero_init(inputs["params"]):
        mp.setenv("SPLAT360_PALLAS_INTERPRET", "1")
        jmain.main([config, *inputs["overrides"], *extra, f"checkpointing.load={root / 'ckpt_jax'}",
                    f"test.output_path={out_j}"])

    def converted_lpips(weights_path=None, device="cuda"):
        model = plpips.LPIPS()
        model.load_state_dict(jax_lpips_state())
        model = model.requires_grad_(False).to(device).eval()
        return lambda pred, gt: model(pred, gt)

    with monkeypatch.context() as mp:
        mp.setattr(plpips, "make_lpips_fn", converted_lpips)
        pmain.main([config, *inputs["overrides"], *extra,
                    f"checkpointing.load={root / 'ckpt_port'}", f"test.output_path={out_p}"],
                   device="cpu")
    return out_j, out_p


def valid_depth_pixels(root: Path, cubes: bool) -> dict:
    """Per scene, the pixels the depth metrics average over: target-view
    ground truth beyond 0.1 m (ERP, or cube z-depth of faces F R B L D)."""
    from splatter360_tpu.config import load_config as j_load_config
    from splatter360_tpu.data.dataset import SceneDataset
    from splatter360_tpu_torch.geometry.cubemap import erp_to_cube

    cfg = j_load_config(str(REPO / "configs" / "synthetic_smoke.yaml"),
                        [f"dataset.roots=[{root / 'data'}]", *OVERRIDES])
    out = {}
    for ex in SceneDataset(cfg.dataset, split="test", stage="test"):
        depth = torch.as_tensor(ex["target"]["depth_sphere"])
        if cubes:
            depth = torch.stack([erp_to_cube(d[..., None], H // 2, depth_to_z=True)[..., 0]
                                 for d in depth])[:, [0, 1, 2, 3, 5]]
        out[ex["scene"]] = int((depth > 0.1).sum())
    return out


def depth_tol(metric: str, ref: float, n_valid: int) -> float:
    tol = DEPTH_RTOL * abs(ref)
    if metric in ("depth_a1", "depth_a2", "depth_a3"):
        tol = max(tol, DEPTH_FLIPS / n_valid)
    elif metric in ("depth_a5", "depth_a10", "depth_a25"):
        tol = max(tol, 100.0 * DEPTH_FLIPS / n_valid)
    return tol


def compare_outputs(out_j: Path, out_p: Path, n_images: int, cubes: bool = False) -> None:
    files_j = sorted(p.name for p in out_j.glob("*.json"))
    assert files_j == sorted(p.name for p in out_p.glob("*.json"))
    for name in files_j:
        a, b = (json.loads((d / name).read_text()) for d in (out_j, out_p))
        assert sorted(a) == sorted(b), name
    n_valid = valid_depth_pixels(out_j.parent, cubes)
    scores_j = {k: json.loads((out_j / f"scores_{k}_all.json").read_text())
                for k in json.loads((out_j / "scores_all_avg.json").read_text())}
    for metric, per_scene in scores_j.items():
        ported = json.loads((out_p / f"scores_{metric}_all.json").read_text())
        for scene in SCENES:
            ref, got = per_scene[scene], ported[scene]
            print(f"{scene} {metric}: jax {ref:.6g} port {got:.6g} diff {abs(ref - got):.3g}")
            if metric.startswith("depth_"):
                assert abs(ref - got) <= depth_tol(metric, ref, n_valid[scene]), (scene, metric)
            else:
                tol = dict(psnr=PSNR_TOL, ssim=SSIM_TOL, lpips=LPIPS_TOL, mse=MSE_TOL)[metric]
                assert abs(ref - got) <= tol, (scene, metric, ref, got)
    assert set(scores_j) >= {"psnr", "ssim", "mse", "lpips", "depth_abs_rel"}

    from splatter360_tpu_torch.utils.image_io import decode_png

    close = total = 0
    for scene in SCENES:
        names = sorted(p.name for p in (out_j / scene / "color").glob("*.png"))
        assert len(names) == n_images
        for sub in ("color", "gt", "err", "depth"):
            assert sorted(p.name for p in (out_p / scene / sub).glob("*.png")) == sorted(
                p.name for p in (out_j / scene / sub).glob("*.png")), (scene, sub)
        assert (out_p / scene / "compare.png").is_file()
        for name in names:
            a, b = (decode_png((d / scene / "color" / name).read_bytes()).astype(int)
                    for d in (out_j, out_p))
            within = (np.abs(a - b) <= 1).all(axis=-1)
            print(f"{scene} color/{name}: {int((~within).sum())} pixels over 1 LSB, "
                  f"max {int(np.abs(a - b).max())} LSB")
            close += int(within.sum())
            total += within.size
    assert close >= PIXEL_SHARE * total, (close, total)


@pytest.fixture(scope="module")
def erp_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_erp")
    inputs = write_inputs(root)
    with pytest.MonkeyPatch.context() as mp:
        return run_both(root, inputs, [], mp)


def test_cli_test_mode_vs_jax(erp_run):
    out_j, out_p = erp_run
    compare_outputs(out_j, out_p, n_images=2)


def test_checkpoint_restores_the_saved_weights(erp_run, tmp_path):
    """The port's mode=test evaluated the saved weights: its restore of the
    checkpoint equals the converted Flax parameters."""
    from splatter360_tpu_torch.config import load_config
    from splatter360_tpu_torch.train import checkpoint as ckpt
    from splatter360_tpu_torch.train.state import create_train_state

    root = erp_run[0].parent
    cfg = load_config(str(REPO / "configs" / "synthetic_smoke.yaml"),
                      ["dataset.roots=[x]", *OVERRIDES])
    state = create_train_state(cfg.model, cfg.train, seed=5, device="cpu")
    state, ok = ckpt.restore_weights_only(root / "ckpt_port", state)
    assert ok and ckpt.latest_step(root / "ckpt_port") == 1
    saved = torch.load(root / "ckpt_port" / "1" / ckpt.FILE, weights_only=True)["params"]
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, saved[name]), name


def test_jax_checkpoint_evaluates_as_the_ports(erp_run, capsys, monkeypatch):
    """The port's mode=test pointed at the JAX package's orbax checkpoint
    (ckpt_jax) writes what it writes from the port's own checkpoint.pt of
    the same weights (ckpt_port): the same scores and PNG bytes."""
    import splatter360_tpu_torch.train.lpips as plpips
    from splatter360_tpu_torch.main import main

    out_j, out_p = erp_run
    root = out_p.parent
    out_o = root / "out_port_from_orbax"
    lpips = plpips.LPIPS()
    lpips.load_state_dict(jax_lpips_state())
    lpips = lpips.requires_grad_(False).eval()
    monkeypatch.setattr(plpips, "make_lpips_fn", lambda *a, **k: lambda x, y: lpips(x, y))
    main([str(REPO / "configs" / "synthetic_smoke.yaml"), f"dataset.roots=[{root / 'data'}]",
          *OVERRIDES, f"checkpointing.load={root / 'ckpt_jax'}", f"test.output_path={out_o}"],
         device="cpu")
    printed = capsys.readouterr().out
    assert "orbax checkpoint at step 1" in printed and "random weights" not in printed
    scores = sorted(p.name for p in out_p.glob("scores_*.json"))
    assert scores and scores == sorted(p.name for p in out_o.glob("scores_*.json"))
    for name in scores:
        assert (out_o / name).read_text() == (out_p / name).read_text(), name
    pngs = sorted(p.relative_to(out_p) for p in out_p.rglob("*.png"))
    assert pngs and pngs == sorted(p.relative_to(out_o) for p in out_o.rglob("*.png"))
    for rel in pngs:
        assert (out_o / rel).read_bytes() == (out_p / rel).read_bytes(), rel
