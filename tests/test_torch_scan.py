"""The port's scan compositor (render_backend "jax") vs the JAX package's
composite_tiles_jax, and the config that needs it, configs/synthetic_smoke.yaml.

ops/composite_scan.py is composite_jax's counterpart: both are ordinary ops
differentiated by autograd, so the port is held to composite_tiles_jax and
jax.grad (not to Pallas: the two reference backends differ on capped
alphas, ROADMAP Queue 3). Bars: the compositor's, forward 1e-4 (depth
5e-4) and gradients 2e-3 of max|g| per leaf (tests/test_pallas_composite.py).
The cases: an ERP view with the seam wrap, a 32x32 pinhole face, a 64x128
ERP view that render_tiled(backend="pallas") sends to the scan compositor
in both packages (under 2 tiles wide), and a scene whose busiest tile
holds more instances than max_per_tile, so both truncate. Then the port's
CLI runs synthetic_smoke.yaml as written (render_backend jax) through
mode=train and mode=test on the CPU.
"""

import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter360_tpu.ops.projection import project_erp as j_project
from splatter360_tpu.ops.rasterizer import render_tiled as j_render
from splatter360_tpu.ops.tiling import assign_tiles as j_assign
from splatter360_tpu_torch import main
from splatter360_tpu_torch.config import load_config
from splatter360_tpu_torch.ops import composite_scan as ts
from splatter360_tpu_torch.ops.cuda import composite as tc
from splatter360_tpu_torch.ops.rasterizer import render_tiled as t_render
from test_torch_cubes import LEAVES, pinhole_case, smooth_loss
from test_torch_render import ATOL_DEPTH, ATOL_RGB, pose, scene, tt
from test_torch_train import assert_grads_close

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
TRUNCATE_AT = 48  # max_per_tile of the truncation case


def case_inputs(case):
    """(scene, c2w, render_tiled keywords of both packages, backend,
    max_per_tile)."""
    if case == "face":
        g, c2w, intr, shape = pinhole_case("face")
        return g, c2w, dict(camera_kind="pinhole", intrinsics=intr), shape, "jax", 512
    shape = {"erp": (64, 256), "narrow_erp": (64, 128), "truncated": (64, 256)}[case]
    g = scene(1500 if case != "truncated" else 3000, seed=11)
    backend = "pallas" if case == "narrow_erp" else "jax"
    return g, pose(), dict(camera_kind="erp"), shape, backend, (
        TRUNCATE_AT if case == "truncated" else 512)


@pytest.mark.parametrize("case", ["erp", "face", "narrow_erp", "truncated"])
def test_scan_render_vs_composite_jax(case):
    """render_tiled forward and the gradients of a colour MSE + alpha +
    depth loss to the four Gaussian leaves, the port's scan compositor
    against JAX's composite_tiles_jax + jax.grad."""
    g, c2w, kw, shape, backend, mpt = case_inputs(case)
    jkw = {k: (jnp.asarray(v) if k == "intrinsics" else v) for k, v in kw.items()}
    tkw = {k: (tt(v) if k == "intrinsics" else v) for k, v in kw.items()}

    def j_loss(*x):
        out = j_render(*x, jnp.asarray(c2w), shape, backend=backend, max_per_tile=mpt,
                       render_depth=True, **jkw)
        return smooth_loss(out.color, out.alpha, out.depth), (out.color, out.alpha, out.depth)

    (_, ref), grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(g[k]) for k in LEAVES))
    x = [torch.tensor(g[k], requires_grad=True) for k in LEAVES]
    scans, kernels = ts.scan_counts[ts.SCAN_NAME], dict(tc.launch_counts)
    out = t_render(*x, tt(c2w), shape, backend=backend, max_per_tile=mpt, render_depth=True,
                   **tkw)
    smooth_loss(out.color, out.alpha, out.depth).backward()
    assert ts.scan_counts[ts.SCAN_NAME] == scans + 1  # one scan render, whatever the backend
    assert tc.launch_counts == kernels
    for name, atol, want in zip(("color", "alpha", "depth"), (ATOL_RGB, ATOL_RGB, ATOL_DEPTH),
                                ref):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(), np.asarray(want),
                                   atol=atol, err_msg=name)
    assert float(out.alpha.max()) > 0.5
    assert_grads_close([np.asarray(a) for a in grads], [a.grad.numpy() for a in x], LEAVES)
    if case == "truncated":  # the busiest tile holds more than the walk takes
        p = j_project(*(jnp.asarray(g[k]) for k in ("means", "covariances")), jnp.asarray(c2w),
                      shape, 0.1, opacities=jnp.asarray(g["opacities"]))
        assert int(j_assign(p, shape, True).tile_counts.max()) > 2 * TRUNCATE_AT


def test_scan_chunks_and_remat_same_values(monkeypatch):
    """The chunked walk is the scan: one chunk a slot and one chunk for all
    slots give the same planes; under autograd each chunk is checkpointed
    and the gradients are those of the chunks run without it."""
    g, c2w, _, shape, _, _ = case_inputs("erp")
    runs = []
    for chunk, remat in ((1, True), (4096, True), (64, False)):
        monkeypatch.setattr(ts, "SCAN_CHUNK", chunk)
        monkeypatch.setattr(ts, "checkpoint", ts.checkpoint if remat else
                            (lambda f, *a, **k: f(*a)))
        x = [torch.tensor(g[k], requires_grad=True) for k in LEAVES]
        out = t_render(*x, tt(c2w), shape, backend="jax", render_depth=True)
        smooth_loss(out.color, out.alpha, out.depth).backward()
        runs.append([out.color, out.alpha, out.depth] + [a.grad for a in x])
    for a, b, c in zip(*runs):  # within 1e-6 of max|x|: sums taken in another order
        scale = float(a.abs().max())
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6 * scale)
        torch.testing.assert_close(c, a, rtol=0, atol=1e-6 * scale)


def test_unknown_backend_raises():
    g, c2w, _, shape, _, _ = case_inputs("erp")
    with pytest.raises(ValueError, match="backend"):
        t_render(*(tt(g[k]) for k in LEAVES), tt(c2w), shape, backend="cuda")


def test_synthetic_smoke_cli_train_then_test(tmp_path):
    """configs/synthetic_smoke.yaml as written (render_backend jax, cube
    supervision) through the port's CLI on the CPU, with the verify recipe's
    tiny model: mode=train for 2 steps, then mode=test on its checkpoint;
    the scan compositor renders every view and face."""
    from splatter360_tpu_torch.data.scene_io import write_synthetic_scene

    cfg = load_config(str(REPO / "configs" / "synthetic_smoke.yaml"))
    assert cfg.train.render_backend == "jax" and cfg.train.supervision == "cubes"
    h, w = 32, 64
    for split, name, seed in (("train", "s0", 0), ("test", "t0", 9)):
        write_synthetic_scene(str(tmp_path / "data"), split, name, n_frames=12,
                              image_shape=(h, w), n_gaussians=600, seed=seed, device="cpu")
    common = [f"dataset.roots=[{tmp_path / 'data'}]", f"dataset.image_shape=[{h},{w}]",
              "dataset.view_sampler.max_distance_between_context_views=5",
              "model.d_feature=32", "model.num_depth_candidates=16",
              "model.costvolume_unet_feat_dim=32", "model.costvolume_unet_channel_mult=[1,1]",
              "model.costvolume_unet_attn_res=[2]", "model.depth_unet_feat_dim=8",
              "model.depth_unet_attn_res=[8]", "model.depth_unet_channel_mult=[1,1,1]",
              "model.gaussian_adapter.sh_degree=1", f"output_dir={tmp_path / 'out'}"]
    def run(*args):
        before = dict(ts.scan_counts), dict(tc.launch_counts)
        main.main([str(REPO / "configs" / "synthetic_smoke.yaml"), *common, *args,
                   "--device", "cpu"])
        return (ts.scan_counts[ts.SCAN_NAME] - before[0][ts.SCAN_NAME],
                {k: n - before[1][k] for k, n in tc.launch_counts.items()})

    t0 = time.perf_counter()
    scans, kernels = run("mode=train", "trainer.max_steps=2", "trainer.print_log_every_n_steps=1",
                         "trainer.num_sanity_val_steps=0", "trainer.val_check_interval=0")
    t1 = time.perf_counter()
    # 2 steps of 2 target views' faces, each rendered again in the backward (remat_faces)
    assert scans == 8 and not any(kernels.values()), (scans, kernels)
    ckpts = sorted(p.name for p in (tmp_path / "out" / "checkpoints").iterdir())
    assert ckpts[-1] == "2", ckpts
    test_dir = tmp_path / "test"
    scans, kernels = run("mode=test", "test.eval_depth=true",
                         f"checkpointing.load={tmp_path / 'out' / 'checkpoints'}",
                         f"test.output_path={test_dir}")
    print(f"mode=train {t1 - t0:.1f} s, mode=test {time.perf_counter() - t1:.1f} s")
    assert scans == 1 and not any(kernels.values()), (scans, kernels)  # one scene's ERP views
    scores = json.loads((test_dir / "scores_all_avg.json").read_text())
    assert all(np.isfinite(v) for v in scores.values()), scores
    assert (test_dir / "t0" / "color").is_dir()
