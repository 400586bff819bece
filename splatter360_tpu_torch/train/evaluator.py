"""The test harness: score target views rendered from each test scene.

Counterpart of splatter360_tpu/train/evaluator.py (`Evaluator.__init__`,
`run`, `finalize`). Per scene: encode the context panoramas (timed,
"encoder"), render the target ERP views (timed, "decoder", one call per
view), optionally their v*6 cube faces (the reference's protocol), then
PSNR, SSIM, MSE and LPIPS over the rendered views or faces, and depth
metrics: ERP ray distance, or cube z-depth with the top face excluded, over
ground truth beyond 0.1 m. Images and the per-scene scores are written;
finalize writes scores_all_avg.json, scores_<metric>_all.json,
mse_dict.json, benchmark.json (timings past the first
`eval_time_skip_steps`) and peak_memory.json.

The metrics are computed on the device; only what is written moves to the
host. Videos (`render_video`) and band-sharded decoding (`shard_render`)
are not ported (ROADMAP.md Queue 1 items 4 and 7).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import SceneDataset, batch_examples
from ..device import resolve_device, set_f32_policy
from ..geometry.cubemap import erp_to_cube
from ..models import decoder
from ..models.encoder import apply_encoder
from ..serve import EVAL_GLOBAL_STEP, context_cubes
from ..utils.benchmarker import Benchmarker
from ..utils.image_io import apply_depth_colormap, hcat, save_image
from .metrics import compute_depth_metrics, compute_psnr, compute_ssim

# the cube faces scored for depth: F R B L D (the top face U is excluded)
_DEPTH_FACES = [0, 1, 2, 3, 5]


class Evaluator:
    def __init__(self, cfg, state, lpips_fn=None, device: str | torch.device = "cuda"):
        """cfg: config.RootConfig; state: train.state.TrainState (its encoder);
        lpips_fn(pred, gt) -> [B] on `device`, or None for no LPIPS."""
        self.cfg = cfg
        self.state = state
        self.lpips_fn = lpips_fn
        self.device = resolve_device(device)
        set_f32_policy()
        self.benchmarker = Benchmarker(self.device)
        self.out = Path(cfg.test.output_path)
        self.out.mkdir(parents=True, exist_ok=True)
        self.face = cfg.dataset.image_shape[0] // 2

    def _to_device(self, views: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in views.items() if k != "index"}

    @torch.no_grad()
    def run(self, split: str = "test") -> dict:
        cfg = self.cfg
        shape = tuple(cfg.dataset.image_shape)
        f = self.face
        scores: dict = {}
        for ex in SceneDataset(cfg.dataset, split=split, stage="test"):
            scene = ex["scene"]
            batch = batch_examples([ex])
            ctx, tgt = self._to_device(batch["context"]), self._to_device(batch["target"])
            cubes = context_cubes(ctx["image_sphere"], f)

            with self.benchmarker.time("encoder"):
                gaussians, _ = apply_encoder(self.state.model, ctx["image_sphere"], cubes,
                                             ctx["extrinsics_sphere"], ctx["near"], ctx["far"],
                                             EVAL_GLOBAL_STEP)
            v_t = tgt["image_sphere"].shape[1]
            with self.benchmarker.time("decoder", num_calls=v_t):
                out = decoder.render_erp_views(gaussians, tgt["extrinsics_sphere"], tgt["near"],
                                               tgt["far"], shape, render_depth=cfg.test.eval_depth,
                                               backend=cfg.train.render_backend)
            n_drop = int(out.dropped.sum())
            if n_drop > 0:
                print(f"warning: {scene}: {n_drop} splats dropped by emission-cap overflow — "
                      f"rendered images are degraded")

            faces = None
            if cfg.test.eval_on_cubes:
                faces = decoder.render_cube_views(gaussians, tgt["extrinsics_sphere"], tgt["near"],
                                                  tgt["far"], (f, f),
                                                  render_depth=cfg.test.eval_depth,
                                                  backend=cfg.train.render_backend)
                pred = faces.color[0].reshape(-1, f, f, 3)
                gt = context_cubes(tgt["image_sphere"], f)[0].reshape(-1, f, f, 3)
            else:
                pred, gt = out.color[0], tgt["image_sphere"][0]
            entry = {"psnr": float(compute_psnr(gt, pred).mean()),
                     "ssim": float(compute_ssim(gt, pred).mean()),
                     "mse": float(torch.mean((pred - gt) ** 2))}
            if self.lpips_fn is not None:
                entry["lpips"] = float(self.lpips_fn(pred, gt).mean())
            if cfg.test.eval_depth and faces is not None:
                # z-depth of the cube faces against the ERP ground truth resampled
                # to faces with the distance -> z factor
                pr_d = faces.depth[0]
                if cfg.test.depth_alpha_norm:
                    pr_d = pr_d / torch.clamp(faces.alpha[0], min=1e-6)
                gt_d = torch.stack([erp_to_cube(d[..., None], f, depth_to_z=True)[..., 0]
                                    for d in tgt["depth_sphere"][0]])
                pr_d, gt_d = pr_d[:, _DEPTH_FACES], gt_d[:, _DEPTH_FACES]
                dm = compute_depth_metrics(gt_d, pr_d, gt_d > 0.1)
                entry.update({f"depth_{k}": float(v) for k, v in dm.items()})
            elif cfg.test.eval_depth and out.depth is not None:
                gt_d, pr_d = tgt["depth_sphere"][0], out.depth[0]
                if cfg.test.depth_alpha_norm:
                    pr_d = pr_d / torch.clamp(out.alpha[0], min=1e-6)
                dm = compute_depth_metrics(gt_d, pr_d, gt_d > 0.1)
                entry.update({f"depth_{k}": float(v) for k, v in dm.items()})
            scores[scene] = entry

            if cfg.test.save_image:
                self._save_images(scene, pred.cpu().numpy(), gt.cpu().numpy(), out)
        self.finalize(scores, skip=cfg.test.eval_time_skip_steps)
        return scores

    def _save_images(self, scene: str, pred: np.ndarray, gt: np.ndarray, erp) -> None:
        """The scored views or faces, their ground truth and error maps, a
        side-by-side of the first, and the ERP render's depth (eval_depth)."""
        d = self.out / scene
        for vi in range(pred.shape[0]):
            save_image(pred[vi], d / f"color/{vi:04d}.png")
            save_image(gt[vi], d / f"gt/{vi:04d}.png")
            err = np.abs(pred[vi] - gt[vi]).mean(axis=-1)
            save_image(apply_depth_colormap(err, near=0.0, far=0.5), d / f"err/{vi:04d}.png")
        save_image(hcat(pred[0], gt[0]), d / "compare.png")
        if self.cfg.test.eval_depth and erp.depth is not None:
            depth = erp.depth[0].cpu().numpy() / np.maximum(erp.alpha[0].cpu().numpy(), 1e-6)
            for vi in range(depth.shape[0]):
                save_image(apply_depth_colormap(depth[vi]), d / f"depth/{vi:04d}.png")

    def finalize(self, scores: dict, skip: int = 0) -> None:
        out = self.out
        if not scores:
            return
        keys = sorted(next(iter(scores.values())).keys())
        avg = {k: float(np.mean([s[k] for s in scores.values() if k in s])) for k in keys}
        (out / "scores_all_avg.json").write_text(json.dumps(avg, indent=2))
        for k in keys:
            (out / f"scores_{k}_all.json").write_text(
                json.dumps({s: v.get(k) for s, v in scores.items()}, indent=2))
        (out / "mse_dict.json").write_text(
            json.dumps({s: v.get("mse") for s, v in scores.items()}, indent=2))
        bench = {}
        for tag, times in self.benchmarker.execution_times.items():
            t = times[skip:] if len(times) > skip else times
            bench[tag] = {"mean_s": float(np.mean(t)) if t else None, "count": len(times)}
        (out / "benchmark.json").write_text(json.dumps(bench, indent=2))
        self.benchmarker.dump_memory(out / "peak_memory.json")
        print("scores_all_avg:", avg)
