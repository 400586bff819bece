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

With test.save_video, each scene also gets a video of
`test.video_trajectory` (`render_video`: 60 frames, one render call a
frame) as <scene>/<trajectory>.mp4, and with eval_depth its depth video.
Unlike JAX's Evaluator, which prints a warning for any failure of the
export, only a failed write of the files is printed and skipped: a render
failure propagates.

The metrics are computed on the device; only what is written moves to the
host. Band-sharded decoding (`shard_render`) acts as off on one device, as
in JAX, and across cards is not ported (ROADMAP.md Queue 1 item 4). The
state's encoder is the one to score: with add_mono_feat its ViT comes from
the checkpoint, and no warm start is made here (nor in JAX's Evaluator).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import SceneDataset, batch_examples
from ..device import resolve_device, set_f32_policy
from ..geometry.cubemap import erp_to_cube
from ..geometry.transforms import interpolate_pose_6d, trajectory_spin, trajectory_wobble
from ..models import decoder
from ..models.encoder import apply_encoder
from ..serve import EVAL_GLOBAL_STEP, context_cubes
from ..utils.benchmarker import Benchmarker
from ..utils.image_io import apply_depth_colormap, hcat, save_image, save_video
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
            if cfg.test.save_video:
                traj = cfg.test.video_trajectory
                self.render_video(gaussians, ctx["extrinsics_sphere"][0],
                                  float(tgt["near"][0, 0]), float(tgt["far"][0, 0]),
                                  self.out / scene / f"{traj}.mp4", trajectory=traj,
                                  with_depth=cfg.test.eval_depth)
        self.finalize(scores, skip=cfg.test.eval_time_skip_steps)
        return scores

    @torch.no_grad()
    def render_video(self, gaussians, ctx_extr, near: float, far: float, path, n_frames: int = 60,
                     trajectory: str = "interpolate", with_depth: bool = False) -> None:
        """A video of `n_frames` ERP frames at t = linspace(0, 1, n_frames)
        along `trajectory`: "interpolate" from the first context pose
        (ctx_extr [V, 4, 4]) to the last (interpolate_pose_6d), "wobble" a
        circle about the first of a quarter of the baseline between the
        first and the last, "spin" a yaw about the first; any other name
        interpolates. Each frame is its own render call of one view, as in
        JAX. With `with_depth`, also `<stem>_depth.mp4`: depth / max(alpha,
        1e-6), colour-mapped between the whole video's least and greatest
        depth. A failed write is printed and skipped."""
        shape = tuple(self.cfg.dataset.image_shape)
        nf = [torch.full((1, 1), v, device=ctx_extr.device) for v in (near, far)]
        first, last = ctx_extr[0], ctx_extr[-1]
        radius = 0.25 * float(np.linalg.norm((last[:3, 3] - first[:3, 3]).cpu().numpy()))
        frames, depths = [], []
        for t in np.linspace(0, 1, n_frames):
            if trajectory == "wobble":
                pose = trajectory_wobble(first, radius, float(t))
            elif trajectory == "spin":
                pose = trajectory_spin(first, float(t))
            else:
                pose = interpolate_pose_6d(first, last, float(t))
            out = decoder.render_erp_views(gaussians, pose[None, None], *nf, shape,
                                           render_depth=with_depth,
                                           backend=self.cfg.train.render_backend)
            frames.append(out.color[0, 0].cpu().numpy())
            if with_depth:
                depths.append(out.depth[0, 0].cpu().numpy()
                              / np.maximum(out.alpha[0, 0].cpu().numpy(), 1e-6))
        path = Path(path)
        try:
            save_video(frames, path)
            if with_depth:
                lo = min(float(d.min()) for d in depths)
                hi = max(float(d.max()) for d in depths)
                save_video([apply_depth_colormap(d, lo, hi) for d in depths],
                           path.with_name(path.stem + "_depth.mp4"))
        except OSError as e:
            print(f"warning: writing the video {path} failed: {e}")

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
