"""The training loop: the CLI's `mode=train`.

Counterpart of splatter360_tpu/train/trainer.py (`Prefetcher`, `Validator`,
`Trainer.fit`) on one device:

    Trainer(cfg, device="cuda").fit()   # -> the TrainState after max_steps

Batches are drawn from the train split in a background thread (a queue of
2); the dataset is seeded `trainer.seed` and its bounded sampler reads the
step from the StepTracker, which the loop sets after each update (from the
prefetch thread, so a batch may be sampled a step or two behind it, as in
JAX). The first batch is drawn before the state is built; with
`checkpointing.resume` the state is restored from <output_dir>/checkpoints
(the data stream starts again from its seed: data is not checkpointed), and
at step 0 `checkpointing.pretrained_model` is a weights-only warm start,
then `checkpointing.pretrained_backbone` loads a UniMatch gmdepth weight
file into both multiview backbones (checkpoint.warm_start_backbones), then
`checkpointing.pretrained_mono` a DINOv2 weight file into the frozen mono
ViT (add_mono_feat; checkpoint.warm_start_mono). A resumed run (step > 0)
takes none of them.
Each step is train.state.train_step. Metrics reach the host only at a log
step (`step % print_log_every_n_steps == 0 or step <= 1`): printed and
written as `train/<metric>` scalars to <output_dir>/tb (utils/tb_events.py).
Every `val_check_interval` steps (and at step 0 with num_sanity_val_steps >
0) the Validator scores one held-out example; a failure there is printed and
training goes on. Checkpoints every `every_n_train_steps` steps and at the
end, keeping `max_to_keep`. `trainer.profile_steps` > 0 traces steps
[profile_start, profile_start + profile_steps) with torch.profiler into
<output_dir>/profile/. The global batch is the device's batch: the data
mesh and face sharding across cards are not ported (ROADMAP.md Queue 1
item 4); on one device train.shard_faces and shard_render act as off, as
in JAX.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import SceneDataset, batch_examples, batches
from ..device import resolve_device
from ..geometry.transforms import interpolate_pose_6d
from ..models import decoder
from ..models.encoder import apply_encoder
from ..serve import context_cubes
from ..utils.image_io import add_label, apply_depth_colormap, hcat, save_image, save_video, vcat
from ..utils.step_tracker import StepTracker
from ..utils.tb_events import SummaryWriter
from . import checkpoint as ckpt
from .metrics import compute_psnr, compute_ssim
from .state import _on_device, create_train_state, mono_grid, train_step

# frames of the validation's interpolation video, and its rate
VIDEO_FRAMES, VIDEO_FPS = 12, 8


class _Raised:
    """The exception that ended the prefetch thread, queued for the reader."""

    def __init__(self, error: BaseException):
        self.error = error


class Prefetcher:
    """Items of `iterator` drawn ahead in a daemon thread, through a queue
    of `depth`. An exception the iterator raises is raised again to the
    reader after the items drawn before it. close() stops the thread (also
    when the iterator is endless, as the train stream is)."""

    def __init__(self, iterator, depth: int = 2):
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._it = iterator
        self._done = object()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _run(self):
        end = self._done
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - handed to the reader
            end = _Raised(e)
        finally:
            self._put(end)

    def __iter__(self):
        while True:
            item = self.queue.get()
            if item is self._done:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self.thread.join(timeout)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


class Validator:
    """One held-out example a validation: PSNR and SSIM of its target ERP
    views (`val/psnr`, `val/ssim`), and under <out>/val/<step:08d>/ the
    labelled sheet of gt, prediction and rendered depth (comparison.png),
    the encoder's depth (encoder_depth.png), the encoder's debug sheet
    (encoder_vis.png) and a VIDEO_FRAMES-frame video along the context
    poses (interpolation.mp4, or its PNG frame directory)."""

    def __init__(self, cfg, out_dir, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.out = Path(out_dir)
        self.device = resolve_device(device)
        self.example = None  # loaded at the first run (the val split may be absent)
        self.face = cfg.dataset.image_shape[0] // 2

    def _load_example(self):
        if self.example is not None:
            return self.example
        for split in ("val", "test"):
            try:
                ds = SceneDataset(self.cfg.dataset, split=split, stage="val")
                for ex in ds:
                    self.example = batch_examples([ex])
                    return self.example
            except Exception as e:
                # a broken val split must not look like an absent one: say what
                # failed, then try the next split
                print(f"warning: loading '{split}' validation example failed: "
                      f"{type(e).__name__}: {e}")
        print("warning: no validation example available (no val/test split under "
              "dataset.roots) — validation skipped")
        return None

    def _decode(self, gaussians, extr, near, far, render_depth=False):
        return decoder.render_erp_views(gaussians, extr, near, far,
                                        tuple(self.cfg.dataset.image_shape),
                                        render_depth=render_depth,
                                        backend=self.cfg.train.render_backend)

    @torch.no_grad()
    def run(self, state, step: int, writer=None) -> dict:
        from ..models.visualizer import visualize_gaussians

        batch = self._load_example()
        if batch is None:
            return {}
        views = _on_device(batch, self.device)
        ctx, tgt = views["context"], views["target"]
        cubes = context_cubes(ctx["image_sphere"], self.face)
        gaussians, pred_depth = apply_encoder(state.model, ctx["image_sphere"], cubes,
                                              ctx["extrinsics_sphere"], ctx["near"], ctx["far"],
                                              step)
        out = self._decode(gaussians, tgt["extrinsics_sphere"], tgt["near"], tgt["far"],
                           render_depth=True)
        metrics = {"psnr": float(compute_psnr(tgt["image_sphere"][0], out.color[0]).mean()),
                   "ssim": float(compute_ssim(tgt["image_sphere"][0], out.color[0]).mean())}
        if writer is not None:
            for k, v in metrics.items():
                writer.add_scalar(f"val/{k}", v, step)

        vdir = self.out / "val" / f"{step:08d}"
        pred, gt = _host(out.color[0]), _host(tgt["image_sphere"][0])
        rows = [add_label(hcat(*gt), "target gt"), add_label(hcat(*pred), "target pred")]
        if out.depth is not None:
            d = _host(out.depth[0]) / np.maximum(_host(out.alpha[0]), 1e-6)
            rows.append(add_label(hcat(*[apply_depth_colormap(x) for x in d]), "rendered depth"))
        save_image(vcat(*rows), vdir / "comparison.png")
        if pred_depth is not None:
            enc_d = _host(pred_depth[0, 0])
            if enc_d.ndim == 3:
                enc_d = enc_d[..., 0]
            save_image(apply_depth_colormap(enc_d), vdir / "encoder_depth.png")
        try:
            sheet = visualize_gaussians(gaussians, pred_depth, ctx["image_sphere"],
                                        tuple(self.cfg.dataset.image_shape))
            save_image(sheet, vdir / "encoder_vis.png")
        except Exception as e:
            print(f"warning: encoder visualizer failed: {e}")
        try:
            extr = ctx["extrinsics_sphere"][0]
            frames = []
            for t in np.linspace(0, 1, VIDEO_FRAMES):
                pose = interpolate_pose_6d(extr[0], extr[-1], float(t))
                o = self._decode(gaussians, pose[None, None], tgt["near"][:, :1],
                                 tgt["far"][:, :1])
                frames.append(_host(o.color[0, 0]))
            save_video(frames, vdir / "interpolation.mp4", fps=VIDEO_FPS)
        except Exception as e:  # the video must not stop training
            print(f"warning: val video failed: {e}")
        print(f"val step {step}: psnr={metrics['psnr']:.3f} ssim={metrics['ssim']:.4f}")
        return metrics


class Trainer:
    def __init__(self, cfg, log_dir: str | None = None, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.out = Path(cfg.output_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.step_tracker = StepTracker()
        self.log_dir = Path(log_dir) if log_dir is not None else self.out / "tb"
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "host")
        print(f"training on {self.device} ({name}), batch {cfg.trainer.batch_size}")

    def fit(self):
        cfg = self.cfg
        dataset = SceneDataset(cfg.dataset, split="train", stage="train", seed=cfg.trainer.seed,
                               step_fn=self.step_tracker.get_step)
        if not dataset.scenes:
            raise SystemExit(f"no train scenes found under {list(cfg.dataset.roots)}")
        writer = SummaryWriter(self.log_dir)
        prefetcher = Prefetcher(batches(dataset, cfg.trainer.batch_size))
        try:
            return self._fit(prefetcher, writer)
        finally:
            prefetcher.close()
            writer.close()

    def _fit(self, prefetcher: Prefetcher, writer: SummaryWriter):
        cfg, dev = self.cfg, self.device
        batch_iter = iter(prefetcher)
        first = next(batch_iter)
        h = first["context"]["image_sphere"].shape[2]
        state = create_train_state(cfg.model, cfg.train, seed=cfg.trainer.seed, device=dev,
                                   mono_grid=mono_grid(cfg.train, h))

        ckpt_dir = self.out / "checkpoints"
        if cfg.checkpointing.resume:
            state, resumed = ckpt.restore_checkpoint(ckpt_dir, state)
            if resumed:
                print(f"resumed from step {state.step}")
        if cfg.checkpointing.pretrained_model and state.step == 0:
            state, ok = ckpt.restore_weights_only(
                ckpt.resolve_checkpoint_uri(cfg.checkpointing.pretrained_model), state)
            if ok:
                print("warm-started weights from pretrained_model")
        if cfg.checkpointing.pretrained_backbone and state.step == 0:
            n = ckpt.warm_start_backbones(
                state.model, ckpt.resolve_checkpoint_uri(cfg.checkpointing.pretrained_backbone))
            print(f"warm-started both backbones from pretrained_backbone ({n} leaves)")
        if cfg.checkpointing.pretrained_mono and state.step == 0:
            n = ckpt.warm_start_mono(
                state.model, ckpt.resolve_checkpoint_uri(cfg.checkpointing.pretrained_mono))
            print(f"warm-started the mono branch from pretrained_mono ({n} leaves)")

        validator = Validator(cfg, self.out, dev)
        if cfg.trainer.num_sanity_val_steps > 0 and state.step == 0:
            # the whole validation path once before the long loop
            validator.run(state, state.step, writer)

        prof_lo = cfg.trainer.profile_start
        prof_hi = prof_lo + cfg.trainer.profile_steps
        profiler = None

        batch = first
        t0 = time.perf_counter()
        while state.step < cfg.trainer.max_steps:
            if cfg.trainer.profile_steps > 0:
                if profiler is None and prof_lo <= state.step < prof_hi:
                    profiler = self._start_profiler()
                elif profiler is not None and state.step >= prof_hi:
                    self._stop_profiler(profiler, prof_lo, prof_hi)
                    profiler = None
            metrics = train_step(state, batch)
            step = state.step
            self.step_tracker.set_step(step)

            if step % cfg.trainer.print_log_every_n_steps == 0 or step <= 1:
                host = {k: float(v) for k, v in sorted(metrics.items())}
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                print(f"step {step}: " + "; ".join(f"{k}={v:.4f}" for k, v in host.items())
                      + f" ({dt:.1f}s)")
                for k, v in host.items():
                    writer.add_scalar(f"train/{k}", v, step)

            if (cfg.trainer.val_check_interval > 0 and step % cfg.trainer.val_check_interval == 0
                    and step > 0):
                try:
                    validator.run(state, step, writer)
                except Exception as e:  # validation must not stop training
                    print(f"warning: validation failed at step {step}: {e}")

            if step % cfg.checkpointing.every_n_train_steps == 0 and step > 0:
                ckpt.save_checkpoint(ckpt_dir, step, state, cfg.checkpointing.max_to_keep)

            batch = next(batch_iter)

        if profiler is not None:
            self._stop_profiler(profiler, prof_lo, prof_hi)
        ckpt.save_checkpoint(ckpt_dir, state.step, state, cfg.checkpointing.max_to_keep)
        return state

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, lo: int, hi: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        path = self.out / "profile" / f"trace_steps_{lo}_{hi}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(path))
        print(f"profiler trace written to {path}")
