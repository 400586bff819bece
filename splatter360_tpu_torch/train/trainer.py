"""The training loop: the CLI's `mode=train`.

Counterpart of splatter360_tpu/train/trainer.py (`Prefetcher`, `Validator`,
`Trainer.fit`):

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
<output_dir>/profile/.

Across cards (one process a card under torchrun, parallel/mesh.py), a rank
plays the part of a JAX process that owns one device, so K ranks are JAX's
multi-host mode with one device a host. trainer.batch_size is the global
batch. The rank grid is chosen as JAX chooses its mesh: with
train.shard_faces and cube supervision a (data, face) grid from
face_mesh_split(batch, 6 * target views, K), else K data ranks. The
port runs no idle rank, where JAX shrinks its mesh and warns: a batch the
data ranks do not split equally raises (local_batch_size), and so does a
face split that leaves a rank out. Rank r sits at data index
d = r // n_face and loads SceneDataset(seed=trainer.seed + d, shard_index=d,
num_shards=n_data), local_batch_size(batch, n_data) examples a step, as
JAX's process d does (trainer.py:264-268): with K data ranks, rank r loads
shard r with seed trainer.seed + r. The ranks of a face group take the
batch of its first rank (a broadcast each step). Every rank builds the
state, resumes and warm-starts alike, then takes rank 0's parameters (a
broadcast); train_step averages the gradients over the ranks before the
clip. Rank 0 alone prints, writes TensorBoard scalars, profiles and saves
checkpoints, and a barrier follows each save. With train.shard_render every
rank runs the Validator (its ERP decode is band-sharded over all ranks, a
collective, around which nothing is caught) and rank 0 scores and writes;
without it rank 0 validates alone while the others wait at a barrier.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import SceneDataset, batch_examples, batches
from ..device import resolve_device
from ..geometry.transforms import interpolate_pose_6d
from ..models.encoder import apply_encoder
from ..parallel.mesh import (create_rank_grid, face_mesh_split, local_batch_size,
                             maybe_initialize_distributed, world_size)
from ..parallel.render_sharding import decode_erp, shards_erp
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
    poses (interpolation.mp4, or its PNG frame directory).

    With train.shard_render and a `comm` of more than one rank (`sharded`),
    the ERP decodes are band-sharded over it (parallel/render_sharding.
    decode_erp): every rank runs `decode`, and only the main rank `report`s
    (scores and writes). `run` is the two in turn."""

    def __init__(self, cfg, out_dir, device: str | torch.device = "cuda", comm=None,
                 is_main: bool = True):
        self.cfg = cfg
        self.out = Path(out_dir)
        self.device = resolve_device(device)
        self.example = None  # loaded at the first run (the val split may be absent)
        self.face = cfg.dataset.image_shape[0] // 2
        self.comm = comm
        self.sharded = shards_erp(cfg, comm)
        self.is_main = is_main

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
        return decode_erp(self.cfg, self.comm, gaussians, extr, near, far,
                          render_depth=render_depth)

    @torch.no_grad()
    def run(self, state, step: int, writer=None) -> dict:
        decoded = self.decode(state, step)
        if decoded is None or not self.is_main:
            return {}
        return self.report(decoded, step, writer)

    @torch.no_grad()
    def decode(self, state, step: int):
        """The encoder on the example and every ERP decode of a validation:
        the target views, then the video's frames. Under a sharded decode
        nothing is caught here: the decodes are collectives, and a rank that
        left one on an error would leave the others waiting in it. On one
        rank a failed video render is kept for `report` to print, as in JAX.
        None without a validation example."""
        batch = self._load_example()
        if batch is None:
            return None
        views = _on_device(batch, self.device)
        ctx, tgt = views["context"], views["target"]
        cubes = context_cubes(ctx["image_sphere"], self.face)
        gaussians, pred_depth = apply_encoder(state.model, ctx["image_sphere"], cubes,
                                              ctx["extrinsics_sphere"], ctx["near"], ctx["far"],
                                              step)
        out = self._decode(gaussians, tgt["extrinsics_sphere"], tgt["near"], tgt["far"],
                           render_depth=True)
        frames, video_error = [], None
        try:
            extr = ctx["extrinsics_sphere"][0]
            for t in np.linspace(0, 1, VIDEO_FRAMES):
                pose = interpolate_pose_6d(extr[0], extr[-1], float(t))
                o = self._decode(gaussians, pose[None, None], tgt["near"][:, :1],
                                 tgt["far"][:, :1])
                frames.append(o.color[0, 0])
        except Exception as e:  # the video must not stop training
            if self.sharded:
                raise
            video_error = e
        return dict(ctx=ctx, tgt=tgt, gaussians=gaussians, pred_depth=pred_depth, out=out,
                    frames=frames, video_error=video_error)

    def report(self, decoded: dict, step: int, writer=None) -> dict:
        """The main rank's part: the scores (and `writer`'s scalars), the
        images and the video of `decode`'s result."""
        from ..models.visualizer import visualize_gaussians

        ctx, tgt, out = decoded["ctx"], decoded["tgt"], decoded["out"]
        gaussians, pred_depth = decoded["gaussians"], decoded["pred_depth"]
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
            if decoded["video_error"] is not None:
                raise decoded["video_error"]
            save_video([_host(f) for f in decoded["frames"]], vdir / "interpolation.mp4",
                       fps=VIDEO_FPS)
        except Exception as e:  # the video must not stop training
            print(f"warning: val video failed: {e}")
        print(f"val step {step}: psnr={metrics['psnr']:.3f} ssim={metrics['ssim']:.4f}")
        return metrics


class Trainer:
    def __init__(self, cfg, log_dir: str | None = None, device: str | torch.device = "cuda"):
        # the process group first (untouched outside torchrun)
        self.device = maybe_initialize_distributed(device)
        self.cfg = cfg
        world, batch = world_size(), cfg.trainer.batch_size
        if cfg.train.shard_faces and cfg.train.supervision == "cubes":
            # v*6 supervision faces an example; v from the view sampler
            n_faces = 6 * cfg.dataset.view_sampler.num_target_views
            with warnings.catch_warnings():
                # its warning speaks of idle devices: the port refuses them below
                warnings.simplefilter("ignore")
                n_data, n_face = face_mesh_split(batch, n_faces, world)
            if n_data * n_face != world:
                raise ValueError(
                    f"shard_faces: batch {batch} x {n_faces} faces splits over a {n_data}x"
                    f"{n_face} (data, face) grid, which leaves {world - n_data * n_face} of "
                    f"{world} ranks idle; every rank must take part")
            grid_msg = f"(data, face) rank grid: {n_data}x{n_face}"
        else:
            n_data, n_face = world, 1
            grid_msg = f"data grid: {n_data} rank(s)"
        # raises on a batch the data ranks do not split equally
        self.local_batch = local_batch_size(batch, n_data)
        self.grid = create_rank_grid(n_data, n_face)
        self.is_main = self.grid.is_main
        self.out = Path(cfg.output_dir)
        if self.is_main:
            self.out.mkdir(parents=True, exist_ok=True)
        self.step_tracker = StepTracker()
        self.log_dir = Path(log_dir) if log_dir is not None else self.out / "tb"
        if self.is_main:
            name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                    else "host")
            print(f"training on {self.device} ({name}), global batch {batch}, {grid_msg} of "
                  f"{world} rank(s), {self.local_batch} example(s) a rank")

    def fit(self):
        cfg, d = self.cfg, self.grid.data_index
        dataset = SceneDataset(cfg.dataset, split="train", stage="train", seed=cfg.trainer.seed + d,
                               shard_index=d, num_shards=self.grid.n_data,
                               step_fn=self.step_tracker.get_step)
        if not dataset.scenes:
            raise SystemExit(f"no train scenes found under {list(cfg.dataset.roots)} "
                             f"(shard {d} of {self.grid.n_data})")
        writer = SummaryWriter(self.log_dir) if self.is_main else None
        prefetcher = Prefetcher(batches(dataset, self.local_batch))
        try:
            return self._fit(prefetcher, writer)
        finally:
            prefetcher.close()
            if writer is not None:
                writer.close()

    def _say(self, text: str) -> None:
        if self.is_main:
            print(text)

    def _validate(self, validator, state, step: int, writer, catch: bool = True) -> None:
        """Validate, then meet at a barrier. Sharded, every rank decodes and
        only the main rank's report is caught (a failure in the collective
        decodes ends the run on every rank: caught on one, it would leave
        the others waiting); unsharded, the main rank validates alone and
        any failure is caught. With catch False nothing is caught."""

        def caught(fn):
            try:
                fn()
            except Exception as e:  # validation must not stop training
                if not catch:
                    raise
                print(f"warning: validation failed at step {step}: {e}")

        if validator.sharded:
            decoded = validator.decode(state, step)
            if self.is_main and decoded is not None:
                caught(lambda: validator.report(decoded, step, writer))
        elif self.is_main:
            caught(lambda: validator.run(state, step, writer))
        self.grid.world.barrier()

    def _save(self, ckpt_dir: Path, state) -> None:
        if self.is_main:
            ckpt.save_checkpoint(ckpt_dir, state.step, state, self.cfg.checkpointing.max_to_keep)
        self.grid.world.barrier()

    def _fit(self, prefetcher: Prefetcher, writer):
        cfg, dev, grid = self.cfg, self.device, self.grid
        batch_iter = iter(prefetcher)
        first = grid.share_batch(next(batch_iter))
        h = first["context"]["image_sphere"].shape[2]
        state = create_train_state(cfg.model, cfg.train, seed=cfg.trainer.seed, device=dev,
                                   mono_grid=mono_grid(cfg.train, h))

        ckpt_dir = self.out / "checkpoints"
        if cfg.checkpointing.resume:
            state, resumed = ckpt.restore_checkpoint(ckpt_dir, state)
            if resumed:
                self._say(f"resumed from step {state.step} ({ckpt.describe(ckpt_dir)})")
        if cfg.checkpointing.pretrained_model and state.step == 0:
            src = ckpt.resolve_checkpoint_uri(cfg.checkpointing.pretrained_model)
            state, ok = ckpt.restore_weights_only(src, state)
            if ok:
                self._say(f"warm-started weights from pretrained_model ({ckpt.describe(src)})")
        if cfg.checkpointing.pretrained_backbone and state.step == 0:
            n = ckpt.warm_start_backbones(
                state.model, ckpt.resolve_checkpoint_uri(cfg.checkpointing.pretrained_backbone))
            self._say(f"warm-started both backbones from pretrained_backbone ({n} leaves)")
        if cfg.checkpointing.pretrained_mono and state.step == 0:
            n = ckpt.warm_start_mono(
                state.model, ckpt.resolve_checkpoint_uri(cfg.checkpointing.pretrained_mono))
            self._say(f"warm-started the mono branch from pretrained_mono ({n} leaves)")
        # every rank starts from rank 0's weights (JAX's replicate)
        grid.world.broadcast_([*state.model.parameters(), *state.model.buffers()])

        validator = Validator(cfg, self.out, dev, comm=grid.world, is_main=self.is_main)
        if cfg.trainer.num_sanity_val_steps > 0 and state.step == 0:
            # the whole validation path once before the long loop
            self._validate(validator, state, state.step, writer, catch=False)

        prof_lo = cfg.trainer.profile_start
        prof_hi = prof_lo + cfg.trainer.profile_steps
        profiler = None

        batch = first
        t0 = time.perf_counter()
        while state.step < cfg.trainer.max_steps:
            if cfg.trainer.profile_steps > 0 and self.is_main:
                if profiler is None and prof_lo <= state.step < prof_hi:
                    profiler = self._start_profiler()
                elif profiler is not None and state.step >= prof_hi:
                    self._stop_profiler(profiler, prof_lo, prof_hi)
                    profiler = None
            metrics = train_step(state, batch, grid=grid)
            step = state.step
            self.step_tracker.set_step(step)

            if (step % cfg.trainer.print_log_every_n_steps == 0 or step <= 1) and self.is_main:
                host = {k: float(v) for k, v in sorted(metrics.items())}
                dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                print(f"step {step}: " + "; ".join(f"{k}={v:.4f}" for k, v in host.items())
                      + f" ({dt:.1f}s)")
                for k, v in host.items():
                    writer.add_scalar(f"train/{k}", v, step)

            if (cfg.trainer.val_check_interval > 0 and step % cfg.trainer.val_check_interval == 0
                    and step > 0):
                self._validate(validator, state, step, writer)

            if step % cfg.checkpointing.every_n_train_steps == 0 and step > 0:
                self._save(ckpt_dir, state)

            batch = grid.share_batch(next(batch_iter))

        if profiler is not None:
            self._stop_profiler(profiler, prof_lo, prof_hi)
        self._save(ckpt_dir, state)
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
