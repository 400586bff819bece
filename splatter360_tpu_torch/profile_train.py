"""Time the flagship train step on the card, and find the largest batch that fits.

    python -m splatter360_tpu_torch.profile_train [--precision bf16 f32] [--steps 4]
                                                  [--batches 1 2 3 4 6 8] [--seed 0]

The model and train blocks of configs/hm3d.yaml (ERP supervision, LPIPS,
depth L1, clip + Adam; bf16: the file's bf16 compute, f32: the same model
with bf16_compute off), seeded random weights, seeded batches of 2 context
and 4 target 512x1024 panoramas. For each precision, `steps` train steps at
B = 1: each step's ms by stage (CUDA events at train_step's marks:
encoder, render, losses, backward, optimizer), the GiB allocated at each
mark (what the stages so far hold for the backward), its host-clock ms and
its peak allocated GiB. Then, in bf16, two steps at each B of `batches` in
turn: the second step's ms and the peak GiB, until a B runs out of memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from pathlib import Path

import torch

from .config import load_config
from .train.state import create_train_state, train_step

H, W = 512, 1024
N_CTX, N_TGT = 2, 4
STAGES = ("encoder", "render", "losses", "backward", "optimizer")
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "hm3d.yaml"


def train_batch(gen: torch.Generator, b: int) -> dict:
    """b examples: smooth random panoramas, poses spread around the origin,
    context depth in [0.5, 5] m with ~8% holes, near 0.1 and far 10."""
    def images(v):
        x = torch.rand((b * v, 3, H // 8, W // 8), generator=gen, device="cuda")
        x = torch.nn.functional.interpolate(x, size=(H, W), mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1).reshape(b, v, H, W, 3).contiguous()

    def poses(v):
        p = torch.eye(4, device="cuda").repeat(b, v, 1, 1)
        p[..., :3, 3] = 0.3 * torch.randn((b, v, 3), generator=gen, device="cuda")
        return p

    depth = 0.5 + 4.5 * torch.rand((b, N_CTX, H, W), generator=gen, device="cuda")
    holes = torch.rand((b, N_CTX, H // 16, W // 16), generator=gen, device="cuda") < 0.08
    holes = holes.repeat_interleave(16, dim=2).repeat_interleave(16, dim=3)
    near = torch.full((b, N_CTX), 0.1, device="cuda")
    near_t = torch.full((b, N_TGT), 0.1, device="cuda")
    return dict(
        context=dict(image_sphere=images(N_CTX), extrinsics_sphere=poses(N_CTX),
                     depth_sphere=torch.where(holes, torch.zeros_like(depth), depth),
                     near=near, far=100 * near),
        target=dict(image_sphere=images(N_TGT), extrinsics_sphere=poses(N_TGT), near=near_t,
                    far=100 * near_t))


def timed_step(state, batch) -> dict:
    """One train step: host-clock ms, ms by stage, GiB allocated at each
    stage's end and peak allocated GiB."""
    events = {"start": torch.cuda.Event(enable_timing=True)}
    held = {}

    def mark(stage):
        events[stage] = torch.cuda.Event(enable_timing=True)
        events[stage].record()
        held[stage] = torch.cuda.memory_allocated() / 2**30

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    events["start"].record()
    metrics = train_step(state, batch, on_stage=mark)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    ms, prev = {}, "start"
    for stage in STAGES:
        ms[stage] = events[prev].elapsed_time(events[stage])
        prev = stage
    return dict(wall_ms=wall, stage_ms=ms, held_gib=held,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, loss=float(metrics["loss"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", nargs="+", default=["bf16", "f32"], choices=["bf16", "f32"])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 2, 3, 4, 6, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    cfg = load_config(str(CONFIG))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)} ({smi or 'nvidia-smi gave nothing'})",
          flush=True)
    for name in args.precision:
        model_cfg = dataclasses.replace(cfg.model, bf16_compute=(name == "bf16"))
        state = create_train_state(model_cfg, cfg.train, seed=args.seed, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
        for i in range(args.steps):
            r = timed_step(state, train_batch(gen, 1))
            print(f"{name} B=1 step {i}: {r['wall_ms']:.1f} ms host clock; "
                  + ", ".join(f"{k} {v:.1f}" for k, v in r["stage_ms"].items())
                  + " ms; GiB held after "
                  + ", ".join(f"{k} {v:.2f}" for k, v in r["held_gib"].items())
                  + f"; peak {r['peak_gib']:.2f} GiB; loss {r['loss']:.5f}", flush=True)
        del state
        torch.cuda.empty_cache()
    for b in args.batches:
        state = None
        try:
            state = create_train_state(cfg.model, cfg.train, seed=args.seed, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
            timed_step(state, train_batch(gen, b))
            r = timed_step(state, train_batch(gen, b))
            print(f"bf16 B={b}: {r['wall_ms']:.1f} ms a step ({r['wall_ms'] / b:.1f} ms an "
                  f"example); peak {r['peak_gib']:.2f} GiB allocated, "
                  f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved", flush=True)
        except torch.cuda.OutOfMemoryError:
            print(f"bf16 B={b}: out of memory "
                  f"({torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB card)",
                  flush=True)
            break
        finally:
            del state
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
