"""Profile one serving encode at HM3D width on the card.

    python -m splatter360_tpu_torch.profile_encode [--views 2 3] [--precision f32 bf16] [--seed 0]

For each precision of the flagship model (f32: HM3D_F32; bf16: HM3D, the
bf16 compute of configs/hm3d.yaml) and each number of context panoramas
(512x1024, seeded random weights and inputs): one warm-up encode, then one
encode under torch.profiler with device activity only. Prints its
host-clock time, the device time summed over its kernels and the kernels
that take the most of it.
"""

from __future__ import annotations

import argparse
import time

import torch

from .models.encoder import HM3D, HM3D_F32
from .serve import build_model, encode

H, W = 512, 1024
# device-side records of the profiler's own buffer handling, not work
PROFILER_RECORDS = ("Buffer Flush", "Activity Buffer Request")


def context_inputs(n_ctx: int, seed: int, device: str = "cuda"):
    """n_ctx smooth seeded panoramas [1, n_ctx, H, W, 3], poses spread
    around the origin, near 0.1 and far 10."""
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.rand((n_ctx, 3, H // 8, W // 8), generator=gen, device=device)
    img = torch.nn.functional.interpolate(img, size=(H, W), mode="bilinear", align_corners=False)
    pose = torch.eye(4, device=device).repeat(1, n_ctx, 1, 1)
    pose[..., :3, 3] = 0.3 * torch.randn((1, n_ctx, 3), generator=gen, device=device)
    near = torch.full((1, n_ctx), 0.1, device=device)
    return img.permute(0, 2, 3, 1)[None].contiguous(), pose, near, 100 * near


def profile_encode(model, inputs, rows: int = 8) -> str:
    """One encode of `inputs` under torch.profiler: a line with its
    host-clock ms, device ms over its kernels and its top `rows` kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode(model, *inputs)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)

    def device_ms(e):
        return e.self_device_time_total / 1e3

    kernels = [e for e in prof.key_averages() if e.key not in PROFILER_RECORDS]
    busy = sum(device_ms(e) for e in kernels)
    top = sorted(kernels, key=device_ms, reverse=True)[:rows]
    return (f"{wall:.1f} ms host clock, {busy:.1f} ms of device time summed over "
            f"{sum(e.count for e in kernels)} kernel launches; most device time: "
            + "; ".join(f"{e.key[:90]} {device_ms(e):.1f} ms x{e.count}" for e in top))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--precision", nargs="+", choices=("f32", "bf16"), default=["f32"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for precision in args.precision:
        model = build_model(HM3D if precision == "bf16" else HM3D_F32, seed=args.seed)
        for n_ctx in args.views:
            inputs = context_inputs(n_ctx, args.seed + 1)
            encode(model, *inputs)  # warm-up
            print(f"[{precision}, {n_ctx} context panoramas] encode under the profiler: "
                  f"{profile_encode(model, inputs)}", flush=True)
        del model


if __name__ == "__main__":
    main()
