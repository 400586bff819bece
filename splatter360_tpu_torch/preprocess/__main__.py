"""Generate a procedural RGB-D panorama dataset.

    python -m splatter360_tpu_torch.preprocess <root> [n_train] [n_test] \
        [--frames N] [--shape HxW] [--spacing S] [--via-cubes] [--seed K] \
        [--validate] [--device cpu]

Counterpart of scripts/generate_dataset.py: the same scenes (train
proc00000, proc00001, ... with seeds seed + i; test proc10000, ... with
seeds seed + 10000 + i) and, with --validate, the same cross-view
consistency asserts a scene. Renders on the card; `--device cpu` only when
asked for, never as a fallback.
"""

from __future__ import annotations

import argparse
import sys

from .generate import generate_scene
from .validate import check_scene_consistency


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m splatter360_tpu_torch.preprocess")
    ap.add_argument("root")
    ap.add_argument("n_train", type=int, nargs="?", default=4)
    ap.add_argument("n_test", type=int, nargs="?", default=1)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--shape", default="128x256")
    ap.add_argument("--spacing", type=float, default=0.09)
    ap.add_argument("--via-cubes", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validate", action="store_true",
                    help="cross-view RGB-D consistency check per scene")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    h, w = (int(x) for x in args.shape.lower().split("x"))

    infos = []
    for split, count, base in (("train", args.n_train, 0), ("test", args.n_test, 10_000)):
        for i in range(count):
            scene = f"proc{base + i:05d}"
            info = generate_scene(args.root, split, scene, n_frames=args.frames,
                                  image_shape=(h, w), seed=args.seed + base + i,
                                  spacing=args.spacing, via_cubes=args.via_cubes,
                                  device=args.device)
            print(split, info, flush=True)
            if args.validate:
                stats = check_scene_consistency(args.root, split, scene)
                print(split, "consistency", stats, flush=True)
                assert stats["coverage"] > 0.05, "degenerate scene geometry"
                assert stats["depth_absrel"] < 0.05, "inconsistent depth"
                info["consistency"] = stats
            infos.append(info)
    return infos


if __name__ == "__main__":
    main()
