"""The command line of the PyTorch port.

    python -m splatter360_tpu_torch.main [config.yaml] [mode=...] [a.b=c ...] [--device cpu]

Counterpart of splatter360_tpu/main.py: builds the RootConfig from the YAML
file and dotted overrides (config.py), then runs the mode:
  * train: train the encoder (train/trainer.py: Trainer(cfg).fit()), with
    resume from <output_dir>/checkpoints, validation, TensorBoard scalars
    and checkpoints under <output_dir>;
  * test: evaluate the encoder restored (weights only) from
    checkpointing.load (a directory or wandb://run[:vN]) or
    <output_dir>/checkpoints, holding the port's checkpoint.pt steps or the
    JAX package's orbax steps, on the test split (train/evaluator.py);
  * generate_index: write <output_dir>/evaluation_index.json;
  * compute_metrics: recompute metrics of <output_dir>/methods/* against
    <output_dir>/gt into <output_dir>/metrics.
Everything runs on the card; the CPU is used only when asked for
(`--device cpu`, or main(argv, device="cpu")), never as a fallback.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from .config import load_config
from .device import resolve_device


def main(argv=None, device: str | torch.device = "cuda"):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    path = None
    if argv and "=" not in argv[0]:
        path = argv.pop(0)
    cfg = load_config(path, argv)
    dev = resolve_device(device)

    if cfg.mode == "train":
        from .train.trainer import Trainer

        return Trainer(cfg, device=dev).fit()
    if cfg.mode == "test":
        from .data.dataset import SceneDataset
        from .train import checkpoint as ckpt
        from .train.evaluator import Evaluator
        from .train.lpips import make_lpips_fn
        from .train.state import create_train_state, mono_grid

        if next(iter(SceneDataset(cfg.dataset, split="test", stage="test")), None) is None:
            raise SystemExit("no test scenes found")
        state = create_train_state(cfg.model, cfg.train, seed=0, device=dev,
                                   mono_grid=mono_grid(cfg.train, cfg.dataset.image_shape[0]))
        ckpt_dir = ckpt.resolve_checkpoint_uri(cfg.checkpointing.load) or str(
            Path(cfg.output_dir) / "checkpoints")
        state, ok = ckpt.restore_weights_only(ckpt_dir, state)
        if ok:
            print(f"restored the weights of {ckpt.describe(ckpt_dir)} from {ckpt_dir}")
        else:
            print("warning: no checkpoint restored; evaluating random weights")
        return Evaluator(cfg, state, lpips_fn=make_lpips_fn(cfg.train.loss.lpips_weights, dev),
                         device=dev).run()
    if cfg.mode == "generate_index":
        from .evaluation.index_generator import IndexGeneratorConfig, generate_index

        out = str(Path(cfg.output_dir) / "evaluation_index.json")
        index = generate_index(cfg.dataset.roots, "test", out, IndexGeneratorConfig(
            num_context_views=cfg.dataset.view_sampler.num_context_views))
        print(f"wrote {out}")
        return index
    if cfg.mode == "compute_metrics":
        from .evaluation.metric_computer import compute_metrics_offline

        base = Path(cfg.output_dir)
        methods = {p.name: str(p) for p in sorted((base / "methods").iterdir()) if p.is_dir()}
        if not methods:
            raise SystemExit(f"no method dirs under {base / 'methods'}")
        results = compute_metrics_offline(str(base / "gt"), methods, str(base / "metrics"),
                                          device=dev)
        print(json.dumps(results, indent=2))
        return results
    raise SystemExit(f"unknown mode {cfg.mode}")


if __name__ == "__main__":
    main()
