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

Under torchrun (`python -m torch.distributed.run --nproc_per_node=K -m
splatter360_tpu_torch.main ...`) the process group starts before any mode
(parallel/mesh.maybe_initialize_distributed), each rank on its own card
(cuda:LOCAL_RANK), and ends with the run. mode=train trains across the
ranks (train/trainer.py); mode=test runs on every rank with
train.shard_render (its ERP decodes band-sharded over them) and on rank 0
alone without it; generate_index and compute_metrics run on rank 0. Only
rank 0 writes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from .config import load_config
from .parallel.mesh import Group, maybe_initialize_distributed, rank
from .parallel.render_sharding import shards_erp


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
    started = not dist.is_initialized()
    dev = maybe_initialize_distributed(device)
    try:
        return _run(cfg, dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(cfg, dev: torch.device):
    if cfg.mode == "train":
        from .train.trainer import Trainer

        return Trainer(cfg, device=dev).fit()
    if cfg.mode == "test":
        from .data.dataset import SceneDataset
        from .train import checkpoint as ckpt
        from .train.evaluator import Evaluator
        from .train.lpips import make_lpips_fn
        from .train.state import create_train_state, mono_grid

        comm = Group() if dist.is_initialized() else None
        if not (shards_erp(cfg, comm) or rank() == 0):
            return {}
        if next(iter(SceneDataset(cfg.dataset, split="test", stage="test")), None) is None:
            raise SystemExit("no test scenes found")
        state = create_train_state(cfg.model, cfg.train, seed=0, device=dev,
                                   mono_grid=mono_grid(cfg.train, cfg.dataset.image_shape[0]))
        ckpt_dir = ckpt.resolve_checkpoint_uri(cfg.checkpointing.load) or str(
            Path(cfg.output_dir) / "checkpoints")
        state, ok = ckpt.restore_weights_only(ckpt_dir, state)
        if rank() == 0:
            print(f"restored the weights of {ckpt.describe(ckpt_dir)} from {ckpt_dir}" if ok
                  else "warning: no checkpoint restored; evaluating random weights")
        return Evaluator(cfg, state, lpips_fn=make_lpips_fn(cfg.train.loss.lpips_weights, dev),
                         device=dev, comm=comm).run()
    if cfg.mode in ("generate_index", "compute_metrics") and rank() != 0:
        return None
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
