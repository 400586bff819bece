"""Checkpoints of the port's train state, and checkpoint URIs.

Counterpart of splatter360_tpu/train/checkpoint.py's full resume and
weights-only modes with JAX's layout of step directories:

    <directory>/<step>/checkpoint.pt   torch.save of {"params": the encoder's
                                       state_dict, "opt_state": Adam's
                                       state_dict, "step": int}

written to a temporary name and renamed, so that a step directory holds a
whole checkpoint or none. Orbax checkpoints written by the JAX package are
not read here (that needs orbax; ROADMAP.md), nor are the partial warm
starts from torch weight files (the weights-loader item).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch

from .state import TrainState

FILE = "checkpoint.pt"


def _steps(directory) -> list[int]:
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.name.isdigit() and (p / FILE).is_file())


def latest_step(directory) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory, step: int, state: TrainState, max_to_keep: int = -1) -> Path:
    """Write <directory>/<step>/; keep the newest `max_to_keep` steps (<= 0: all)."""
    step_dir = Path(directory) / str(int(step))
    step_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "opt_state": state.optimizer.state_dict(),
        "step": int(state.step),
    }
    tmp = step_dir / f"{FILE}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, step_dir / FILE)
    if max_to_keep > 0:
        for old in _steps(directory)[:-max_to_keep]:
            shutil.rmtree(Path(directory) / str(old))
    return step_dir


def _read(directory, step: Optional[int]):
    step = latest_step(directory) if step is None else step
    if step is None or not (Path(directory) / str(step) / FILE).is_file():
        return None
    return torch.load(Path(directory) / str(step) / FILE, map_location="cpu", weights_only=True)


def restore_checkpoint(directory, state: TrainState, step: Optional[int] = None):
    """Full resume: (state with its parameters, Adam state and step restored
    in place, True), or (state, False) when there is no checkpoint."""
    ckpt = _read(directory, step)
    if ckpt is None:
        return state, False
    state.model.load_state_dict(ckpt["params"])
    state.optimizer.load_state_dict(ckpt["opt_state"])
    state.step = int(ckpt["step"])
    return state, True


def restore_weights_only(directory, state: TrainState, step: Optional[int] = None):
    """Weights-only: (state with its parameters restored, True), keeping its
    optimizer and step; (state, False) when there is no checkpoint."""
    ckpt = _read(directory, step)
    if ckpt is None:
        return state, False
    state.model.load_state_dict(ckpt["params"])
    return state, True


def resolve_checkpoint_uri(path: str | None) -> str | None:
    """Resolve `wandb://run_id[:vN]` to a local directory; other paths pass
    through. With the `wandb` SDK importable and WANDB_API_KEY set, the
    run's latest (or the requested) committed model artifact is downloaded
    as the reference does; otherwise the local store
    $SPLAT360_WANDB_ARTIFACTS/<run_id>/<vN>/ is used (highest N when no
    version is given)."""
    if path is None or not str(path).startswith("wandb://"):
        return path
    run_id, *rest = str(path)[len("wandb://"):].split(":")
    if len(rest) > 1:
        raise ValueError(f"invalid wandb checkpoint URI {path!r}")
    version = rest[0] if rest else None

    try:
        if os.environ.get("WANDB_API_KEY"):
            import wandb

            run = wandb.Api().run(run_id)
            chosen = None
            for artifact in run.logged_artifacts():
                if artifact.type != "model" or artifact.state != "COMMITTED":
                    continue
                if version is None:
                    if chosen is None or int(artifact.version[1:]) > int(chosen.version[1:]):
                        chosen = artifact
                elif version == artifact.version:
                    chosen = artifact
                    break
            if chosen is not None:
                root = Path("checkpoints") / run_id.replace("/", "_")
                chosen.download(root=str(root))
                return str(root)
    except Exception as e:
        print(f"warning: wandb API resolution failed ({e}); falling back to the local "
              f"artifact store")

    run_dir = Path(os.environ.get("SPLAT360_WANDB_ARTIFACTS", "wandb_artifacts")) / run_id.replace(
        "/", "_")
    if not run_dir.is_dir():
        raise FileNotFoundError(f"cannot resolve {path!r}: no wandb API access and no local "
                                f"artifact dir {run_dir} (set SPLAT360_WANDB_ARTIFACTS)")
    if version is None:
        versions = sorted((d for d in run_dir.iterdir() if d.is_dir() and d.name.startswith("v")),
                          key=lambda d: int(d.name[1:]))
        if not versions:
            raise FileNotFoundError(f"no vN version dirs under {run_dir}")
        return str(versions[-1])
    return str(run_dir / version)
