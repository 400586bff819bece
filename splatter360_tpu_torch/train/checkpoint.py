"""Checkpoints of the port's train state, and checkpoint URIs.

Counterpart of splatter360_tpu/train/checkpoint.py's full resume and
weights-only modes with JAX's layout of step directories:

    <directory>/<step>/checkpoint.pt   torch.save of {"params": the encoder's
                                       state_dict, "opt_state": Adam's
                                       state_dict, "step": int}

written to a temporary name and renamed, so that a step directory holds a
whole checkpoint or none. `latest_step`, `restore_checkpoint` and
`restore_weights_only` also read the step directories the JAX package's
orbax CheckpointManager writes (<step>/default/..., train/orbax_reader.py),
and take the highest step of either kind. An orbax tree goes through
convert.torch_state_from_flax (the parameters) and
convert.adam_state_from_optax (Adam's moments and count). The frozen mono
ViT (add_mono_feat) is in the parameters but not in Adam's state: the
port's optimizer holds only the trainable parameters, where JAX's optax
state keeps zero moments for the ViT's leaves too (its gradients are 0 by
stop_gradient); those are checked to be zero and dropped. A tree that does
not fit the model, or an orbax step that cannot be read, raises.

Partial warm starts from torch weight files, as the JAX package's: both
multiview backbones from a UniMatch gmdepth file (`warm_start_backbones`,
checkpointing.pretrained_backbone) and the mono branch's DINOv2 ViT
(`warm_start_mono`, checkpointing.pretrained_mono).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..convert import adam_state_from_optax, torch_state_from_flax
from ..utils.torch_convert import (convert_dinov2, convert_unimatch_backbone,
                                   load_torch_state_dict)
from . import orbax_reader
from .state import TrainState

FILE = "checkpoint.pt"


def _port_steps(directory) -> list[int]:
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.name.isdigit() and (p / FILE).is_file())


def _kind(step_dir: Path) -> Optional[str]:
    """"checkpoint.pt" (the port's; preferred where a step holds both), "orbax"
    (the JAX package's) or None."""
    if (step_dir / FILE).is_file():
        return FILE
    if orbax_reader.is_step_dir(step_dir):
        return "orbax"
    return None


def latest_step(directory) -> Optional[int]:
    """The highest step of either kind under `directory` (None: no step)."""
    steps = _port_steps(directory) + orbax_reader.steps(directory)
    return max(steps) if steps else None


def describe(directory, step: Optional[int] = None) -> Optional[str]:
    """Which checkpoint a restore from `directory` reads, in words."""
    step = latest_step(directory) if step is None else step
    kind = None if step is None else _kind(Path(directory) / str(step))
    if kind is None:
        return None
    what = "the port's checkpoint.pt" if kind == FILE else "the JAX package's orbax checkpoint"
    return f"{what} at step {step}"


def save_checkpoint(directory, step: int, state: TrainState, max_to_keep: int = -1) -> Path:
    """Write <directory>/<step>/; keep the newest `max_to_keep` of the port's
    steps (<= 0: all; the JAX package's orbax steps are left alone)."""
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
        for old in _port_steps(directory)[:-max_to_keep]:
            shutil.rmtree(Path(directory) / str(old))
    return step_dir


def _read(directory, step: Optional[int]):
    """(kind, the checkpoint) of `step` (default: the latest), or None."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    step_dir = Path(directory) / str(step)
    kind = _kind(step_dir)
    if kind == FILE:
        return kind, torch.load(step_dir / FILE, map_location="cpu", weights_only=True)
    if kind == "orbax":
        return kind, orbax_reader.read_checkpoint(step_dir)
    return None


def _load_params(model: torch.nn.Module, params, where: str) -> None:
    """load_state_dict(strict=True), naming the first missing, unexpected
    and misshapen keys where the checkpoint does not fit the model."""
    own = model.state_dict()
    missing = [k for k in own if k not in params]
    unexpected = [k for k in params if k not in own]
    shapes = [k for k in own if k in params and tuple(own[k].shape) != tuple(params[k].shape)]
    if missing or unexpected or shapes:
        raise ValueError(f"{where}: the checkpoint does not fit the model: {len(missing)} "
                         f"missing (first {missing[:1]}), {len(unexpected)} unexpected "
                         f"(first {unexpected[:1]}), {len(shapes)} of another shape "
                         f"(first {shapes[:1]})")
    model.load_state_dict(params, strict=True)


def restore_checkpoint(directory, state: TrainState, step: Optional[int] = None):
    """Full resume: (state with its parameters, Adam state and step restored
    in place, True), or (state, False) when there is no checkpoint."""
    found = _read(directory, step)
    if found is None:
        return state, False
    kind, ckpt = found
    if kind == FILE:
        _load_params(state.model, ckpt["params"], str(directory))
        state.optimizer.load_state_dict(ckpt["opt_state"])
        state.step = int(ckpt["step"])
        return state, True
    _load_params(state.model, torch_state_from_flax(ckpt["params"]), str(directory))
    step = int(np.asarray(ckpt["step"]))
    opt = state.optimizer.state_dict()
    opt["state"] = adam_state_from_optax(ckpt["opt_state"], state.model, step)
    state.optimizer.load_state_dict(opt)
    state.step = step
    return state, True


def restore_weights_only(directory, state: TrainState, step: Optional[int] = None):
    """Weights-only: (state with its parameters restored, True), keeping its
    optimizer and step; (state, False) when there is no checkpoint."""
    found = _read(directory, step)
    if found is None:
        return state, False
    kind, ckpt = found
    params = ckpt["params"] if kind == FILE else torch_state_from_flax(ckpt["params"])
    _load_params(state.model, params, str(directory))
    return state, True


def partial_warm_start(module: torch.nn.Module, donor) -> int:
    """Copy each donor tensor into `module`'s parameter of the same name and
    shape, in place (the reference's key-intersection warm start); returns
    how many were copied."""
    params = dict(module.named_parameters())
    n = 0
    with torch.no_grad():
        for name, value in donor.items():
            p = params.get(name)
            if p is not None and tuple(p.shape) == tuple(value.shape):
                p.copy_(value)
                n += 1
    return n


def warm_start_backbones(model: torch.nn.Module, path, num_layers: int = 6) -> int:
    """The reference's UniMatch warm start: the gmdepth torch weight file at
    `path` (utils/torch_convert.convert_unimatch_backbone) into BOTH
    multiview backbones, backbone_cube and backbone_erp, where the model has
    them. Returns the number of parameters copied over both; ValueError
    when none matched."""
    donor = convert_unimatch_backbone(load_torch_state_dict(path), num_layers)
    n = sum(partial_warm_start(backbone, donor)
            for backbone in (getattr(model, "backbone_cube", None),
                             getattr(model, "backbone_erp", None))
            if backbone is not None)
    if n == 0:
        raise ValueError(f"checkpointing.pretrained_backbone={str(path)!r}: 0 parameter leaves "
                         f"matched the model (wrong checkpoint, or the model has no "
                         f"backbone_cube/backbone_erp modules)")
    return n


def warm_start_mono(model: torch.nn.Module, path) -> int:
    """The reference's DINOv2 mono-branch load: the ViT torch weight file at
    `path` (utils/torch_convert.convert_dinov2, pos_embed resampled to the
    model's token grid) into the encoder's frozen `dino` module. Returns the
    number of parameters copied; ValueError without a `dino` module (the
    model needs model.add_mono_feat), or when none matched."""
    dino = getattr(model, "dino", None)
    if dino is None:
        raise ValueError("checkpointing.pretrained_mono is set but the model has no `dino` "
                         "module: enable model.add_mono_feat")
    n = partial_warm_start(dino, convert_dinov2(load_torch_state_dict(path), dino.grid))
    if n == 0:
        raise ValueError(f"checkpointing.pretrained_mono={str(path)!r}: 0 parameter leaves "
                         f"matched the model's dino module (wrong vit_type?)")
    return n


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
