"""Typed configuration tree, YAML loading and dotted CLI overrides.

Counterpart of splatter360_tpu/config.py with the same keys and defaults,
so every YAML file the JAX CLI accepts parses here:

    cfg = load_config("configs/hm3d.yaml", ["mode=test", "dataset.roots=[data]"])

An unknown key raises KeyError naming it. YAML is read with PyYAML where it
is installed, else with utils/yaml_subset.py (the subset the configs use,
with PyYAML's values). A value off the ported path raises
NotImplementedError naming its ROADMAP.md item when the config is loaded
(check_ported); none is ignored.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

from .data.dataset import DatasetConfig
from .models import encoder
from .models.encoder import EncoderConfig
from .train import state
from .train.state import TrainConfig


@dataclass(frozen=True)
class CheckpointingConfig:
    load: Optional[str] = None             # full resume path (or wandb://run[:vN])
    pretrained_model: Optional[str] = None  # weights-only warm start (training)
    # local torch checkpoints for the reference recipe's warm starts: UniMatch
    # gmdepth weights into both multiview backbones, and DINOv2 ViT weights
    # for the mono branch (model.add_mono_feat); their loaders are not ported
    pretrained_backbone: Optional[str] = None
    pretrained_mono: Optional[str] = None
    every_n_train_steps: int = 20_000
    resume: bool = True
    max_to_keep: int = -1


@dataclass(frozen=True)
class TrainerConfig:
    max_steps: int = 100_000
    batch_size: int = 1
    val_check_interval: int = 5_000
    num_sanity_val_steps: int = 2
    print_log_every_n_steps: int = 100
    seed: int = 111123
    # a profiler trace of steps [profile_start, profile_start + profile_steps)
    profile_steps: int = 0
    profile_start: int = 10


@dataclass(frozen=True)
class TestConfig:
    output_path: str = "outputs/test"
    compute_scores: bool = True
    eval_time_skip_steps: int = 5
    save_image: bool = True
    save_video: bool = False  # videos are not ported (check_ported)
    video_trajectory: str = "interpolate"  # interpolate | wobble | spin
    eval_depth: bool = False
    # score the v*6 rendered cube faces (the reference's protocol) instead of
    # the direct ERP render
    eval_on_cubes: bool = False
    # divide the composited depth by alpha before the depth metrics (the
    # reference does not; the two agree where alpha ~ 1)
    depth_alpha_norm: bool = False


@dataclass(frozen=True)
class RootConfig:
    mode: str = "train"  # train | test | generate_index | compute_metrics
    output_dir: str = "outputs/run"
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: EncoderConfig = field(default_factory=EncoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    checkpointing: CheckpointingConfig = field(default_factory=CheckpointingConfig)
    test: TestConfig = field(default_factory=TestConfig)


def _from_dict(cls, data: Any):
    """Build (frozen) dataclasses from nested dicts, recursively."""
    if data is None:
        return cls() if dataclasses.is_dataclass(cls) else None
    if dataclasses.is_dataclass(cls):
        if not isinstance(data, dict):
            raise TypeError(f"expected dict for {cls.__name__}, got {type(data)}")
        hints = typing.get_type_hints(cls)
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if key not in names:
                raise KeyError(f"unknown config key {cls.__name__}.{key}")
            kwargs[key] = _convert(hints[key], value)
        return cls(**kwargs)
    return data


def _convert(hint, value):
    origin = typing.get_origin(hint)
    if dataclasses.is_dataclass(hint):
        return _from_dict(hint, value)
    if origin is typing.Union:
        if value is None:
            return None
        return _convert([a for a in typing.get_args(hint) if a is not type(None)][0], value)
    if origin in (tuple, typing.Tuple) or hint is tuple:
        return tuple(value) if value is not None else ()
    if origin in (list, typing.List):
        return list(value)
    if hint is float and value is not None:
        return float(value)
    if hint is int and value is not None and not isinstance(value, bool):
        return int(value)
    return value


def yaml_load(text: str):
    try:
        import yaml
    except ImportError:
        from .utils.yaml_subset import safe_load
        return safe_load(text)
    return yaml.safe_load(text)


def check_ported(cfg: RootConfig) -> None:
    """Raise NotImplementedError for a value this port does not run."""
    encoder.check_ported(cfg.model)
    state.check_ported(cfg.train)
    if cfg.test.save_video:
        raise NotImplementedError("test.save_video=True (trajectory videos) is not ported "
                                  "(ROADMAP.md Queue 1 item 4)")
    for key in ("pretrained_backbone", "pretrained_mono"):
        if getattr(cfg.checkpointing, key):
            raise NotImplementedError(f"checkpointing.{key} (the torch weights loaders) is not "
                                      f"ported (ROADMAP.md Queue 1 item 4)")


def load_config(path: Optional[str] = None, overrides: Optional[list] = None) -> RootConfig:
    """RootConfig from a YAML file plus `a.b.c=value` overrides (each value
    read as YAML)."""
    data: dict = {}
    if path is not None:
        data = yaml_load(Path(path).read_text()) or {}
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml_load(raw)
    cfg = _from_dict(RootConfig, data)
    check_ported(cfg)
    return cfg


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
