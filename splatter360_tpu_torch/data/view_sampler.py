"""View samplers: which frames of a scene are context and which are targets.

Counterpart of splatter360_tpu/data/view_sampler.py, drawing from a numpy
Generator in the same order, so the same seed picks the same frames:
  * bounded: the training curriculum, a random context gap in [min, max]
    with a linear warm-up of both bounds; the test stage pins the left
    context to frame `test_context_start` (40) and the gap to its maximum,
    both clamped to the scene's length;
  * evaluation: a fixed {scene: {"context": [...], "target": [...]}} JSON.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class BoundedSamplerConfig:
    num_context_views: int = 2
    num_target_views: int = 4
    min_distance_between_context_views: int = 40
    max_distance_between_context_views: int = 100
    min_distance_to_context_views: int = 0
    warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 10
    initial_max_distance_between_context_views: int = 20
    # the test stage's left context frame (the reference skips the first 40
    # frames), clamped when the scene is too short for start + max gap
    test_context_start: int = 40


class ViewSamplerBounded:
    def __init__(self, cfg: BoundedSamplerConfig, stage: str = "train"):
        self.cfg = cfg
        self.stage = stage

    def _schedule(self, global_step: int, initial: int, final: int) -> int:
        cfg = self.cfg
        if cfg.warm_up_steps <= 0:
            return final
        frac = min(global_step / cfg.warm_up_steps, 1.0)
        return round(initial + frac * (final - initial))

    def sample(self, num_frames: int, rng: np.random.Generator, global_step: int = 0):
        """(context indices, sorted target indices), int64."""
        cfg = self.cfg
        if self.stage == "test":
            max_gap = min(cfg.max_distance_between_context_views, num_frames - 1)
            min_gap = max_gap
            index_left = max(min(cfg.test_context_start, num_frames - 1 - max_gap), 0)
        else:
            max_gap = self._schedule(global_step, cfg.initial_max_distance_between_context_views,
                                     cfg.max_distance_between_context_views)
            min_gap = self._schedule(global_step, cfg.initial_min_distance_between_context_views,
                                     cfg.min_distance_between_context_views)
            max_gap = min(max_gap, num_frames - 1)
            min_gap = max(min(min_gap, max_gap), 1)
            index_left = None
        if num_frames < 2:
            raise ValueError("scene too short")
        gap = int(rng.integers(min_gap, max_gap + 1))
        if index_left is None:
            index_left = int(rng.integers(0, num_frames - gap))
        index_right = index_left + gap

        ctx = [index_left, index_right]
        if cfg.num_context_views > 2:
            extra = rng.choice(np.arange(index_left + 1, index_right), cfg.num_context_views - 2,
                               replace=False)
            ctx = sorted([index_left, *extra.tolist(), index_right])

        pool = np.arange(index_left + cfg.min_distance_to_context_views,
                         index_right - cfg.min_distance_to_context_views + 1)
        target = rng.choice(pool, min(cfg.num_target_views, pool.size), replace=False)
        return np.asarray(ctx, np.int64), np.sort(target).astype(np.int64)


class ViewSamplerEvaluation:
    def __init__(self, index_path: str):
        self.index = json.loads(Path(index_path).read_text())

    def sample(self, scene: str):
        entry = self.index.get(scene)
        if entry is None:
            return None
        return np.asarray(entry["context"], np.int64), np.asarray(entry["target"], np.int64)
