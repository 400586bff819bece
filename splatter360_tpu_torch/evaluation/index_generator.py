"""Evaluation-index generation.

Counterpart of splatter360_tpu/evaluation/index_generator.py, drawing from
numpy's default_rng in the same order: per test scene, the contexts
(context_start, context_start + frame_interval) clamped to the scene's
length (plus random distinct middles for more than 2 context views) and
`num_target_views` random distinct targets strictly between them (`video`:
every frame between them). Writes {scene: {"context": [...], "target": [...]}}.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..data.scene_io import list_scenes, load_scene


@dataclass(frozen=True)
class IndexGeneratorConfig:
    context_start: int = 40
    frame_interval: int = 100
    num_context_views: int = 2
    num_target_views: int = 3
    video: bool = False
    seed: int = 111


def generate_index(roots, split: str, out_path: str,
                   cfg: IndexGeneratorConfig = IndexGeneratorConfig()) -> dict:
    rng = np.random.default_rng(cfg.seed)
    index = {}
    for root in roots:
        for scene in list_scenes(root, split):
            n = load_scene(root, split, scene)["poses"].shape[0]
            left = min(cfg.context_start, max(n - cfg.frame_interval - 1, 0))
            right = min(left + cfg.frame_interval, n - 1)
            if right <= left:
                continue
            ctx = [left, right]
            if cfg.num_context_views > 2:
                extra = rng.choice(np.arange(left + 1, right), cfg.num_context_views - 2,
                                   replace=False)
                ctx = sorted([left, *extra.tolist(), right])
            pool = np.arange(left + 1, right)
            if cfg.video:
                tgt = pool
            else:
                tgt = np.sort(rng.choice(pool, min(cfg.num_target_views, pool.size),
                                         replace=False))
            index[scene] = {"context": [int(i) for i in ctx], "target": [int(i) for i in tgt]}
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(index, indent=1))
    return index
