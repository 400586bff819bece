"""Scene dataset -> example stream (host-side numpy).

Counterpart of splatter360_tpu/data/dataset.py: loads scenes, samples
context and target frames with a view sampler, applies the baseline filter
(an example whose context cameras are closer than `baseline_epsilon` is
skipped in training) and stacks examples into batches. Cube faces are
resampled on the device, not here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from .scene_io import list_scenes, load_scene
from .view_sampler import BoundedSamplerConfig, ViewSamplerBounded, ViewSamplerEvaluation


@dataclass(frozen=True)
class DatasetConfig:
    roots: tuple = ()
    image_shape: tuple = (512, 1024)
    near: float = 0.1
    far: float = 10.0
    baseline_epsilon: float = 1e-3
    view_sampler: BoundedSamplerConfig = dataclasses.field(default_factory=BoundedSamplerConfig)
    evaluation_index_path: Optional[str] = None
    overfit_to_scene: Optional[str] = None


def _frames_to_views(scene_data, indices, cfg: DatasetConfig) -> dict[str, np.ndarray]:
    v = len(indices)
    return {
        "extrinsics_sphere": scene_data["poses"][indices].astype(np.float32),
        "image_sphere": scene_data["rgb"][indices].astype(np.float32) / 255.0,
        "depth_sphere": scene_data["depth_m"][indices].astype(np.float32),
        "near": np.full((v,), cfg.near, np.float32),
        "far": np.full((v,), cfg.far, np.float32),
        "index": np.asarray(indices, np.int32),
    }


class SceneDataset:
    """Iterable over {"context", "target", "scene"} examples: endless and
    shuffled in the train stage, each scene once in order otherwise."""

    def __init__(self, cfg: DatasetConfig, split: str = "train", stage: str = "train",
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1, step_fn=None):
        self.cfg = cfg
        self.split = split
        self.stage = stage
        self.rng = np.random.default_rng(seed + shard_index)
        self.step_fn = step_fn or (lambda: 0)
        scenes = [(root, s) for root in cfg.roots for s in list_scenes(root, split)]
        if cfg.overfit_to_scene is not None:
            scenes = [rs for rs in scenes if rs[1] == cfg.overfit_to_scene]
        # per-host sharding
        self.scenes = scenes[shard_index::num_shards]
        self._cache: dict = {}
        use_index = stage != "train" and cfg.evaluation_index_path
        self.eval_sampler = ViewSamplerEvaluation(cfg.evaluation_index_path) if use_index else None
        self.train_sampler = ViewSamplerBounded(cfg.view_sampler, stage=stage)

    def _load(self, root, scene):
        key = (root, scene)
        if key not in self._cache:
            if len(self._cache) > 4:
                self._cache.clear()
            self._cache[key] = load_scene(root, self.split, scene)
        return self._cache[key]

    def _example(self, root, scene):
        data = self._load(root, scene)
        n = data["poses"].shape[0]
        if self.eval_sampler is not None:
            sampled = self.eval_sampler.sample(scene)
            if sampled is None:
                return None
            ctx_idx, tgt_idx = sampled
            if ctx_idx.max() >= n or tgt_idx.max() >= n:
                return None
        else:
            try:
                ctx_idx, tgt_idx = self.train_sampler.sample(n, self.rng, self.step_fn())
            except ValueError:
                return None
        poses = data["poses"]
        baseline = np.linalg.norm(poses[ctx_idx[0], :3, 3] - poses[ctx_idx[-1], :3, 3])
        if self.stage == "train" and baseline < self.cfg.baseline_epsilon:
            return None
        return {"context": _frames_to_views(data, ctx_idx, self.cfg),
                "target": _frames_to_views(data, tgt_idx, self.cfg), "scene": scene}

    def __iter__(self) -> Iterator[dict]:
        if self.stage == "train":
            while True:
                for i in self.rng.permutation(len(self.scenes)):
                    ex = self._example(*self.scenes[i])
                    if ex is not None:
                        yield ex
        else:
            for root, scene in self.scenes:
                ex = self._example(root, scene)
                if ex is not None:
                    yield ex


def batch_examples(examples) -> dict:
    """Stack examples along a new leading batch axis; "scene" becomes a list."""
    out = {part: {k: np.stack([e[part][k] for e in examples]) for k in examples[0][part]}
           for part in ("context", "target")}
    out["scene"] = [e["scene"] for e in examples]
    return out


def batches(dataset: SceneDataset, batch_size: int) -> Iterator[dict]:
    buf = []
    for ex in dataset:
        buf.append(ex)
        if len(buf) == batch_size:
            yield batch_examples(buf)
            buf = []
