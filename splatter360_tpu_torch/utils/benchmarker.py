"""Timing and memory artefacts: benchmark.json and peak_memory.json.

Counterpart of splatter360_tpu/utils/benchmarker.py with the same JSON
keys. A timed block on the card ends in torch.cuda.synchronize() (the
counterpart of jax.block_until_ready), so its wall time covers the work it
launched. peak_memory.json reads the CUDA caching allocator's counters.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch


class Benchmarker:
    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self.execution_times = defaultdict(list)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        """Time the block; each of its `num_calls` calls gets 1/num_calls of it."""
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            elapsed = time.perf_counter() - start
            self.execution_times[tag] += [elapsed / num_calls] * num_calls

    def dump(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(self.execution_times), indent=2))

    def dump_memory(self, path) -> None:
        """{"device_0": {peak_bytes_in_use, bytes_in_use, bytes_limit,
        peak_bytes_reserved}} for the card; {} on the CPU (as the JAX
        package writes for CPU devices, which report no memory stats)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        stats = {}
        if self.device.type == "cuda":
            i = self.device.index if self.device.index is not None else torch.cuda.current_device()
            stats[f"device_{i}"] = {
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                "bytes_in_use": torch.cuda.memory_allocated(i),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
                "peak_bytes_reserved": torch.cuda.max_memory_reserved(i),
            }
        path.write_text(json.dumps(stats, indent=2))

    def summarize(self) -> dict:
        return {tag: sum(t) / max(len(t), 1) for tag, t in self.execution_times.items()}
