"""The global step, shared with the data pipeline.

Counterpart of splatter360_tpu/utils/step_tracker.py: the trainer sets the
step after each update and the bounded view sampler reads it (from the
prefetch thread) to widen its context gap over the curriculum. Threads share
a plain cell under a lock; with `multiprocess=True` the cell is a
multiprocessing.Value, for a loader in other processes (the JAX package's
option: neither package's trainer starts one). It is made in the spawn
context, so that processes started either way can share it (one made under
fork cannot be handed to a spawned process).
"""

from __future__ import annotations

import multiprocessing as mp
import threading


class StepTracker:
    def __init__(self, multiprocess: bool = False):
        if multiprocess:
            self._value = mp.get_context("spawn").Value("q", 0)
            self._lock = None
        else:
            self._value = 0
            self._lock = threading.Lock()

    def set_step(self, step: int) -> None:
        if self._lock is None:
            with self._value.get_lock():
                self._value.value = int(step)
        else:
            with self._lock:
                self._value = int(step)

    def get_step(self) -> int:
        if self._lock is None:
            with self._value.get_lock():
                return int(self._value.value)
        with self._lock:
            return int(self._value)
