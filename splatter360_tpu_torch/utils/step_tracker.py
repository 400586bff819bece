"""The global step, shared with the data pipeline.

Counterpart of splatter360_tpu/utils/step_tracker.py: the trainer sets the
step after each update and the bounded view sampler reads it (from the
prefetch thread) to widen its context gap over the curriculum. Threads share
a plain cell under a lock. The JAX tracker's `multiprocess` option (a
multiprocessing.Value for loaders in other processes) is not ported: the
port has no multi-process loader (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import threading


class StepTracker:
    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def set_step(self, step: int) -> None:
        with self._lock:
            self._value = int(step)

    def get_step(self) -> int:
        with self._lock:
            return self._value
