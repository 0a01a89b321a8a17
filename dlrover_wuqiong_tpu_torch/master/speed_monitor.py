"""Global-step throughput tracking & straggler baseline.

Parity: a copy of dlrover_wuqiong_tpu/master/speed_monitor.py:1-106 (no
JAX), kept in the port because the port imports nothing of the JAX
package.  (The JAX module's own parity: reference
`dlrover/python/master/monitor/speed_monitor.py`, `collect_global_step`
:81, `running_speed` :113.)
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Set, Tuple


class SpeedMonitor:
    def __init__(self, max_records: int = 50):
        self._lock = threading.Lock()
        self._global_step_records: Deque[Tuple[float, int]] = deque(
            maxlen=max_records)
        self._global_step = 0
        self._start_training_time: Optional[float] = None
        self._sample_count = 0
        self._workers: Set[int] = set()
        self._init_time = time.time()
        self._max_speed = 0.0
        # reading before the first set_target_worker_num used to raise
        # AttributeError (never initialized here) — default to 0
        self._target_worker_num = 0

    def set_target_worker_num(self, num: int):
        self._target_worker_num = num

    @property
    def target_worker_num(self) -> int:
        return self._target_worker_num

    def all_worker_joined(self) -> bool:
        """True when every expected worker is running (0 target = never)."""
        with self._lock:
            return (self._target_worker_num > 0 and
                    len(self._workers) >= self._target_worker_num)

    def add_running_worker(self, node_id: int):
        with self._lock:
            self._workers.add(node_id)

    def remove_running_worker(self, node_id: int):
        with self._lock:
            self._workers.discard(node_id)

    @property
    def running_workers(self) -> Set[int]:
        with self._lock:
            return set(self._workers)

    def collect_global_step(self, step: int, timestamp: Optional[float] = None):
        ts = timestamp or time.time()
        with self._lock:
            if self._start_training_time is None:
                self._start_training_time = ts
            self._global_step = max(self._global_step, step)
            self._global_step_records.append((ts, step))
            self._sample_count += 1

    @property
    def completed_global_step(self) -> int:
        with self._lock:
            return self._global_step

    def running_speed(self) -> float:
        """Steps/sec over the record window."""
        with self._lock:
            if len(self._global_step_records) < 2:
                return 0.0
            (t0, s0) = self._global_step_records[0]
            (t1, s1) = self._global_step_records[-1]
            if t1 <= t0:
                return 0.0
            speed = (s1 - s0) / (t1 - t0)
            self._max_speed = max(self._max_speed, speed)
            return speed

    def worker_adjustment_finished(self) -> bool:
        """Has speed stabilized since the last membership change?"""
        return len(self._global_step_records) >= \
            self._global_step_records.maxlen

    def first_step_timestamp(self) -> Optional[float]:
        with self._lock:
            return self._start_training_time

    def reset_running_speed_monitor(self):
        with self._lock:
            self._global_step_records.clear()

    def goodput(self) -> float:
        """Fraction of wall-clock spent at >50% of peak observed speed —
        the north-star metric (BASELINE.md)."""
        with self._lock:
            if self._start_training_time is None or self._max_speed <= 0:
                return 0.0
            elapsed = time.time() - self._start_training_time  # graftlint: disable=wall-clock-duration -- step records carry node-reported wall timestamps (cross-process)
            if elapsed <= 0:
                return 0.0
            # steps completed / (elapsed * peak speed)
            return min(1.0, self._global_step / (elapsed * self._max_speed))
