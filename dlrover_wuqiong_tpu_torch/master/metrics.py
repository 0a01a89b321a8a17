"""The process-wide metric registry.

Parity: dlrover_wuqiong_tpu/master/metrics.py:1-167, cut to what the
checkpoint uses: `MetricRegistry`'s labelled counters and bounded
histograms, their readers, and `get_registry`.  The checkpoint engine and
saver write their timings and integrity events into it
(checkpoint/engine.py `_record_blocking_metric`, `_report_ckpt_health`;
checkpoint/ckpt_saver.py after a persist).  Gauges, the Prometheus text
rendering, `JobMetricCollector` and the HTTP `PrometheusExporter` come
with the master's metric verbs (ROADMAP item 7a), which export it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


class MetricRegistry:
    """Thread-safe counters/histograms with labels."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._hists: Dict[str, Dict[_LabelKey, List[float]]] = {}

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None):
        with self._lock:
            d = self._counters.setdefault(name, {})
            k = _labels_key(labels)
            d[k] = d.get(k, 0.0) + value

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                max_samples: int = 1000):
        with self._lock:
            d = self._hists.setdefault(name, {})
            k = _labels_key(labels)
            samples = d.setdefault(k, [])
            samples.append(value)
            if len(samples) > max_samples:
                del samples[:len(samples) - max_samples]

    def get_counter(self, name: str,
                    labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_labels_key(labels), 0.0)

    def get_samples(self, name: str,
                    labels: Optional[Dict[str, str]] = None) -> List[float]:
        """The histogram's kept samples, oldest first (a copy)."""
        with self._lock:
            return list(self._hists.get(name, {}).get(_labels_key(labels),
                                                      []))


_REGISTRY: Optional[MetricRegistry] = None
_REG_LOCK = threading.Lock()


def get_registry() -> MetricRegistry:
    global _REGISTRY
    with _REG_LOCK:
        if _REGISTRY is None:
            _REGISTRY = MetricRegistry()
        return _REGISTRY
