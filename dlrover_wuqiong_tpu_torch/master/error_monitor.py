"""Error-class catalogue → relaunch policy.

Parity: a copy of dlrover_wuqiong_tpu/master/error_monitor.py:1-203 (no
JAX), kept in the port because the port imports nothing of the JAX
package: the same classes, in the same order, with the same relaunchable
flags, the same three-pass `classify_error`, the same per-rank history
and `repeated_class` cutoff, and the same bare-137 reclassification hook.
One row differs: ``hardware`` (JAX :36-38) names the card's faults
instead of the TPU's (``libtpu``, ICI): an uncorrectable ECC error, an
Xid, "GPU is lost", a GPU fallen off the bus, an NVLink fault.  The rest
of that row (``DATA_LOSS``, ``uncorrectable``, ``interconnect``,
``INTERNAL:`` device faults) stays.  A CUDA out-of-memory error
("CUDA out of memory", torch.cuda.OutOfMemoryError) already matches
``device_oom``'s "out of memory".  (The JAX module's own parity:
reference `dlrover/python/master/monitor/error_monitor.py`.)
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

from ..common.constants import NodeExitReason
from ..common.log import get_logger

logger = get_logger("error_monitor")


# (class name, NodeExitReason, relaunchable, compiled patterns) — first
# match wins, checked top-to-bottom from most to least specific.
_CATALOG: List[Tuple[str, str, bool, re.Pattern]] = [
    ("device_oom", NodeExitReason.OOM, True, re.compile(
        r"RESOURCE_EXHAUSTED|out of memory|hbm.*exceeded|"
        r"allocat\w* .*fail\w* .*memory", re.I)),
    ("host_oom", NodeExitReason.OOM, True, re.compile(
        r"MemoryError|exit_code=137|oom[-_ ]?kill|Cannot allocate memory",
        re.I)),
    ("hardware", NodeExitReason.HARDWARE_ERROR, True, re.compile(
        r"\bECC\b|\bXid\b|GPU is lost|fallen off the bus|nvlink|"
        r"interconnect|DATA_LOSS|uncorrectable|INTERNAL:.*(device|chip)",
        re.I)),
    ("network", NodeExitReason.KILLED, True, re.compile(
        r"DEADLINE_EXCEEDED|UNAVAILABLE|connection (refused|reset)|"
        r"Connection(Reset|Refused|Aborted)Error|BrokenPipeError|"
        r"TimeoutError|coordinator|barrier timeout|socket", re.I)),
    ("preempted", NodeExitReason.KILLED, True, re.compile(
        r"preempt|evict|SIGTERM|exit_code=143", re.I)),
    ("hang", NodeExitReason.HANG, True, re.compile(
        r"\bhang\b|\bstall|watchdog", re.I)),
    ("user_code", NodeExitReason.FATAL_ERROR, False, re.compile(
        r"SyntaxError|ImportError|ModuleNotFoundError|NameError|"
        r"AttributeError|TypeError|IndentationError", re.I)),
]

_DEFAULT = ("unknown", NodeExitReason.UNKNOWN_ERROR, True)

# a traceback's final line names the exception — any *Error/*Exception not
# claimed by a specific class above is user code that restarts cannot fix
_FINAL_EXC = re.compile(r"^\w*(Error|Exception)\b")

#: classes where recurrence is expected and relaunching is the right call —
#: the repeated-class cutoff must never fire on these (preemption storms
#: and coordinator blips are exactly what elasticity exists to survive)
TRANSIENT_CLASSES = {"unknown", "preempted", "network"}

# exit_code=137 is ambiguous: the kernel OOM-killer and a preemption
# SIGKILL both exit 137.  "Bare" 137 evidence (no explicit memory text)
# can be disambiguated by the policy engine's preemption-rate estimate —
# during a kill storm the prior says preemption, and misclassifying it
# host_oom lets the repeated-class cutoff stop a rank that elasticity
# should keep relaunching (ROADMAP item 2).
_EXIT_137 = re.compile(r"exit_code=137", re.I)
_EXPLICIT_OOM = re.compile(
    r"MemoryError|oom[-_ ]?kill|Cannot allocate memory|out of memory",
    re.I)

#: MTBF at or below this is a high-preemption regime (matches
#: brain/policy.py PolicyConfig.warm_mtbf_s — the tier where the policy
#: engine already keeps a warm pool hot because kills are routine).
PREEMPT_REGIME_MTBF_S = 600.0


def classify_error(error_data: str) -> Tuple[str, str, bool]:
    """(error class, NodeExitReason, relaunchable) for an error payload.

    Three passes to keep 4KB traceback tails honest: (1) the catalogue
    against the FINAL line (the exception itself — a TypeError raised
    inside socket.py must not classify as "network" just because the frame
    paths mention sockets), (2) a generic *Error/*Exception final line →
    user_code, (3) the catalogue against the full text (multi-line XLA
    statuses, bare exit codes)."""
    text = (error_data or "").strip()
    final = next((ln.strip() for ln in reversed(text.splitlines())
                  if ln.strip()), "")
    for name, reason, relaunch, pat in _CATALOG:
        if pat.search(final):
            return name, reason, relaunch
    if _FINAL_EXC.match(final):
        return "user_code", NodeExitReason.FATAL_ERROR, False
    for name, reason, relaunch, pat in _CATALOG:
        if pat.search(text):
            return name, reason, relaunch
    return _DEFAULT


class ErrorMonitor:
    """Per-node error history + relaunch decisions from the catalogue.

    Parity: reference SimpleErrorMonitor.process_error — called on each
    NodeFailure report; dedupes repeated errors per restart and returns
    whether the class allows relaunch.
    """

    def __init__(self, preemption_rate_fn=None,
                 preemption_mtbf_cutoff_s: float = PREEMPT_REGIME_MTBF_S):
        self._lock = threading.Lock()
        # rank -> [(pod/node id, restart_count, class, error_data)]
        self._history: Dict[int, List[Tuple[int, int, str, str]]] = {}
        # optional hook to the policy engine's EWMA preemption estimator
        # (brain/policy.py PreemptionRateEstimator.rate_per_s) — None
        # keeps the estimator-free catalogue behavior unchanged
        self._preempt_rate_fn = preemption_rate_fn
        self._preempt_mtbf_cutoff_s = preemption_mtbf_cutoff_s

    def bind_preemption_estimator(self, rate_fn,
                                  mtbf_cutoff_s: Optional[float] = None):
        """Wire the policy engine's preemption-rate estimate in after
        construction (JobMaster builds the monitor before the engine)."""
        self._preempt_rate_fn = rate_fn
        if mtbf_cutoff_s is not None:
            self._preempt_mtbf_cutoff_s = mtbf_cutoff_s

    def _preemption_regime(self) -> bool:
        """True when the estimated kill MTBF is at/below the cutoff."""
        fn = self._preempt_rate_fn
        if fn is None:
            return False
        try:
            rate = float(fn())
        except Exception:  # noqa: BLE001 — estimator trouble = no prior
            return False
        return rate > 0.0 and (1.0 / rate) <= self._preempt_mtbf_cutoff_s

    def process_error(self, rank: int, restart_count: int,
                      error_data: str, level: str = "process",
                      node_id: Optional[int] = None) -> Tuple[str, bool]:
        """Record + classify; returns (NodeExitReason, relaunchable).

        `rank` is the stable identity across relaunches; `node_id` the
        current pod — the dedup key includes it so the same class failing
        again on a REPLACEMENT pod (fresh restart_count=0) still appends
        to the rank's history (that recurrence is exactly what
        `repeated_class` must see)."""
        cls, reason, relaunch = classify_error(error_data)
        if cls == "host_oom":
            text = error_data or ""
            if _EXIT_137.search(text) and not _EXPLICIT_OOM.search(text) \
                    and self._preemption_regime():
                # bare 137 during a kill storm: the rate prior says this
                # SIGKILL is a preemption, not the OOM-killer — keep it
                # TRANSIENT so the repeated-class cutoff never stops a
                # rank the scheduler is churning
                cls, reason, relaunch = ("preempted",
                                         NodeExitReason.KILLED, True)
                logger.info("rank %s: bare exit_code=137 reclassified as "
                            "preemption (estimated MTBF <= %.0fs)", rank,
                            self._preempt_mtbf_cutoff_s)
        nid = node_id if node_id is not None else rank
        with self._lock:
            hist = self._history.setdefault(rank, [])
            if not any(n == nid and rc == restart_count and c == cls
                       for n, rc, c, _ in hist):
                hist.append((nid, restart_count, cls,
                             (error_data or "")[:2000]))
                logger.error("rank %s (node %s) restart %d failed [%s → "
                             "%s, relaunch=%s]: %s", rank, nid,
                             restart_count, cls, reason, relaunch,
                             (error_data or "")[:300])
        if level == "node":
            # a node-level fault (agent died, machine gone) always needs a
            # replacement pod regardless of the message class
            return (reason if reason != NodeExitReason.FATAL_ERROR
                    else NodeExitReason.UNKNOWN_ERROR), True
        return reason, relaunch

    def error_class_history(self, rank: int) -> List[Tuple[int, str]]:
        with self._lock:
            return [(rc, cls) for _, rc, cls, _ in
                    self._history.get(rank, [])]

    def repeated_class(self, rank: int, min_repeats: int = 3
                       ) -> Optional[str]:
        """The error class seen >= min_repeats consecutive failures — a
        signal that relaunching alone will not fix this rank.

        TRANSIENT_CLASSES never qualify: bare exit codes ("unknown")
        collapse unrelated crashes into one class, and preemption/network
        recurrences are exactly what relaunching is FOR."""
        with self._lock:
            hist = self._history.get(rank, [])
        if len(hist) < min_repeats:
            return None
        tail = [cls for _, _, cls, _ in hist[-min_repeats:]]
        if len(set(tail)) == 1 and tail[0] not in TRANSIENT_CLASSES:
            return tail[0]
        return None
