"""The repo's retry policy.

Parity: `retry_call` and its loop, copied from
dlrover_wuqiong_tpu/common/util.py:21-97 (stdlib only).  The rest of that
module (`sync_tree`, the transfer probe, OOM detection) is about JAX
arrays and has no use here.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional, Tuple, Type


def retry_call(fn: Callable[[], Any], *,
               attempts: Optional[int] = 3,
               deadline_s: Optional[float] = None,
               base_delay_s: float = 0.1,
               max_delay_s: float = 2.0,
               jitter: float = 0.25,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               on_retry: Optional[Callable] = None,
               label: Optional[str] = None,
               sleep: Callable[[float], None] = time.sleep) -> Any:
    """THE retry policy of this repo: bounded exponential backoff + jitter.

    Parity: reference `dlrover/python/common/grpc.py` `retry_grpc_request`
    decorator — generalized so every control-plane touch (RpcClient,
    MasterClient degraded-mode probes, kv_store_wait polling,
    multi_process IPC dials, checkpoint replica fetches, bench.py backend
    init) shares ONE policy instead of five hand-rolled loops.

    `fn` is called with no arguments.  A raised exception that is an
    instance of `retry_on` is retried until either `attempts` total calls
    were made (None = unbounded) or `deadline_s` wall-clock seconds have
    elapsed since entry (None = unbounded); the last exception is then
    re-raised.  Exceptions outside `retry_on` propagate immediately
    (e.g. RpcError from a master that ANSWERED with an error must never
    be retried — the verb may not be idempotent).

    Backoff for retry i (0-based) is `min(max_delay_s, base_delay_s*2**i)`
    scaled by a symmetric jitter factor in [1-jitter, 1+jitter] — jitter
    keeps a fleet of workers hammering a restarting master from
    synchronizing into retry storms.  The delay is additionally clipped
    to the remaining deadline.  `on_retry(n_retries, exc, delay_s)` fires
    before each sleep — callers use it for logging and for tearing down
    poisoned state (bench.py drops the dead backend client there).

    `label` (e.g. the rpc verb) opens a ``retry:<label>`` trace span
    covering the whole bounded loop, with the retry count in its attrs
    (telemetry/spans.py) — per-RPC attribution without a second timing
    path.  None (the default) keeps the call untraced and zero-cost.
    """
    if label is not None:
        from ..telemetry import spans as _spans

        with _spans.span(f"retry:{label}") as rec:
            return _retry_loop(fn, attempts, deadline_s, base_delay_s,
                               max_delay_s, jitter, retry_on, on_retry,
                               sleep, rec)
    return _retry_loop(fn, attempts, deadline_s, base_delay_s, max_delay_s,
                       jitter, retry_on, on_retry, sleep, None)


def _retry_loop(fn, attempts, deadline_s, base_delay_s, max_delay_s,
                jitter, retry_on, on_retry, sleep, span_rec) -> Any:
    if attempts is None and deadline_s is None:
        attempts = 3  # both unbounded would spin forever on a hard fault
    start = time.monotonic()
    i = 0
    while True:
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — retry loop by design
            if attempts is not None and i + 1 >= attempts:
                raise
            delay = min(max_delay_s, base_delay_s * (2.0 ** i))
            if jitter > 0:
                delay *= 1.0 + jitter * (2.0 * random.random() - 1.0)
            if deadline_s is not None:
                remaining = deadline_s - (time.monotonic() - start)
                if remaining <= 0:
                    raise
                delay = min(delay, remaining)
            i += 1
            if span_rec is not None:
                span_rec["attrs"]["retries"] = i
            if on_retry is not None:
                on_retry(i, e, delay)
            if delay > 0:
                sleep(delay)
