"""The repo's retry policy, and the device out-of-memory test.

Parity: `retry_call` and its loop, copied from
dlrover_wuqiong_tpu/common/util.py:21-97 (stdlib only), `is_oom_error`
(:284-296) for torch, and the host-to-device probe `measure_h2d_gbps`
(:145-186) for a CUDA device.  The rest of that module (`sync_tree`)
is about JAX arrays and has no use here.
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


def is_oom_error(exc: BaseException) -> bool:
    """True when `exc` is an accelerator out-of-memory failure:
    ``torch.cuda.OutOfMemoryError``, which the caching allocator raises
    when an allocation does not fit the card.  Deliberately narrow, as
    the JAX version (which matches XLA's RESOURCE_EXHAUSTED): a host
    `MemoryError` or another error whose message mentions memory is not a
    device OOM and must not trigger device-resource fallbacks."""
    import torch

    return isinstance(exc, torch.cuda.OutOfMemoryError)


_h2d_gbps_cache: dict = {}
_H2D_PROBE_BYTES = 32 << 20


def measure_h2d_gbps(device=None) -> float:
    """Measured host->device rate in GB/s, cached per device.

    One 32 MB copy from pinned host memory to the device (the path the
    offloaded optimizer state and the offload_* remat policies take),
    after a warm-up copy.  ``DWT_H2D_GBPS`` overrides the measurement
    (tests fake a slow link; an operator can pin a known value to skip
    the probe).  `device` defaults to ``cuda``; a CPU device has no link
    to measure and raises."""
    import os

    env = os.getenv("DWT_H2D_GBPS")
    if env:
        try:
            v = float(env)
            if v > 0:  # non-positive would crash downstream estimates
                return v
        except ValueError:
            pass
    import torch

    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        raise ValueError(f"measure_h2d_gbps: {device} has no host link "
                         f"to measure")
    key = str(device)
    if key in _h2d_gbps_cache:
        return _h2d_gbps_cache[key]
    nbytes = _H2D_PROBE_BYTES
    host = torch.ones(nbytes // 4, dtype=torch.float32, pin_memory=True)
    dev = torch.empty_like(host, device=device)
    dev.copy_(host, non_blocking=True)  # warm: allocator, pinned mapping
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize(device)
    dt = max(time.perf_counter() - t0, 1e-9)
    gbps = nbytes / dt / 1e9
    _h2d_gbps_cache[key] = gbps
    return gbps
