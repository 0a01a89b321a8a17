"""Activation checkpointing policy for the model's blocks.

Parity: dlrover_wuqiong_tpu/ops/remat.py — `trace_remat_policy` (:37) and
`resolve_remat_policy` (:57).  "full" (the JAX default: save nothing inside
a block, recompute it all in the backward) becomes
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` around each
``Block``.  The selective and host-offload policies ("dots",
"offload_dots", "save_names", "offload_names") are not ported yet and
raise (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from torch.utils.checkpoint import checkpoint

_NOT_PORTED = ("dots", "offload_dots", "save_names", "offload_names")


def trace_remat_policy(default: Optional[str]) -> Optional[str]:
    """DWT_REMAT_POLICY, when set and non-empty, replaces the config's
    policy (read when the model runs, as the JAX package reads it when it
    traces)."""
    return os.environ.get("DWT_REMAT_POLICY", "") or default


def _full(fn: Callable, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def resolve_remat_policy(policy: Optional[str]) -> Callable:
    """The checkpoint wrapper ``wrap(block, *args)`` for `policy`."""
    if policy in (None, "", "full"):
        return _full
    if policy in _NOT_PORTED:
        raise ValueError(
            f"remat policy {policy!r} is not ported yet: only 'full' is "
            "(ROADMAP queue 1 item 3)")
    raise ValueError(
        f"unknown remat policy {policy!r}; expected one of "
        "'full', 'dots', 'offload_dots', 'save_names', 'offload_names'")
