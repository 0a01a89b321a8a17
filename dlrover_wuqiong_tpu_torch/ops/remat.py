"""Activation checkpointing policies for the models' blocks.

Parity: dlrover_wuqiong_tpu/ops/remat.py — `MODEL_CHECKPOINT_NAMES` (:33),
`trace_remat_policy` (:36) and `resolve_remat_policy` (:54), with the
anchors of ``jax.ad_checkpoint.checkpoint_name`` as `checkpoint_name`.
Each policy wraps a block in ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``:

- "full" (None, ""): save nothing inside the block, recompute it all in
  the backward.
- "dots": keep the outputs of the 2-D products (``aten.mm``,
  ``aten.addmm`` and the fp8 ``aten._scaled_mm``) on the device and
  recompute everything else, the flash ``autograd.Function``s and the
  batched products included, as ``dots_with_no_batch_dims_saveable``
  saves dots without batch dims.
- "save_names": keep only the tensors anchored by `checkpoint_name` under
  `names` (default ``("attn_out", "mlp_out")``).
- "offload_dots" / "offload_names": the same tensors, and only they, are
  copied to pinned host memory in the forward and brought back for the
  backward.  The block's input, which the checkpoint itself keeps, stays
  on the device, as JAX's residuals do.

The selection is torch's selective checkpointing (``context_fn``): a
dispatch mode in the forward keeps the outputs of the chosen ops, and one
in the recompute hands them back in the same order instead of running
those ops again, as ``create_selective_checkpoint_contexts`` does with
``MUST_SAVE``.  The two modes here are that pair with one addition: they
can keep what they hold on the host.  `OFFLOAD_BYTES` counts the bytes
copied each way.

An anchor is an op only inside a block that a *_names policy wraps (a
clone the modes can see, ``dwt::checkpoint_name``); everywhere else
`checkpoint_name` returns its input, as the JAX primitive is an identity.

Two differences from ``jax.checkpoint``, both of eager recompute: the
recompute runs the block's ops in order and skips only those whose
outputs were kept, so keeping an anchor spares that anchor's copy and
nothing before it (JAX's partial evaluation also drops what the kept
value makes unneeded); and it stops once every tensor the backward needs
is back, so a block's last projection is not run again and its
``mlp_out`` anchor is never brought back from the host.
"""

from __future__ import annotations

import collections
import contextvars
import os
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

#: anchor names the models emit (models/gpt.py and models/llama.py blocks)
MODEL_CHECKPOINT_NAMES = ("attn_out", "mlp_out")
POLICIES = ("full", "dots", "offload_dots", "save_names", "offload_names")

#: bytes the offload policies copied to the host ("d2h") and back ("h2d")
#: since the last `reset_offload_bytes`
OFFLOAD_BYTES: Dict[str, int] = {"d2h": 0, "h2d": 0}

_ANCHORING = contextvars.ContextVar("dwt_remat_anchoring", default=False)


def reset_offload_bytes() -> None:
    for k in OFFLOAD_BYTES:
        OFFLOAD_BYTES[k] = 0


@torch.library.custom_op("dwt::checkpoint_name", mutates_args=())
def _anchor(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_anchor.register_fake
def _(x, name):
    return torch.empty_like(x)


_anchor.register_autograd(lambda ctx, g: (g, None))
_ANCHOR_OP = torch.ops.dwt.checkpoint_name.default
_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten._scaled_mm)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Marks `x` as the anchor `name` for the *_names policies."""
    return _anchor(x, name) if _ANCHORING.get() else x


def trace_remat_policy(default: Optional[str]) -> Optional[str]:
    """DWT_REMAT_POLICY, when set and non-empty, replaces the config's
    policy (read when the model runs, as the JAX package reads it when it
    traces)."""
    return os.environ.get("DWT_REMAT_POLICY", "") or default


def _to_host(t: torch.Tensor):
    """A host copy of `t` (pinned, issued on the stream, for a CUDA
    tensor; a plain copy for a CPU one) and the device to bring it back
    to."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    host.copy_(t, non_blocking=t.is_cuda)
    OFFLOAD_BYTES["d2h"] += t.numel() * t.element_size()
    return host, t.device


def _to_device(held) -> torch.Tensor:
    host, device = held
    OFFLOAD_BYTES["h2d"] += host.numel() * host.element_size()
    return host.to(device, non_blocking=True)


class _Held(TorchDispatchMode):
    """A dispatch mode over the ops `pick` chooses and the queue `held`
    of their kept outputs (host copies with `offload`)."""

    def __init__(self, pick: Callable, held: collections.deque,
                 offload: bool):
        super().__init__()
        self.pick, self.held, self.offload = pick, held, offload


class _Keep(_Held):
    """Forward: runs every op, and keeps the outputs of those `pick`
    chooses, in order (on the host with `offload`)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.pick(func, args):
            self.held.append(_to_host(out) if self.offload
                             else out.detach())
        return out


class _Reuse(_Held):
    """Recompute: hands back what `_Keep` kept for the chosen ops and
    runs every other op again."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.pick(func, args):
            held = self.held.popleft()
            return _to_device(held) if self.offload else held
        return func(*args, **(kwargs or {}))


def _full(fn: Callable, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def resolve_remat_policy(policy: Optional[str],
                         names: Sequence[str] = MODEL_CHECKPOINT_NAMES
                         ) -> Callable:
    """The checkpoint wrapper ``wrap(block, *args)`` for `policy`."""
    if policy in (None, "", "full"):
        return _full
    if policy not in POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; expected one of "
            "'full', 'dots', 'offload_dots', 'save_names', 'offload_names'")
    offload = policy.startswith("offload_")
    if policy.endswith("dots"):
        anchored = False

        def pick(func, args):
            return func.overloadpacket in _DOTS
    else:
        anchored, names = True, frozenset(names)

        def pick(func, args):
            return func is _ANCHOR_OP and args[1] in names

    def contexts():
        held = collections.deque()
        return _Keep(pick, held, offload), _Reuse(pick, held, offload)

    def wrap(fn: Callable, *args):
        run = fn
        if anchored:
            def run(*a):
                token = _ANCHORING.set(True)
                try:
                    return fn(*a)
                finally:
                    _ANCHORING.reset(token)
        return checkpoint(run, *args, use_reentrant=False,
                          context_fn=contexts)

    return wrap
