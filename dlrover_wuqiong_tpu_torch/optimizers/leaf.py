"""Stepping an optimizer one parameter at a time, and the host-offloaded
optimizer state.

The JAX package gets both from XLA: a jit'd update streams its leaves,
and ``optimizer_offload`` gives the optimizer state a ``pinned_host``
sharding that the step moves to the device and back
(dlrover_wuqiong_tpu/trainer/train_step.py:115-120).  In torch the
update is a Python loop, so the port makes the leaf explicit:

- `LeafOptimizer` is the base of the port's own optimizers (AGD,
  Adam8bit): a step is `begin_step` (the step's scalars, the count),
  `update_leaf` for each parameter with a gradient, then `end_step`.
- `leaf_stepper` gives any optimizer that interface: a `LeafOptimizer`
  is its own; torch's Adam, AdamW and SGD (and `ClipAdamW`, whose clip
  and schedule run once in `begin_step`) step one parameter by running
  their own ``step`` with every param group cut to that parameter.
  Their per-parameter arithmetic is the same kernels on a list of one
  tensor, so a leaf-wise step is bitwise the whole step.
- `offload_state` moves an optimizer's state into host memory (pinned
  when the parameters are on CUDA) and `step_leaves(opt, hops)` runs a
  step that copies each parameter's state to its device before its
  update and back after it.  So at most one leaf's state is on the
  device at a time, and the arithmetic is the on-device step's.  The
  train step (`trainer.train_step.optimizer_step`) takes that path for
  an optimizer with ``offload_hops`` set.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch


class LeafOptimizer(torch.optim.Optimizer):
    """An optimizer whose step runs leaf by leaf.

    Subclasses define `begin_step` (returns the step's context: counts
    and scalars), `update_leaf(p, group, ctx)` (one parameter, its
    gradient in ``p.grad``) and optionally `end_step`.  `offload_hops`
    (set by `offload_state`) wraps every `update_leaf` in the copies of
    that parameter's state."""

    offload_hops: Optional["StateHops"] = None

    def begin_step(self, grads: Optional[List[torch.Tensor]] = None) -> Any:
        raise NotImplementedError

    def update_leaf(self, p: torch.Tensor, group: Dict, ctx: Any) -> None:
        raise NotImplementedError

    def end_step(self, ctx: Any) -> None:
        pass

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        step_leaves(self, self.offload_hops)
        return loss

    def state_leaves(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The per-parameter state tensors the offload moves."""
        return {k: v for k, v in self.state[p].items() if torch.is_tensor(v)}


class TorchLeaves:
    """`LeafOptimizer`'s interface over a torch optimizer whose update of
    one parameter reads no other (Adam, AdamW, SGD)."""

    def __init__(self, opt: torch.optim.Optimizer):
        self.opt = opt
        self.param_groups = opt.param_groups
        self.state = opt.state

    def begin_step(self, grads=None) -> Any:
        pre = getattr(self.opt, "pre_step", None)
        return pre(grads) if pre else None

    def update_leaf(self, p: torch.Tensor, group: Dict, ctx: Any) -> None:
        saved = [g["params"] for g in self.opt.param_groups]
        try:
            for g in self.opt.param_groups:
                g["params"] = [p] if g is group else []
            base = getattr(self.opt, "leaf_step", None)
            (base or self.opt.step)()
        finally:
            for g, ps in zip(self.opt.param_groups, saved):
                g["params"] = ps

    def end_step(self, ctx: Any) -> None:
        post = getattr(self.opt, "post_step", None)
        if post:
            post()

    def state_leaves(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self.opt.state[p]
        # torch keeps a non-capturable step count on the host already
        return {k: v for k, v in st.items()
                if torch.is_tensor(v) and k != "step"}


def leaf_stepper(opt) -> Any:
    """`opt` itself when it steps leaf by leaf, else a `TorchLeaves`."""
    if isinstance(opt, LeafOptimizer):
        return opt
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW,
                        torch.optim.SGD)):
        return TorchLeaves(opt)
    raise TypeError(f"{type(opt).__name__}: no leaf-wise step (the port "
                    f"steps Adam, AdamW, SGD and its own optimizers so)")


def step_leaves(opt, hops: Optional["StateHops"] = None) -> None:
    """One step of `opt`, leaf by leaf, each leaf's state moved by `hops`
    around its update."""
    st = leaf_stepper(opt)
    ctx = st.begin_step([p.grad for g in st.param_groups
                         for p in g["params"] if p.grad is not None])
    for group in st.param_groups:
        for p in list(group["params"]):
            if p.grad is None:
                continue
            if hops is not None:
                hops.enter(st, p)
            st.update_leaf(p, group, ctx)
            if hops is not None:
                hops.leave(st, p)
    st.end_step(ctx)


class StateHops:
    """Each parameter's state lives in host memory between steps:
    `enter` copies it to the parameter's device, `leave` copies the
    updated values back into the same host tensors.  The copies are
    issued on the current stream, in order with the update, so nothing
    waits for them; `sync` waits before the host reads the state."""

    def __init__(self):
        self._device: Dict[int, Dict[str, torch.Tensor]] = {}

    def enter(self, st, p: torch.Tensor) -> None:
        state = st.state[p]
        host = st.state_leaves(p)
        dev = {k: v.to(p.device, non_blocking=True) for k, v in host.items()}
        self._device[id(p)] = host
        state.update(dev)

    def leave(self, st, p: torch.Tensor) -> None:
        state = st.state[p]
        host = self._device.pop(id(p))
        for k, h in host.items():
            h.copy_(state[k], non_blocking=True)
            state[k] = h

    @staticmethod
    def sync(opt) -> None:
        for g in opt.param_groups:
            for p in g["params"]:
                if p.device.type == "cuda":
                    torch.cuda.current_stream(p.device).synchronize()
                    return


def offload_state(opt, init_state: Callable[[Any], None]) -> StateHops:
    """Move `opt`'s per-parameter state into host memory, pinned where
    the parameters are on CUDA; returns the hops its steps take.
    `init_state(opt)` first creates any state the optimizer makes
    lazily (torch's AdamW makes it at the first step, on the device)."""
    init_state(opt)
    st = leaf_stepper(opt)
    for group in st.param_groups:
        for p in group["params"]:
            state = st.state[p]
            for k, v in st.state_leaves(p).items():
                h = torch.empty(v.shape, dtype=v.dtype, device="cpu",
                                pin_memory=v.device.type == "cuda")
                h.copy_(v)
                state[k] = h
    hops = StateHops()
    opt.offload_hops = hops
    return hops
