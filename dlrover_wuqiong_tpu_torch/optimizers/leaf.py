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
  an optimizer with ``offload_hops`` set.  An optimizer that moves its
  own state (``steps_own_offload``: the port's, `StableBF16`,
  `LocalShards`) keeps the hops itself.
- `over_local_shards` builds an optimizer over a sharded model's
  parameters (FSDP2/DTensor pieces).  torch's Adam, AdamW and SGD take
  the DTensors themselves, so their state carries the parameters'
  placements; any other optimizer, and every optimizer whose state is
  offloaded, runs as a `LocalShards` over each parameter's local piece.
  Every rule the port has is elementwise within a leaf, so a piece's
  update is the update of that slice of the leaf, with one exception:
  Adam8bit quantizes a leaf's flattening in 256-element blocks, and a
  piece that is not a 256-aligned run of that flattening (an ``fsdp``
  shard of a dim other than the first) is quantized in blocks of its
  own.  `LocalShards` logs each such leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..common.log import get_logger

logger = get_logger("optimizers")


class LeafOptimizer(torch.optim.Optimizer):
    """An optimizer whose step runs leaf by leaf.

    Subclasses define `begin_step` (returns the step's context: counts
    and scalars), `update_leaf(p, group, ctx)` (one parameter, its
    gradient in ``p.grad``) and optionally `end_step`.  `offload_hops`
    (set by `offload_state`) wraps every `update_leaf` in the copies of
    that parameter's state."""

    offload_hops: Optional["StateHops"] = None
    steps_own_offload = True

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

    def enter(self, st, p: torch.Tensor, device=None) -> None:
        """`p`'s state to `device` (default: `p`'s)."""
        state = st.state[p]
        host = st.state_leaves(p)
        device = p.device if device is None else device
        dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
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
    lazily (torch's AdamW makes it at the first step, on the device).
    An optimizer with ``offload_own_state`` moves its state itself."""
    own = getattr(opt, "offload_own_state", None)
    if own is not None:
        return own(init_state)
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


def _is_torch_rule(factory) -> bool:
    """Does `factory` build torch's Adam, AdamW or SGD (or a subclass,
    such as `ClipAdamW`), which step DTensors?"""
    fn = getattr(factory, "func", factory)
    return isinstance(fn, type) and issubclass(
        fn, (torch.optim.Adam, torch.optim.AdamW, torch.optim.SGD))


def _aligned_run(index, shape, block: int) -> bool:
    """Is the piece `index` of a `shape` tensor a run of its row-major
    flattening that starts on a `block` boundary?"""
    cut = [i for i, (r, s) in enumerate(zip(index, shape)) if r != [0, s]]
    if not cut:
        return True
    d = cut[0]
    if len(cut) > 1 or any(s != 1 for s in shape[:d]):
        return False
    inner = 1
    for s in shape[d + 1:]:
        inner *= s
    return (index[d][0] * inner) % block == 0


class LocalShards:
    """An optimizer (built by `factory`) over each parameter's local
    piece: a DTensor parameter's piece is a proxy parameter sharing its
    storage, whose gradient is the piece of the DTensor's gradient at
    each step; a plain parameter is its own.  The inner state is the
    pieces' (the checkpoint lays it out as the parameters,
    `parallel.fsdp.MeshState.piece`)."""

    steps_own_offload = True
    offload_hops: Optional["StateHops"] = None
    _norm_fn: Optional[Callable] = None

    def __init__(self, params, factory: Callable):
        from ..parallel.fsdp import is_dtensor

        self.params = list(params)
        self.proxies = [torch.nn.Parameter(p.to_local(), requires_grad=False)
                        if is_dtensor(p) else p for p in self.params]
        self.param_groups = [{"params": self.proxies}]
        self.inner = factory(self.proxies)
        self._warn_blocks()

    def _warn_blocks(self) -> None:
        from ..parallel.fsdp import is_dtensor
        from ..parallel.sharding import dtensor_layout
        from .low_bit import BLOCK, Adam8bit

        rule = getattr(self.inner, "inner", self.inner)
        if not isinstance(rule, Adam8bit):
            return
        for p in self.params:
            if is_dtensor(p) and not _aligned_run(
                    dtensor_layout(p)[0], list(p.shape), BLOCK):
                logger.warning(
                    "adamw8bit over a %s piece of a %s leaf: the piece is "
                    "not a %d-aligned run of the leaf's flattening, so its "
                    "moments quantize in blocks of their own (not the "
                    "unsharded leaf's)", tuple(p.to_local().shape),
                    tuple(p.shape), BLOCK)

    @property
    def norm_fn(self) -> Optional[Callable]:
        return self._norm_fn

    @norm_fn.setter
    def norm_fn(self, fn: Optional[Callable]) -> None:
        """A clip inside (`trainer.train_step.ClipAdamW`, also under
        `StableBF16`) reads `fn` (the mesh's global norm) over the
        DTensor gradients whose pieces the proxies hold, not a norm of
        the rank's pieces alone."""
        self._norm_fn = fn
        if hasattr(self.inner, "norm_fn"):
            params = self.params
            self.inner.norm_fn = None if fn is None else (
                lambda _pieces: fn([p.grad for p in params
                                    if p.grad is not None]))

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        from ..parallel.fsdp import is_dtensor
        from ..trainer.train_step import optimizer_step

        for p, q in zip(self.params, self.proxies):
            if q is not p:
                g = p.grad
                q.grad = None if g is None else (
                    g.to_local() if is_dtensor(g) else g)
        optimizer_step(self.inner)
        for p, q in zip(self.params, self.proxies):
            if q is not p:
                q.grad = None

    def offload_own_state(self, init_state: Callable[[Any], None]
                          ) -> "StateHops":
        self.offload_hops = offload_state(self.inner, init_state)
        return self.offload_hops

    def optax_tree(self, names: Dict[int, str]):
        from ..trainer.train_step import optimizer_tree

        return optimizer_tree(self.inner, {
            id(q): names[id(p)] for p, q in zip(self.params, self.proxies)})


def over_local_shards(factory: Callable, force: bool = False) -> Callable:
    """`factory` for a sharded model's parameters: for torch's
    Adam/AdamW/SGD (unless `force`) the DTensors and the plain
    (replicated) parameters in two param groups, since a foreach kernel
    takes no mix of the two; else a `LocalShards` around it."""
    if _is_torch_rule(factory) and not force:
        def make(params):
            from ..parallel.fsdp import is_dtensor

            params = list(params)
            groups = [[p for p in params if is_dtensor(p)],
                      [p for p in params if not is_dtensor(p)]]
            return factory([{"params": g} for g in groups if g])
        return make
    return lambda params: LocalShards(params, factory)
