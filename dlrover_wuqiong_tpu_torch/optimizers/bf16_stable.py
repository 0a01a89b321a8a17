"""Stable bf16 parameter training: Kahan compensation or float32 masters.

Parity: dlrover_wuqiong_tpu/optimizers/bf16_stable.py — `stable_bf16`
(:45-108) and `reset_compensation` (:111-119).  `StableBF16` wraps any of
the port's optimizers (AdamW, AGD, Adam8bit, muP's Adam) around bf16
parameters.  Two modes:

- Kahan (default): the parameters stay bf16 and the state carries a
  bf16 compensation ``e`` per parameter.  The inner rule, weight decay
  included, sees the precise view ``f32(p) + f32(e)`` and moves it to
  ``v = f32(p) + f32(e) + f32(u)``; then ``p' = bf16(v)`` and
  ``e' = bf16(v - f32(p'))``.  2 + 2 bytes a parameter.
- ``master=True``: float32 masters in the state; the inner rule sees and
  updates the master, and ``p = bf16(master)``.

The inner optimizer is built over float32 stand-ins, one per parameter
(JAX inits the inner state from a float32 view of the parameters, never
from the bf16 ones): in master mode the masters themselves; in Kahan
mode a stand-in holds no memory between steps (a 0-stride view of one
float32 zero with the parameter's shape), and during the step holds the
precise view of one parameter at a time, so the float32 transients stay
those of one leaf (`optimizers.leaf`).  The inner state is keyed by the
stand-ins.

With ``optimizer_offload`` the whole state lives in pinned host memory
between steps, as JAX puts the whole ``opt_state`` on ``pinned_host``
(dlrover_wuqiong_tpu/auto/accelerate.py:684-711): the inner moments and
the compensation or masters hop to the device one leaf at a time around
that leaf's update (`StableBF16.offload_own_state`), the arithmetic
unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import torch

from .leaf import LeafOptimizer, leaf_stepper


class StableBF16State(NamedTuple):
    """The checkpoint tree's node, JAX's field names: the inner
    optimizer's state and the compensation (Kahan) or masters."""
    inner: Any
    comp: Any


def _is_float(p: torch.Tensor) -> bool:
    return p.is_floating_point()


class StableBF16:
    """``stable_bf16(inner, master)`` around the parameters `params`;
    `inner` is the inner optimizer's factory ``params -> Optimizer``."""

    steps_own_offload = True
    offload_hops = None

    def __init__(self, params, inner: Callable, master: bool = False):
        self.params: List[torch.Tensor] = list(params)
        self.master = master
        self.param_groups = [{"params": self.params}]
        self.comp: List[torch.Tensor] = []
        self.views: List[torch.nn.Parameter] = []
        for p in self.params:
            if master:
                c = p.detach().float() if _is_float(p) else p.detach()
                view = torch.nn.Parameter(c.clone(), requires_grad=False)
                self.comp.append(view.data)
            else:
                self.comp.append(torch.zeros(
                    p.shape, dtype=torch.bfloat16, device=p.device)
                    if _is_float(p) else torch.zeros_like(p))
                view = torch.nn.Parameter(self._hollow(p),
                                          requires_grad=False)
            self.views.append(view)
        self.inner = inner(self.views)
        self._stepper = leaf_stepper(self.inner)

    @staticmethod
    def _hollow(p: torch.Tensor) -> torch.Tensor:
        """A float32 tensor of p's shape that holds one element."""
        return torch.zeros((), dtype=torch.float32,
                           device=p.device).expand(p.shape)

    @property
    def norm_fn(self):
        return getattr(self.inner, "norm_fn", None)

    @norm_fn.setter
    def norm_fn(self, fn) -> None:
        """The inner clip's norm (a mesh's global norm), if it clips."""
        if hasattr(self.inner, "norm_fn"):
            self.inner.norm_fn = fn

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def offload_own_state(self, init_state: Callable[[Any], None]):
        """The whole state to pinned host memory (``optimizer_offload``):
        the inner optimizer's per-leaf state and each compensation or
        master.  Returns the hops the steps take."""
        from .leaf import StateHops

        init_state(self.inner)
        pin = any(p.device.type == "cuda" for p in self.params)

        def host(t):
            h = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                            pin_memory=pin)
            return h.copy_(t)

        for view in self.views:
            state = self._stepper.state[view]
            for k, v in self._stepper.state_leaves(view).items():
                state[k] = host(v)
        for i, c in enumerate(self.comp):
            self.comp[i] = host(c)
            if self.master:
                self.views[i].data = self.comp[i]
        self.offload_hops = StateHops()
        return self.offload_hops

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        st = self._stepper
        own = isinstance(self.inner, LeafOptimizer)
        hops = self.offload_hops
        grads = [p.grad for p in self.params if p.grad is not None]
        ctx = st.begin_step(grads)
        group_of = {id(v): g for g in st.param_groups for v in g["params"]}
        for p, e_home, view in zip(self.params, self.comp, self.views):
            if p.grad is None or not _is_float(p):
                continue
            e = e_home
            if hops is not None:
                # this leaf's compensation (or master) and inner state on
                # the parameter's device for its update
                e = e_home.to(p.device, non_blocking=True)
                if self.master:
                    view.data = e
                hops.enter(st, view, p.device)
            if not self.master:
                view.data = p.float().add_(e.float())
            if own:
                # the port's optimizers read a bf16 gradient as float32
                # chunk by chunk
                st.update_leaf(view, group_of[id(view)], ctx, grad=p.grad)
            else:
                view.grad = p.grad.float()
                st.update_leaf(view, group_of[id(view)], ctx)
                view.grad = None
            if hops is not None:
                hops.leave(st, view)
            v = view.data
            if self.master:
                p.copy_(v)
            else:
                p.copy_(v)
                e.copy_(v.sub_(p.float()))
                view.data = self._hollow(p)
            if e is not e_home:
                e_home.copy_(e, non_blocking=True)
                if self.master:
                    view.data = e_home
            del v, e
        st.end_step(ctx)
        return loss

    def optax_tree(self, names: Dict[int, str]):
        """``StableBF16State(inner=<the inner optimizer's tree>,
        comp=<compensation or masters>)``."""
        from ..trainer.train_step import nest, optimizer_tree

        view_names = {id(v): names[id(p)]
                      for p, v in zip(self.params, self.views)}
        inner, after = optimizer_tree(self.inner, view_names)
        comp = nest({names[id(p)]: c for p, c in zip(self.params,
                                                     self.comp)})
        return StableBF16State(inner=inner, comp=comp), after


def stable_bf16(inner: Callable, master: bool = False) -> Callable:
    """The factory ``params -> StableBF16`` around `inner` (a factory)."""
    def make(params):
        return StableBF16(params, inner, master=master)
    return make


@torch.no_grad()
def reset_compensation(opt: StableBF16) -> StableBF16:
    """Re-anchor the compensation after the parameters were rewritten
    from outside (an outer sync): masters := f32(params), Kahan error
    := 0.  Returns `opt`."""
    for p, c in zip(opt.params, opt.comp):
        if not _is_float(p):
            continue
        if opt.master:
            c.copy_(p.float())
        else:
            c.zero_()
    return opt
