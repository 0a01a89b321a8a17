"""Training step builder: loss, gradients, grad norm and the optimizer update.

Parity: dlrover_wuqiong_tpu/trainer/train_step.py — `TrainState` (:35),
`accumulate_grads` (:46), `make_train_step` (:65, fused driver :143-158),
`auto_fused_steps` (:163) and `make_lm_loss` (:255, the MoE aux loss
:268-270), on one device.

PyTorch holds state in place, so the pieces map as follows:

- `TrainState.params` is the model (an ``nn.Module`` whose parameters
  are the float32 masters) and `TrainState.opt_state` the
  ``torch.optim.Optimizer`` over them.  A step updates both in place and
  returns the same state object, where JAX returns a new one.
- An optimizer argument is a factory ``params -> Optimizer``: `adamw`
  stands in for ``optax.adamw`` with optax's defaults passed explicitly
  (torch's AdamW defaults to weight_decay 1e-2, optax's to 1e-4).  Decay
  applies to every leaf, as optax's does.  The update is torch's default
  (foreach) AdamW: the same arithmetic as optax's, rounded in another
  order.
- The grad norm is ``optax.global_norm``: the float32 square root of the
  sum of squares over all leaves.
- `clip_adamw` stands in for the Trainer's ``optax.chain(
  optax.clip_by_global_norm(1.0), optax.adamw(schedule,
  weight_decay=wd))`` (`ClipAdamW`): optax's clip (the updates scaled by
  ``1 / norm`` at or above the norm, untouched below it; torch's
  ``clip_grad_norm_`` scales by ``1 / (norm + 1e-6)``), then each
  param group's lr set on the host from the schedule at the count before
  the update, as ``scale_by_schedule`` reads it.
- `TrainState.tree` gives the state's live tensors under the names JAX
  gives a `TrainState` with ``optax.adamw`` (the flash checkpoint's
  tree), or with the Trainer's chain for a `ClipAdamW`, or with the
  optax counterpart of any of the port's optimizers (`optimizer_tree`:
  AGD, adamw8bit, stable_bf16, muP's chain), and `TrainState.load_tree`
  writes a checkpoint back into the module and the optimizer.
- `optimizer_step` is the update: the optimizer's own step, or, with
  its state offloaded to the host (``optimizer_offload``), the
  leaf-wise step of optimizers/leaf.py that moves each parameter's
  state to the device and back (JAX :115-120).
- On a mesh (`parallel.fsdp.MeshState` in ``TrainState.mesh_state``)
  the parameters are FSDP2/DTensor pieces, the batch is the rank's
  slice of the global batch, and the step's ``loss`` and ``grad_norm``
  are the global values: the loss averaged over the data ranks (the
  global batch's mean for equal slices; FSDP2 averages the gradients so
  too), and the norm over every distinct piece once.  `TrainState.tree`
  gives the checkpoint DTensors over the whole mesh, and `load_tree`
  keeps each rank's slice of global arrays.
- ``fused_steps=K > 1`` runs the same step K times in a Python loop over
  batches stacked on a leading axis of size K; the per-step losses and
  grad norms stay on the device, so a fusion needs one host readback.
  (A CUDA graph of the K steps comes later.)
"""

from __future__ import annotations

import dataclasses
import functools
import math
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..optimizers.leaf import StateHops, step_leaves

OptimizerFactory = Callable[[Any], torch.optim.Optimizer]


def adamw(learning_rate: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> OptimizerFactory:
    """``optax.adamw(learning_rate)`` with optax's defaults, as a factory of
    ``torch.optim.AdamW`` (default foreach implementation)."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


class ClipAdamW(torch.optim.AdamW):
    """``optax.chain(optax.clip_by_global_norm(1.0),
    optax.adamw(schedule, weight_decay=weight_decay))`` on torch's AdamW,
    with optax's other defaults.

    `step` clips the gradients as optax does (no host sync: the scale is
    a device tensor), sets every group's lr to ``schedule(count)`` from
    the host-side count of updates taken so far, steps, and counts.  The
    count is `schedule_count`, a CPU tensor that the checkpoint tree
    carries as ``opt_state/1/2/count`` (optax's ``ScaleByScheduleState``),
    so a restored optimizer resumes the schedule where it stopped."""

    MAX_NORM = 1.0
    #: the norm of the gradients (a mesh's `MeshState.global_norm` on a
    #: sharded state)
    norm_fn: Callable = None

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float):
        super().__init__(params, lr=float(schedule(0)), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.schedule = schedule
        self.schedule_count = torch.zeros((), dtype=torch.float32)

    @torch.no_grad()
    def pre_step(self, grads) -> None:
        """optax's clip of `grads` (in place) and the schedule's lr into
        every group."""
        if grads:
            # optax: select(norm < max, g, g / norm * max)
            norm = (self.norm_fn or global_norm)(grads)
            keep = norm < self.MAX_NORM
            for part in by_kind(grads):
                torch._foreach_div_(part, torch.where(keep, 1.0, norm))
                torch._foreach_mul_(part, torch.where(keep, 1.0,
                                                      self.MAX_NORM))
        lr = float(self.schedule(int(self.schedule_count)))
        for group in self.param_groups:
            group["lr"] = lr

    def leaf_step(self):
        """AdamW's own update, without the clip and the count (the
        leaf-wise step of optimizers/leaf.py runs those once)."""
        return torch.optim.AdamW.step(self)

    def post_step(self) -> None:
        self.schedule_count += 1

    @torch.no_grad()
    def step(self, closure=None):
        self.pre_step([p.grad for g in self.param_groups
                       for p in g["params"] if p.grad is not None])
        loss = super().step(closure)
        self.post_step()
        return loss

    def optax_state(self, adam: Dict) -> tuple:
        """The chain's state around adamw's `adam` node: (clip's
        EmptyState, (ScaleByAdamState, add_decayed_weights' EmptyState,
        ScaleByScheduleState))."""
        return ((), (adam, (), OrderedDict(count=self.schedule_count)))


def clip_adamw(schedule: Callable[[int], float],
               weight_decay: float) -> OptimizerFactory:
    """The Trainer's optimizer, ``optax.chain(clip_by_global_norm(1.0),
    adamw(schedule, weight_decay=weight_decay))``, as a factory of
    `ClipAdamW`."""
    return functools.partial(ClipAdamW, schedule=schedule,
                             weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor            # int64 scalar on the device
    params: torch.nn.Module
    opt_state: torch.optim.Optimizer
    # the mesh of a sharded state (parallel.fsdp.MeshState), or None
    mesh_state: Any = None

    @classmethod
    def create(cls, params: torch.nn.Module, optimizer: OptimizerFactory,
               mesh_state: Any = None) -> "TrainState":
        p = next(params.parameters())
        device = p.to_local().device if hasattr(p, "to_local") else p.device
        opt = optimizer(list(params.parameters()))
        if mesh_state is not None and hasattr(opt, "norm_fn"):
            opt.norm_fn = mesh_state.global_norm
        return cls(step=torch.zeros((), dtype=torch.int64, device=device),
                   params=params, opt_state=opt, mesh_state=mesh_state)

    # ---------------------------------------------------- checkpoint tree

    def tree(self) -> "StateTree":
        """The live tensors (no copies) under the names JAX's
        ``flatten_state_dict`` gives a JAX `TrainState` with the same
        optax optimizer: ``step``, ``params/<flax path>`` and the
        optimizer's node (`optimizer_tree`), in JAX's order.  With
        ``optax.adamw``: ``opt_state/0/count``, ``opt_state/0/mu/<flax
        path>`` (torch's ``exp_avg``) and ``opt_state/0/nu/<flax path>``
        (``exp_avg_sq``); a `ClipAdamW`'s state sits where the Trainer's
        chain puts it: ``opt_state/1/0/{count,mu,nu}`` and the schedule's
        ``opt_state/1/2/count``.  An offloaded state's leaves are its host
        tensors, read after the device's copies into them are done.

        torch keeps one Adam ``step`` count per parameter where optax
        keeps one ``count``: the tree holds the first parameter's, and a
        restore into the tree (``FlashCheckpointer.load_checkpoint(
        state.tree())``) goes through `load_tree`, which writes it into
        every parameter's."""
        opt = self.opt_state
        if getattr(opt, "offload_hops", None) is not None:
            StateHops.sync(opt)
        names = {id(p): n for n, p in self.params.named_parameters()}
        node, after_load = optimizer_tree(opt, names)
        tree = StateTree(self, after_load, step=self.step,
                         params=nest(dict(self.params.named_parameters())),
                         opt_state=node)
        if self.mesh_state is not None:
            # every leaf as this rank's piece of the global leaf: the
            # checkpoint writes each distinct piece once, as JAX's
            # name#shardN
            names = {n.replace(".", "/"): p
                     for n, p in self.params.named_parameters()}
            tree = StateTree(self, after_load, **_map_leaves(
                lambda path, t: self.mesh_state.piece(path, t, names),
                OrderedDict(tree)))
        return tree

    @torch.no_grad()
    def load_tree(self, flat: Dict[str, Any]) -> "TrainState":
        """Write a checkpoint's flat name→array map (``CheckpointEngine
        .load``) into the module and the optimizer, in place, on their
        devices (an offloaded state into its host tensors): the
        parameters and the optimizer's leaves, and ``step`` (JAX int32)
        into the int64 step; then the optimizer's own fix-up (torch's
        Adam: ``count`` into every parameter's ``step``)."""
        from ..checkpoint.engine import copy_into

        tree = self.tree()
        copy_into(tree, flat)
        if tree.after_load is not None:
            tree.after_load()
        return self


def _map_leaves(fn: Callable, node: Any, path: str = "",
                is_leaf: Callable[[Any], bool] = torch.is_tensor) -> Any:
    """`node` with ``fn(path, leaf)`` applied to every leaf (a tensor, or
    what `is_leaf` says), its path "/"-joined as the checkpoint names it
    (dicts, NamedTuples, lists and tuples rebuilt around them)."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)

    if is_leaf(node):
        return fn(path, node)
    if isinstance(node, dict):
        return type(node)((k, _map_leaves(fn, v, sub(k), is_leaf))
                          for k, v in node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_leaves(fn, getattr(node, f), sub(f),
                                        is_leaf)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_map_leaves(fn, v, sub(i), is_leaf)
                          for i, v in enumerate(node))
    return node


def nest(leaves: Dict[str, Any]) -> Dict[str, Any]:
    """{``h_0.attn.c_attn.kernel``: leaf} -> the flax nesting."""
    tree: Dict[str, Any] = {}
    for name, leaf in leaves.items():
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def adam_states(opt: torch.optim.Optimizer) -> Dict[int, Dict]:
    """{id(param): its Adam/AdamW state}, creating the state torch
    creates lazily at the first step where there is none yet (the
    tensors `torch.optim.AdamW._init_group` makes, of the parameter's
    shape and dtype), so a fresh state has every leaf of the checkpoint
    tree."""
    out = {}
    for group in opt.param_groups:
        if group["amsgrad"]:
            raise ValueError("amsgrad has no optax.adamw counterpart")
        for p in group["params"]:
            st = opt.state[p]
            if not st:
                on_device = group["capturable"] or group["fused"]
                st["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
                # zeros_like: a DTensor parameter's moments are DTensors
                # of its placements
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            out[id(p)] = st
    return out


def ensure_state(opt) -> None:
    """Create the optimizer state torch makes lazily (Adam, AdamW); the
    port's own optimizers make theirs when built.  A wrapper's (`inner`)
    is its inner optimizer's."""
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        adam_states(opt)
    elif getattr(opt, "inner", None) is not None:
        ensure_state(opt.inner)


def optimizer_tree(opt, names: Dict[int, str]) -> Tuple[Any, Optional[
        Callable[[], None]]]:
    """(the optax-shaped node of `opt`'s state, a fix-up to run after a
    restore wrote into it, or None).  `names` maps ``id(param)`` to the
    parameter's dotted flax name.  The port's optimizers give their own
    (``optax_tree``); torch's Adam and AdamW give optax.adamw's node,
    placed by the optimizer's ``optax_state`` where a chain nests it."""
    own = getattr(opt, "optax_tree", None)
    if own is not None:
        return own(names)
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError(f"{type(opt).__name__}: the checkpoint tree maps "
                        f"the port's optimizers and torch's Adam/AdamW "
                        f"onto optax's state")
    states = adam_states(opt)
    ps = [p for g in opt.param_groups for p in g["params"]]
    adam = OrderedDict(
        count=states[id(ps[0])]["step"],
        mu=nest({names[id(p)]: states[id(p)]["exp_avg"] for p in ps}),
        nu=nest({names[id(p)]: states[id(p)]["exp_avg_sq"] for p in ps}))
    wrap = getattr(opt, "optax_state", None)

    def after_load():
        count = adam["count"]
        for st in states.values():
            if st["step"] is not count:
                st["step"].copy_(count)

    return (wrap(adam) if wrap else (adam,)), after_load


class StateTree(OrderedDict):
    """`TrainState.tree`'s mapping.  A restore into it goes through its
    state's `TrainState.load_tree`, so that the optimizer's fix-up runs
    (torch's per-parameter step counts all get the restored
    ``count``)."""

    def __init__(self, state: TrainState,
                 after_load: Optional[Callable[[], None]], **tree):
        super().__init__(**tree)
        self.state = state
        self.after_load = after_load

    def load_tree(self, flat: Dict[str, Any]) -> TrainState:
        return self.state.load_tree(flat)


def optimizer_step(opt) -> None:
    """`opt`'s step; with its state offloaded (`optimizers.leaf
    .offload_state`), leaf by leaf through the host hops."""
    hops = getattr(opt, "offload_hops", None)
    if hops is None or getattr(opt, "steps_own_offload", False):
        opt.step()
    else:
        step_leaves(opt, hops)


def by_kind(tensors) -> list:
    """`tensors` split into its DTensors and its plain tensors (empty
    lists dropped): a foreach kernel takes no mix of the two."""
    from ..parallel.fsdp import is_dtensor

    parts = [[t for t in tensors if is_dtensor(t)],
             [t for t in tensors if not is_dtensor(t)]]
    return [p for p in parts if p]


def accumulate_grads(grad_fn: Callable[[Any], torch.Tensor],
                     params: torch.nn.Module, batch: Dict,
                     accum_steps: int) -> torch.Tensor:
    """Mean loss over the leading microbatch axis of `batch`, with the mean
    gradient left in each parameter's ``.grad``.

    ``grad_fn(micro) -> loss`` computes one microbatch's loss and runs its
    backward, which adds the gradient into ``.grad`` (float32, like the
    parameters): the sum over microbatches, divided by `accum_steps` at
    the end, as the JAX version sums its float32 accumulators."""
    loss_sum = None
    for i in range(accum_steps):
        loss = grad_fn({k: v[i] for k, v in batch.items()}).detach().float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = [p.grad for p in params.parameters() if p.grad is not None]
    for part in by_kind(grads):
        torch._foreach_div_(part, float(accum_steps))
    return loss_sum / accum_steps


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), float32.  Each leaf's norm
    accumulates in float32 inside the kernel: a float32 copy of every
    bf16 gradient at once would be 4 bytes a parameter (25 GB for
    Llama-3 8B at 24 layers under stable_bf16)."""
    norms = torch._foreach_norm(grads, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(loss_fn: Callable[[torch.nn.Module, Dict], torch.Tensor],
                    accum_steps: int = 1, fused_steps: int = 1,
                    value_and_grad_fn: Optional[Callable] = None
                    ) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.

    `loss_fn(params, batch)` is a scalar loss of the model on one batch.
    With ``accum_steps > 1`` the batch leaves carry a leading microbatch
    axis of that size.  Metrics are device tensors: ``loss`` and
    ``grad_norm``.  `value_and_grad_fn(params, batch)`, when given,
    replaces ``loss_fn(...).backward()``: it fills ``.grad`` and returns
    the loss (JAX's `value_and_grad_fn` :82; the pipeline schedules of
    parallel/pipeline.py), one call a microbatch under ``accum_steps``.

    ``fused_steps=K > 1`` returns the fused driver instead: its batch
    leaves carry a leading axis of size K (before the microbatch axis),
    and its metrics add ``losses`` and ``grad_norms`` of shape (K,), with
    ``loss``/``grad_norm`` the last step's.  Each of the K steps is the
    K = 1 step, so K fused steps equal K single steps bit for bit.
    """

    def train_step(state: TrainState, batch: Dict):
        model = state.params
        opt = state.opt_state
        mesh = state.mesh_state
        opt.zero_grad(set_to_none=True)

        def grad_fn(micro):
            if value_and_grad_fn is not None:
                return value_and_grad_fn(model, micro)
            micro_loss = loss_fn(model, micro)
            micro_loss.backward()
            return micro_loss

        if accum_steps == 1:
            loss = grad_fn(batch).detach().float()
        else:
            loss = accumulate_grads(grad_fn, model, batch, accum_steps)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if mesh is not None:
            mesh.reduce_grads()
            grads = [p.grad for p in model.parameters()
                     if p.grad is not None]
            gnorm = mesh.global_norm(grads)
            loss = mesh.mean(loss)
        else:
            gnorm = global_norm(grads)
        optimizer_step(opt)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    if fused_steps <= 1:
        return train_step

    def fused_train_step(state: TrainState, batches: Dict):
        losses, gnorms = [], []
        for i in range(fused_steps):
            state, m = train_step(state, {k: v[i] for k, v in
                                          batches.items()})
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        losses = torch.stack(losses)
        gnorms = torch.stack(gnorms)
        return state, {"loss": losses[-1], "grad_norm": gnorms[-1],
                       "losses": losses, "grad_norms": gnorms}

    return fused_train_step


def auto_fused_steps(step_time_s: float, overhead_s: float,
                     target_overhead: float = 0.02, cap: int = 64,
                     cadence: int = 0) -> int:
    """Pick K so the per-dispatch overhead is < `target_overhead` of a
    K-step fusion: K >= overhead / (target * step_time), clamped to
    [1, cap] and then to the largest divisor of `cadence` (the gcd of the
    trainer's hook cadences) so hooks stay reachable at fusion
    boundaries.  The caller measures `overhead_s` (the JAX version's
    probe times an XLA dispatch)."""
    if step_time_s <= 0:
        k = cap
    else:
        k = math.ceil(overhead_s / (target_overhead * step_time_s))
    k = max(1, min(k, cap))
    if cadence > 0:
        k = min(k, cadence)
        while cadence % k:
            k -= 1
    return k


def make_lm_loss(model_apply: Optional[Callable] = None) -> Callable:
    """Causal-LM loss over a batch dict {input_ids, labels}:
    ``loss_fn(params, batch)``, where `params` is the model and
    ``model_apply(params, input_ids)`` (default: calling the model)
    gives the logits.  GPT's `cross_entropy_loss` serves every model
    family, Llama too, as in the JAX package.  The MoE aux losses of the
    forward (the model's ``intermediates``, as flax sows them) are added
    when there are any."""
    from ..models.gpt import cross_entropy_loss

    apply = model_apply or (lambda model, idx: model(idx))

    def loss_fn(params, batch):
        loss = cross_entropy_loss(apply(params, batch["input_ids"]),
                                  batch["labels"])
        inter = getattr(params, "intermediates", None)
        if inter:
            from ..models.moe import collect_moe_aux_loss

            loss = loss + collect_moe_aux_loss(inter)
        return loss

    return loss_fn
