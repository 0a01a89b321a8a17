"""Training step builder: loss, gradients, grad norm and the optimizer update.

Parity: dlrover_wuqiong_tpu/trainer/train_step.py — `TrainState` (:35),
`accumulate_grads` (:46), `make_train_step` (:65, fused driver :143-158),
`auto_fused_steps` (:163) and `make_lm_loss` (:255), on one device.

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
  tree), or with the Trainer's chain for a `ClipAdamW`, and
  `TrainState.load_tree` writes a checkpoint back into the module and
  the optimizer.
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
from typing import Any, Callable, Dict, Optional

import torch

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

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float):
        super().__init__(params, lr=float(schedule(0)), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.schedule = schedule
        self.schedule_count = torch.zeros((), dtype=torch.float32)

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if grads:
            # optax: select(norm < max, g, g / norm * max)
            norm = global_norm(grads)
            keep = norm < self.MAX_NORM
            torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(grads, torch.where(keep, 1.0,
                                                   self.MAX_NORM))
        lr = float(self.schedule(int(self.schedule_count)))
        for group in self.param_groups:
            group["lr"] = lr
        loss = super().step(closure)
        self.schedule_count += 1
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

    @classmethod
    def create(cls, params: torch.nn.Module,
               optimizer: OptimizerFactory) -> "TrainState":
        device = next(params.parameters()).device
        return cls(step=torch.zeros((), dtype=torch.int64, device=device),
                   params=params,
                   opt_state=optimizer(list(params.parameters())))

    # ---------------------------------------------------- checkpoint tree

    def _adam_states(self) -> Dict[str, Dict]:
        """{param name: its Adam/AdamW state}, creating the state torch
        creates lazily at the first step where there is none yet (the same
        tensors `torch.optim.AdamW._init_group` makes), so a fresh state
        has every leaf of the checkpoint tree."""
        opt = self.opt_state
        if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
            raise TypeError(f"{type(opt).__name__}: the checkpoint tree maps "
                            f"torch's Adam/AdamW state onto optax.adamw's")
        groups = {id(p): g for g in opt.param_groups for p in g["params"]}
        out = {}
        for name, p in self.params.named_parameters():
            group = groups[id(p)]
            if group["amsgrad"]:
                raise ValueError("amsgrad has no optax.adamw counterpart")
            st = opt.state[p]
            if not st:
                on_device = group["capturable"] or group["fused"]
                st["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            out[name] = st
        return out

    def tree(self) -> "StateTree":
        """The live tensors (no copies) under the names JAX's
        ``flatten_state_dict`` gives a JAX `TrainState` with
        ``optax.adamw``: ``step``, ``params/<flax path>``,
        ``opt_state/0/count``, ``opt_state/0/mu/<flax path>`` (torch's
        ``exp_avg``) and ``opt_state/0/nu/<flax path>`` (``exp_avg_sq``),
        in JAX's order.  A `ClipAdamW`'s state sits where the Trainer's
        chain puts it: ``opt_state/1/0/{count,mu,nu}`` and the schedule's
        ``opt_state/1/2/count``.

        torch keeps one ``step`` count per parameter where optax keeps one
        ``count``: the tree holds the first parameter's, and a restore
        into the tree (``FlashCheckpointer.load_checkpoint(state.tree())``)
        goes through `load_tree`, which writes it into every
        parameter's."""
        states = self._adam_states()

        def nest(leaves: Dict[str, Any]) -> Dict[str, Any]:
            """``h_0.attn.c_attn.kernel`` -> the flax nesting."""
            tree: Dict[str, Any] = {}
            for name, leaf in leaves.items():
                *path, last = name.split(".")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = leaf
            return tree

        adam = OrderedDict(
            count=next(iter(states.values()))["step"],
            mu=nest({n: s["exp_avg"] for n, s in states.items()}),
            nu=nest({n: s["exp_avg_sq"] for n, s in states.items()}))
        wrap = getattr(self.opt_state, "optax_state", None)
        return StateTree(self, adam, step=self.step,
                         params=nest(dict(self.params.named_parameters())),
                         opt_state=wrap(adam) if wrap else (adam,))

    @torch.no_grad()
    def load_tree(self, flat: Dict[str, Any]) -> "TrainState":
        """Write a checkpoint's flat name→array map (``CheckpointEngine
        .load``) into the module and the optimizer, in place, on their
        devices: the parameters and moments, ``count`` (JAX int32) into
        every parameter's torch ``step``, and ``step`` (JAX int32) into
        the int64 step.  Creates AdamW's state if it has taken no step."""
        from ..checkpoint.engine import copy_into

        tree = self.tree()
        copy_into(tree, flat)
        count = tree.adam["count"]
        for st in self._adam_states().values():
            if st["step"] is not count:
                st["step"].copy_(count)
        return self


class StateTree(OrderedDict):
    """`TrainState.tree`'s mapping.  A restore into it goes through its
    state's `TrainState.load_tree`, so that torch's per-parameter step
    counts all get the restored ``count``."""

    def __init__(self, state: TrainState, adam: Dict, **tree):
        super().__init__(**tree)
        self.state = state
        self.adam = adam  # the AdamW node, wherever the layout puts it

    def load_tree(self, flat: Dict[str, Any]) -> TrainState:
        return self.state.load_tree(flat)


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
    torch._foreach_div_(grads, float(accum_steps))
    return loss_sum / accum_steps


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), float32."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(loss_fn: Callable[[torch.nn.Module, Dict], torch.Tensor],
                    accum_steps: int = 1, fused_steps: int = 1
                    ) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.

    `loss_fn(params, batch)` is a scalar loss of the model on one batch.
    With ``accum_steps > 1`` the batch leaves carry a leading microbatch
    axis of that size.  Metrics are device tensors: ``loss`` and
    ``grad_norm``.

    ``fused_steps=K > 1`` returns the fused driver instead: its batch
    leaves carry a leading axis of size K (before the microbatch axis),
    and its metrics add ``losses`` and ``grad_norms`` of shape (K,), with
    ``loss``/``grad_norm`` the last step's.  Each of the K steps is the
    K = 1 step, so K fused steps equal K single steps bit for bit.
    """

    def train_step(state: TrainState, batch: Dict):
        model = state.params
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach().float()
        else:
            def grad_fn(micro):
                micro_loss = loss_fn(model, micro)
                micro_loss.backward()
                return micro_loss

            loss = accumulate_grads(grad_fn, model, batch, accum_steps)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        gnorm = global_norm(grads)
        opt.step()
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
    family, Llama too, as in the JAX package."""
    from ..models.gpt import cross_entropy_loss

    apply = model_apply or (lambda model, idx: model(idx))

    def loss_fn(params, batch):
        return cross_entropy_loss(apply(params, batch["input_ids"]),
                                  batch["labels"])

    return loss_fn
