"""Local SGD / HSDP: DiLoCo-style two-level optimization.

Parity: dlrover_wuqiong_tpu/parallel/local_sgd.py — `LocalSGDConfig`
(:40), `DiLoCoState` (:50, the same field names), `_reduce_delta` (mean
and GTA, :58-74), `make_diloco_train_step` (:77) and `init_diloco_state`
(:203).

The ``dp`` dim of the mesh is the replica-group dim.  JAX stacks the
inner replicas on a leading axis sharded over ``dp`` and runs the step
under ``shard_map`` over it; in torch each rank simply holds its own
group's replica: the model is sharded by FSDP2 over the ``fsdp`` dim
only (`parallel.fsdp.shard_model` with ``replica_dim="dp"``), so a
group's gradients, loss mean and clip norm stay inside the group, and
the groups train apart.  Every `LocalSGDConfig.sync_every` steps the
step reduces the outer delta (the outer parameters minus the group's
inner ones, float32) over ``dp`` — one all-reduce per H steps instead
of per step, the point of DiLoCo — takes a Nesterov outer step on the
outer parameters and restarts every group from them.  The reduction is
the mean or GTA (sign-agreement gated averaging).

`DiLoCoState` holds this rank's pieces: the inner model and optimizer
(``inner_params``, ``inner_opt_state``), and the outer parameters and
float32 momentum as {name: piece} laid out as the parameters
(``outer_params``, ``outer_momentum``).  Its checkpoint tree
(`DiLoCoState.tree`) has JAX's names and layout: ``step``; the inner
leaves stacked over the groups, group r's piece at ``[r, ...]`` (JAX's
``P("dp", ...)``, ``inner_params/<path>``, ``inner_opt_state/...``); the
outer trees as the parameters (``outer_params/<path>``,
``outer_momentum/<path>``).  The two packages' DiLoCo checkpoints are so
interchangeable.

The step's body takes its transport as an argument (``psum``, the sum
over the groups): `make_diloco_train_step` runs it over ``dp`` in a
world, and `emulated_step` for groups held in one process (what one card
can check: NCCL puts no two ranks on one GPU).
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..common.log import get_logger

logger = get_logger("local_sgd")


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    sync_every: int = 16          # H: inner steps between outer syncs
    outer_lr: float = 0.7         # DiLoCo paper's SGD+Nesterov outer opt
    outer_momentum: float = 0.9
    nesterov: bool = True
    reduce: str = "mean"          # "mean" | "gta"
    gta_threshold: float = 0.0    # min sign-agreement fraction for gta


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


@dataclasses.dataclass
class DiLoCoState:
    step: torch.Tensor             # int64 scalar on the device
    inner_params: torch.nn.Module  # this rank's group replica
    inner_opt_state: Any           # its optimizer (this rank's pieces)
    outer_params: Dict[str, torch.Tensor]    # name -> piece, param dtype
    outer_momentum: Dict[str, torch.Tensor]  # name -> piece, float32
    # the mesh side (parallel.fsdp.MeshState, replica_dim "dp"), or None
    # for a group that is one device
    mesh_state: Any = None
    # the steps taken, on the host (the sync cadence reads no device)
    host_step: int = 0

    def inner_state(self):
        """The group's `trainer.train_step.TrainState` over the inner
        model and optimizer (the same objects and step tensor)."""
        from ..trainer.train_step import TrainState

        return TrainState(step=self.step, params=self.inner_params,
                          opt_state=self.inner_opt_state,
                          mesh_state=self.mesh_state)

    def _replicas(self):
        ms = self.mesh_state
        if ms is None:
            return 0, 1, 1
        import torch.distributed as dist

        return ms.replica, ms.replicas, dist.get_world_size()

    def tree(self):
        """The checkpoint tree (module docstring): `MeshPiece`s of the
        live tensors under JAX's `DiLoCoState` names."""
        from ..checkpoint.shm_handler import MeshPiece
        from ..trainer.train_step import StateTree, _map_leaves, nest

        inner = self.inner_state().tree()
        r, n, numbers = self._replicas()

        def stack(path, leaf):
            if not isinstance(leaf, MeshPiece):
                leaf = MeshPiece(leaf, leaf.shape,
                                 [[0, s] for s in leaf.shape])
            return leaf.stacked(r, n, numbers)

        def stacked(node):
            return _map_leaves(stack, node, is_leaf=lambda x: isinstance(
                x, MeshPiece) or torch.is_tensor(x))

        params = dict(self.inner_params.named_parameters())
        ms = self.mesh_state

        def outer(name, t):
            if ms is None:
                return t
            shape, index, number, owner = ms._layout(params[name])
            return MeshPiece(t, shape, index, number, owner and r == 0)

        tree = OrderedDict(
            step=self.step if ms is None else MeshPiece(
                self.step, [], [], 0, ms._owner(self.step) and r == 0),
            inner_params=stacked(inner["params"]),
            inner_opt_state=stacked(inner["opt_state"]),
            outer_params=nest({n_: outer(n_, t) for n_, t in
                               self.outer_params.items()}),
            outer_momentum=nest({n_: outer(n_, t) for n_, t in
                                 self.outer_momentum.items()}))
        return StateTree(self, inner.after_load, **tree)

    @torch.no_grad()
    def load_tree(self, flat: Dict[str, Any]) -> "DiLoCoState":
        """Write a checkpoint's flat name→array map into the state, in
        place (the inner optimizer's fix-up too), and the host's step."""
        from ..checkpoint.engine import copy_into

        tree = self.tree()
        copy_into(tree, flat)
        if tree.after_load is not None:
            tree.after_load()
        self.host_step = int(self.step)
        return self


def init_diloco_state(state, cfg: LocalSGDConfig) -> DiLoCoState:
    """A group's `DiLoCoState` from its inner `TrainState` (the model and
    optimizer, this rank's pieces): the outer parameters a copy of the
    inner ones, the outer momentum float32 zeros, both laid out as the
    parameters (JAX :203-250)."""
    with torch.no_grad():
        outer = OrderedDict((n, _local(p).detach().clone())
                            for n, p in state.params.named_parameters())
        mom = OrderedDict((n, torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device))
                          for n, t in outer.items())
    return DiLoCoState(step=state.step, inner_params=state.params,
                       inner_opt_state=state.opt_state, outer_params=outer,
                       outer_momentum=mom, mesh_state=state.mesh_state,
                       host_step=int(state.step))


def _reduce_delta(deltas: Sequence[torch.Tensor], cfg: LocalSGDConfig,
                  psum: Callable[[Sequence[torch.Tensor]], torch.Tensor],
                  n: int) -> torch.Tensor:
    """The reduced outer delta of one leaf over the `n` groups: the mean
    or GTA (elementwise, the mean gated to the components whose sign
    agrees across the groups more than `gta_threshold`, scaled by the
    agreement).  `deltas` are this process's groups' deltas (one in a
    world), ``psum(ts)`` their sum over every group."""
    inv = torch.tensor(1.0 / n, dtype=torch.float32,
                       device=deltas[0].device)
    mean = psum(deltas).mul_(inv)
    if cfg.reduce == "mean":
        return mean
    if cfg.reduce != "gta":
        raise ValueError(f"local_sgd reduce {cfg.reduce!r}: mean or gta")
    agree = psum([torch.sign(d) for d in deltas]).mul_(inv).abs_()
    gate = (agree > cfg.gta_threshold).to(mean.dtype)
    return mean.mul_(gate).mul_(agree)


@torch.no_grad()
def outer_sync(states: Sequence[DiLoCoState], cfg: LocalSGDConfig,
               psum: Callable, n: int,
               reset_opt_on_sync: Optional[Callable] = None) -> None:
    """The outer step of `states` (this process's groups) over all `n`
    groups (JAX :124-148): per leaf the delta ``f32(w - p)`` reduced
    over the groups, the momentum ``mu m + d``, the Nesterov direction
    ``mu m + d`` (else m), ``w = cast(f32(w) - lr dir)``, then every
    group restarts from w (and `reset_opt_on_sync(opt)` re-anchors
    state that derives the parameters: stable_bf16's)."""
    mu = cfg.outer_momentum
    inner = [dict(s.inner_params.named_parameters()) for s in states]
    for name in states[0].outer_params:
        ps = [_local(params[name]) for params in inner]
        deltas = [(s.outer_params[name] - p).float()
                  for s, p in zip(states, ps)]
        delta = _reduce_delta(deltas, cfg, psum, n)
        for s, p in zip(states, ps):
            m = s.outer_momentum[name]
            m.mul_(mu).add_(delta)
            step_dir = m.mul(mu).add_(delta) if cfg.nesterov else m
            w = s.outer_params[name]
            w.copy_(w.float().sub_(step_dir.mul(cfg.outer_lr)))
            p.copy_(w)
    if reset_opt_on_sync is not None:
        for s in states:
            reset_opt_on_sync(s.inner_opt_state)


def _dp_psum(group):
    """The sum over the groups of a world: an all-reduce over ``dp``."""
    import torch.distributed as dist

    def psum(ts):
        (t,) = ts
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t
    return psum


def _emulated_psum(ts):
    return functools.reduce(torch.add, ts)


def make_diloco_train_step(loss_fn: Callable, cfg: LocalSGDConfig,
                           accum_steps: int = 1,
                           reset_opt_on_sync: Optional[Callable] = None
                           ) -> Callable:
    """``step(DiLoCoState, batch) -> (DiLoCoState, {"loss"})`` in a
    world whose mesh has a ``dp`` dim of the replica groups.

    The batch is this rank's slice of the global batch over (dp, fsdp):
    each group trains its replica on its rows (with ``accum_steps > 1``
    over a leading microbatch axis, accumulated inside the group).  The
    loss is the groups' mean (JAX's ``pmean`` over dp).  An optimizer
    offloaded to the host (``optimizer_offload``) keeps its state there
    between steps, as in the one-group step; the outer trees stay on the
    device."""
    from ..trainer.train_step import make_train_step

    inner = make_train_step(loss_fn, accum_steps)

    def train_step(state: DiLoCoState, batch):
        ms = state.mesh_state
        group = ms.mesh.get_group("dp")
        psum = _dp_psum(group)
        _, m = inner(state.inner_state(), batch)
        state.host_step += 1
        if state.host_step % cfg.sync_every == 0:
            outer_sync([state], cfg, psum, ms.replicas, reset_opt_on_sync)
        loss = psum([m["loss"]]).div_(ms.replicas)
        return state, {"loss": loss}

    return train_step


def emulated_step(states: Sequence[DiLoCoState], batches: Sequence,
                  step_fn: Callable, cfg: LocalSGDConfig,
                  reset_opt_on_sync: Optional[Callable] = None
                  ) -> Tuple[List[Any], torch.Tensor]:
    """One DiLoCo step of ``len(states)`` replica groups held in this
    process, group r on ``batches[r]``: each group's inner step
    (`step_fn`, a `trainer.train_step.make_train_step` step), then at a
    sync the outer step with the sum over the groups a sum of tensors
    (`make_diloco_train_step`'s body, its transport swapped).  Returns
    (each group's metrics, the groups' mean loss)."""
    metrics = []
    for s, b in zip(states, batches):
        _, m = step_fn(s.inner_state(), b)
        s.host_step += 1
        metrics.append(m)
    if states[0].host_step % cfg.sync_every == 0:
        outer_sync(states, cfg, _emulated_psum, len(states),
                   reset_opt_on_sync)
    loss = _emulated_psum([m["loss"] for m in metrics]) / len(states)
    return metrics, loss
