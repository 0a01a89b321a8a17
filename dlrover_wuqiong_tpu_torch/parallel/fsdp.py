"""A port model's parameters sharded over a mesh: FSDP2 over the data
dims, tensor parallel as DTensors over ``tp``.

Parity: the state layout that dlrover_wuqiong_tpu/auto/accelerate.py
(:676-711) gives a `TrainState` through `ShardingPlanner`'s specs, and
the sharded step of dlrover_wuqiong_tpu/trainer/train_step.py, where
GSPMD inserts the collectives.  Here:

- `shard_model` turns every parameter of a model built on ``meta`` into
  its rank's piece.  With tensor parallel, a parameter first becomes a
  DTensor over the mesh's ``tp`` dim with the spec's ``tp`` placement
  (Replicate where the spec has no ``tp``); the model then runs under
  global semantics and DTensor inserts the collectives
  (models/attention.py, models/gpt.py say where an op takes local
  tensors instead).  FSDP2's ``fully_shard`` then shards each block and
  the root over ``fsdp`` (with ``dp``, a 2-D mesh: ``dp`` replicates,
  ``fsdp`` shards), each parameter on the dim of its spec's ``fsdp``
  entry.  A parameter whose spec has no ``fsdp`` stays replicated over
  the data dims, outside FSDP2 (``ignored_params``), and its gradient is
  averaged over them by `MeshState.reduce_grads`.  With expert parallel
  (``ep`` > 1) an expert stack first becomes a DTensor over ``ep``
  (``Shard(0)``: E / ep experts a rank), which FSDP2 then also shards
  over ``fsdp``; every `models.moe.MoEMLP` gets the mesh (its ``mesh``).
- `materialize` allocates each rank's pieces and fills them one leaf at a
  time from the model's seeded flax-layout init (``init_leaves``), so a
  rank's shards are bitwise those of the unsharded build with the same
  seed and its peak is its own state plus one full leaf.
- `MeshState` is what the train step asks of the mesh: the global mean
  of the loss over the token ranks (dp x fsdp x sp), the gradients
  averaged over them (FSDP2 averages over dp x fsdp; `reduce_grads` the
  rest, over ``sp``, and never over ``ep``, whose ranks hold the same
  tokens and so each the whole gradient of every parameter but their
  own experts), optax's ``global_norm`` over the
  sharded gradients (each distinct piece counted once), and the
  checkpoint's view of a leaf as this rank's piece of the global leaf
  (`MeshState.piece`), which `checkpoint.shm_handler._leaf_refs` writes
  as JAX's ``name#shardN`` leaves.

Pure ``dp`` (``ddp``, or ``data_parallel`` without ``fsdp``) runs as the
2-D FSDP2 mesh with an ``fsdp`` size of 1: every piece is the whole
tensor and the gradients are all-reduced over ``dp``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.distributed as dist
from torch import nn

from ..common.log import get_logger
from .mesh import AXIS_ORDER, MeshPlan
from .sharding import ShardingPlanner, dtensor_layout, placements

logger = get_logger("fsdp")


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _set_param(model: nn.Module, name: str, value: nn.Parameter) -> None:
    *path, leaf = name.split(".")
    mod = model
    for k in path:
        mod = getattr(mod, k)
    setattr(mod, leaf, value)


def _units(model: nn.Module) -> List[nn.Module]:
    """FSDP2's units below the root, as the model declares them
    (``fsdp_units()``: GPT's ``h_<i>``, Llama's ``layers_<i>``).  A model
    without them would be gathered whole at every step, so it raises."""
    units = getattr(model, "fsdp_units", None)
    if units is None or not units():
        raise TypeError(f"{type(model).__name__} declares no fsdp_units(): "
                        "a sharded model names the modules that FSDP2 "
                        "gathers one at a time")
    return list(units())


class MeshState:
    """The mesh side of a sharded `trainer.train_step.TrainState`."""

    def __init__(self, model: nn.Module, mesh, plan: MeshPlan,
                 planner: ShardingPlanner, replicated: List[str]):
        self.model = model
        self.mesh = mesh
        self.planner = planner
        # names, not objects: materializing replaces the parameters
        self.replicated = replicated
        sizes = plan.sizes()
        self.n_sp = sizes["sp"]
        # the ranks that hold other tokens: the data dims and sp
        self.n_tokens = sizes["dp"] * sizes["fsdp"] * self.n_sp
        self.data_groups = [mesh.get_group(a) for a in ("dp", "fsdp")
                            if sizes[a] > 1]
        self.sp_groups = [mesh.get_group("sp")] if sizes["sp"] > 1 else []
        self.coord = dict(zip(AXIS_ORDER, mesh.get_coordinate()))

    # ---------------------------------------------------------------- step

    @staticmethod
    def _mean_over(tensors, groups, n: int) -> None:
        """Average `tensors` in place over the ranks of `groups` (n of
        them), one all-reduce a tensor and group (a bf16 gradient is
        summed in float32, as JAX sums the float32 cotangent before its
        cast to the parameter's dtype).  Not one flat buffer: with one,
        the clipped offload build and its on-device twin, which must
        agree bitwise, parted in the last bits under gloo
        (tests/test_torch_parallel_optimizers.py)."""
        if not tensors or n == 1:
            return
        for t in tensors:
            acc = t if t.dtype == torch.float32 else t.float()
            for group in groups:
                dist.all_reduce(acc, group=group)
            acc.div_(n)
            if acc is not t:
                t.copy_(acc)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Average the gradients over the token ranks that FSDP2 did not
        reduce: a replicated parameter's over dp x fsdp x sp, every other
        over sp.  A tensor-parallel gradient is first laid out as its
        parameter (a Partial or Shard gradient of a replicated parameter
        is reduced or gathered over ``tp``)."""
        params = dict(self.model.named_parameters())
        replicated, sharded = [], []
        for name, p in params.items():
            g = p.grad
            if g is None:
                continue
            if name in self.replicated and is_dtensor(g) and \
                    tuple(g.placements) != tuple(p.placements):
                g = p.grad = g.redistribute(p.device_mesh, p.placements)
            local = g.to_local() if is_dtensor(g) else g
            (replicated if name in self.replicated else sharded).append(
                local)
        self._mean_over(replicated, self.data_groups + self.sp_groups,
                        self.n_tokens)
        self._mean_over(sharded, self.sp_groups, self.n_sp)

    @torch.no_grad()
    def mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank scalar (the loss of the rank's tokens)
        over the token ranks: the global batch's mean for equal slices."""
        if self.n_tokens == 1:
            return loss
        out = loss.detach().float().clone()
        for group in self.data_groups + self.sp_groups:
            dist.all_reduce(out, group=group)
        return out.div_(self.n_tokens)

    def _owner(self, t) -> bool:
        """Does this rank count `t`'s piece: coordinate 0 on every mesh
        dim that does not shard it?"""
        sharded = set()
        if is_dtensor(t):
            names = t.device_mesh.mesh_dim_names
            sharded = {names[i] for i, p in enumerate(t.placements)
                       if p.is_shard()}
        return all(c == 0 for a, c in self.coord.items() if a not in sharded)

    @torch.no_grad()
    def global_norm(self, grads) -> torch.Tensor:
        """optax's ``global_norm`` over sharded gradients: the float32
        sums of squares of every distinct piece (a replicated one on one
        rank), summed over the world, then the root."""
        grads = list(grads)
        if not grads:
            return torch.zeros((), dtype=torch.float32)
        locals_ = [g.to_local() if is_dtensor(g) else g for g in grads]
        norms = torch._foreach_norm(locals_, dtype=torch.float32)
        keep = [n for g, n in zip(grads, norms) if self._owner(g)]
        dev = norms[0].device
        total = (torch.stack(keep).square().sum() if keep
                 else torch.zeros((), dtype=torch.float32, device=dev))
        dist.all_reduce(total)
        return total.sqrt()

    # ---------------------------------------------------------- checkpoint

    def _layout(self, t):
        """(global shape, index, number, owner) of this rank's piece of
        `t`, a DTensor over its own mesh or a tensor replicated on
        every rank."""
        if is_dtensor(t):
            index, number, _ = dtensor_layout(t)
            return list(t.shape), index, number, self._owner(t)
        return (list(t.shape), [[0, s] for s in t.shape], 0,
                self._owner(t))

    def piece(self, path: str, t, params: Dict[str, Any]):
        """The checkpoint's view of the leaf `t` at `path` (no copy): a
        `checkpoint.shm_handler.MeshPiece`.  A leaf whose path ends with
        a parameter's flax path and which has the shape of that
        parameter's piece (a moment, a compensation, a master) is laid
        out as that parameter; any other leaf (a count, the step) is
        replicated."""
        from ..checkpoint.shm_handler import MeshPiece

        parts = path.split("/")
        param = None
        for k in range(len(parts)):
            param = params.get("/".join(parts[k:]))
            if param is not None:
                break
        local = t.to_local() if is_dtensor(t) else t
        if param is not None and not is_dtensor(t):
            p_local = param.to_local() if is_dtensor(param) else param
            shape, index, number, owner = self._layout(param)
            if tuple(local.shape) == tuple(p_local.shape):
                return MeshPiece(local, shape, index, number, owner)
            if index != [[0, s] for s in shape]:
                raise NotImplementedError(
                    f"{path}: a state leaf of shape {tuple(local.shape)} "
                    f"beside the {tuple(p_local.shape)} piece of its "
                    "parameter (a quantized state) has no sharded "
                    "checkpoint layout yet")
        return MeshPiece(local, *self._layout(t))


def shard_model(model: nn.Module, mesh, plan: MeshPlan,
                planner: ShardingPlanner, tensor_parallel: bool = False,
                reshard_after_forward: bool = True) -> MeshState:
    """Shard `model` (parameters on ``meta``) in place: tensor parallel
    over ``tp`` (with `tensor_parallel`, or any ``tp`` size above 1),
    then FSDP2 on each block and on the root over the data dims."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = planner.param_specs(model)
    tp = tensor_parallel or plan.tp > 1
    if plan.ep > 1 and tp:
        raise NotImplementedError(
            "expert_parallel with tensor_parallel is not ported: the expert "
            "stacks would be DTensors over (ep, tp)")
    if tp:
        for name, p in list(model.named_parameters()):
            _as_dtensor(model, name, p, mesh["tp"], specs[name])
    elif plan.ep > 1:
        for name, p in list(model.named_parameters()):
            if "ep" in _spec_axes(specs[name]):
                _as_dtensor(model, name, p, mesh["ep"], specs[name])
    by_id = {id(p): n for n, p in model.named_parameters()}
    replicated = [n for n in specs if "fsdp" not in _spec_axes(specs[n])]
    named = dict(model.named_parameters())
    ignored = {named[n] for n in replicated}

    def placement(p):
        spec = specs[by_id[id(p)]]
        for d, part in enumerate(spec):
            if part == "fsdp" or (isinstance(part, tuple)
                                  and "fsdp" in part):
                return Shard(d)
        raise AssertionError(f"{by_id[id(p)]}: no fsdp dim in {spec}")

    data_mesh = mesh["dp", "fsdp"] if plan.dp > 1 else mesh["fsdp"]
    for unit in _units(model):
        if any(p not in ignored for p in unit.parameters()):
            fully_shard(unit, mesh=data_mesh,
                        reshard_after_forward=reshard_after_forward,
                        shard_placement_fn=placement,
                        ignored_params=ignored)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=placement,
                ignored_params=ignored)
    logger.info("sharded %d parameters over %s (%d replicated%s)",
                len(specs), plan.describe(), len(replicated),
                ", tensor parallel" if tp else "")
    return MeshState(model, mesh, plan, planner, replicated)


def _spec_axes(spec) -> List[str]:
    return [a for part in spec if part is not None
            for a in (part if isinstance(part, tuple) else (part,))]


def _as_dtensor(model: nn.Module, name: str, p, sub_mesh, spec) -> None:
    """Make parameter `name` (on meta) a DTensor over the one-dim
    `sub_mesh` with the spec's placement there: the piece by hand, no
    collective."""
    from torch.distributed.tensor import DTensor

    pl = placements(spec, sub_mesh)
    local = p.data
    if pl[0].is_shard():
        n, c = sub_mesh.size(), sub_mesh.get_local_rank()
        local = local.chunk(n, dim=pl[0].dim)[c].contiguous()
    dt = DTensor.from_local(local, sub_mesh, pl, run_check=False,
                            shape=p.shape, stride=p.stride())
    _set_param(model, name, nn.Parameter(dt, requires_grad=p.requires_grad))


def local_piece(p, full: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the global tensor `full` for parameter `p`."""
    if not is_dtensor(p):
        return full
    index, _, _ = dtensor_layout(p)
    return full[tuple(slice(a, b) for a, b in index)]


@torch.no_grad()
def materialize(model: nn.Module, seed: int, device) -> None:
    """Allocate the sharded parameters on `device` and fill them from the
    seeded init one leaf at a time (``model.init_leaves``: (name, full
    float32 tensor) in init order), keeping each rank's piece."""
    model.to_empty(device=device)
    named = dict(model.named_parameters())
    for name, full in model.init_leaves(seed, device):
        p = named.pop(name)
        dst = p.to_local() if is_dtensor(p) else p
        dst.copy_(local_piece(p, full))
        del full
    if named:
        raise ValueError(f"init gave no value for {sorted(named)}")


def state_bytes(tensors) -> int:
    """Bytes this rank holds of `tensors` (a DTensor's local piece)."""
    total = 0
    for t in tensors:
        loc = t.to_local() if is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total
