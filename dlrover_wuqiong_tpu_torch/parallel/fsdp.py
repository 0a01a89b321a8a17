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

Under pipeline parallel (``pp`` > 1) the model is a
`parallel.pipeline.PipelinedLM` stage: FSDP2 shards its blocks over the
data dims of its own ``pp`` coordinate, `materialize` keeps the stage's
leaves of the full init, and `MeshState` sums the gradient of every
leaf outside the stage's blocks (each stage computed only its part)
over ``pp`` before the data dims' mean, and counts a stage's blocks
once in the norm (``pp`` shards them).  The checkpoint of such a
state is not ported (`MeshState.piece` raises).

A quantized state (adamw8bit's codes ``.../0``, (rows, 256) int8, and
scales ``.../1``, (rows,) float32, of a parameter's piece,
optimizers/low_bit.py) is laid out in one of two ways, chosen for each
parameter from all its pieces (`quantized_piece`):

- Layout A, when every piece is a run of the leaf's row-major
  flattening that starts on a 256-element boundary and is a multiple of
  256 long (or ends the leaf): a ``Shard(0)`` piece of a leaf whose rows
  are 256-aligned.  Such a piece quantizes into exactly the leaf's own
  blocks, so its codes and scales are rows ``[start / 256, ...)`` of
  the leaf's codes ``(ceil(N / 256), 256)`` and scales: JAX's whole-leaf
  `QTensor` children, written as ``#shardN`` pieces.  A JAX adamw8bit
  checkpoint assembles onto such pieces bitwise, and the reverse.
- Layout B, for every other parameter (a ``Shard(1)`` piece, pieces that
  are not aligned, an uneven tail): each piece keeps blocks of its own.
  The codes are written as an int8 leaf of the parameter's shape, each
  element's code at the element's place (a block's zero padding is
  dropped: it always codes 0), sharded as the parameter.  The scales
  leaf is ``(pieces, 2 * ndim + rows_max)`` float32: row N is piece N's
  index (start and stop per dim, exact in float32 up to 2^24) and then
  its block scales, padded with 1.  JAX has no such leaf; only the port
  reads it.

A restore takes the rows of a layout-A checkpoint, or the codes and
scales of a layout-B piece with this piece's index, as they are
(bitwise).  Any other restore (another mesh, the other layout)
dequantizes the checkpoint into the leaf's float32 moment and quantizes
this piece's region of it in this piece's blocks: each value then moves
by at most 1/127 of its new block's absmax (tests/test_torch_dcp.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

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
                 planner: ShardingPlanner, replicated: List[str],
                 replica_dim: Optional[str] = None):
        self.model = model
        self.mesh = mesh
        self.planner = planner
        # names, not objects: materializing replaces the parameters
        self.replicated = replicated
        sizes = plan.sizes()
        self.n_sp = sizes["sp"]
        self.coord = dict(zip(AXIS_ORDER, mesh.get_coordinate()))
        # local SGD: the mesh dim whose ranks hold replicas that train
        # apart (parallel/local_sgd.py); the step reduces nothing over it
        self.replica_dim = replica_dim
        self.replicas = sizes[replica_dim] if replica_dim else 1
        self.replica = self.coord[replica_dim] if replica_dim else 0
        data = [a for a in ("dp", "fsdp") if a != replica_dim]
        # the ranks that hold other tokens: the data dims and sp
        self.n_tokens = self.n_sp
        for a in data:
            self.n_tokens *= sizes[a]
        self.data_groups = [mesh.get_group(a) for a in data if sizes[a] > 1]
        self.sp_groups = [mesh.get_group("sp")] if sizes["sp"] > 1 else []
        # the ranks whose pieces make up one state: the world, or one
        # replica's (a local SGD mesh is dp x fsdp)
        self.norm_groups = None if replica_dim is None else \
            self.data_groups
        # pipeline parallel: a stage's blocks are its own, every other
        # leaf is held by each stage, which computes only its part of
        # that leaf's gradient (parallel/pipeline.py)
        self.n_pp = sizes["pp"]
        self.pp_group = mesh.get_group("pp") if self.n_pp > 1 else None
        self.stage_local = set(model.block_names()) if self.n_pp > 1 \
            else set()

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

    def _sum_over_pp(self, tensors) -> None:
        """Sum `tensors` in place over the ``pp`` group, in float32 as
        `_mean_over` reduces them."""
        for t in tensors:
            acc = t if t.dtype == torch.float32 else t.float()
            dist.all_reduce(acc, group=self.pp_group)
            if acc is not t:
                t.copy_(acc)

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """Average the gradients over the token ranks that FSDP2 did not
        reduce: a replicated parameter's over dp x fsdp x sp, every other
        over sp.  A tensor-parallel gradient is first laid out as its
        parameter (a Partial or Shard gradient of a replicated parameter
        is reduced or gathered over ``tp``).  Under pipeline parallel the
        gradient of every leaf outside the stage's blocks is first summed
        over ``pp`` (a stage that did not use it adds zeros)."""
        params = dict(self.model.named_parameters())
        replicated, sharded, over_pp = [], [], []
        for name, p in params.items():
            if self.pp_group is not None and name not in self.stage_local \
                    and p.grad is None:
                p.grad = torch.zeros_like(p)
            g = p.grad
            if g is None:
                continue
            if name in self.replicated and is_dtensor(g) and \
                    tuple(g.placements) != tuple(p.placements):
                g = p.grad = g.redistribute(p.device_mesh, p.placements)
            local = g.to_local() if is_dtensor(g) else g
            (replicated if name in self.replicated else sharded).append(
                local)
            if self.pp_group is not None and name not in self.stage_local:
                over_pp.append(local)
        if self.pp_group is not None:
            self._sum_over_pp(over_pp)
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

    def _owner(self, t, stage_local: bool = False) -> bool:
        """Does this rank count `t`'s piece: coordinate 0 on every mesh
        dim that does not shard it (``pp`` shards a stage's blocks)?"""
        sharded = {self.replica_dim}
        if stage_local:
            sharded.add("pp")
        if is_dtensor(t):
            names = t.device_mesh.mesh_dim_names
            sharded |= {names[i] for i, p in enumerate(t.placements)
                        if p.is_shard()}
        return all(c == 0 for a, c in self.coord.items() if a not in sharded)

    @torch.no_grad()
    def global_norm(self, grads=None) -> torch.Tensor:
        """optax's ``global_norm`` over the model's sharded gradients:
        the float32 sums of squares of every distinct piece (a
        replicated one on one rank), summed over the world, then the
        root.  Each piece's owner is decided by its parameter's name (a
        pipeline stage's blocks are its own), so the gradients are read
        from the model; `grads`, a clip's argument, must be the same
        tensors and is only counted against them."""
        named = [(n, p.grad) for n, p in self.model.named_parameters()
                 if p.grad is not None]
        if grads is not None and len(list(grads)) != len(named):
            raise ValueError("MeshState.global_norm: the gradients given "
                             "are not the model's")
        if not named:
            return torch.zeros((), dtype=torch.float32)
        locals_ = [g.to_local() if is_dtensor(g) else g for _, g in named]
        norms = torch._foreach_norm(locals_, dtype=torch.float32)
        keep = [norm for (n, g), norm in zip(named, norms)
                if self._owner(g, n in self.stage_local)]
        dev = norms[0].device
        total = (torch.stack(keep).square().sum() if keep
                 else torch.zeros((), dtype=torch.float32, device=dev))
        if self.norm_groups is None:
            dist.all_reduce(total)
        for group in self.norm_groups or ():
            dist.all_reduce(total, group=group)
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
        """The checkpoint's view of the leaf `t` at `path` (no copy but a
        layout-B scales row): a `checkpoint.shm_handler.MeshPiece`.  A
        leaf whose path ends with a parameter's flax path and which has
        the shape of that parameter's piece (a moment, a compensation, a
        master) is laid out as that parameter; a quantized child of a
        parameter (``<param path>/0`` codes, ``/1`` scales) by
        `quantized_piece`, whose restore reads either layout; any other
        leaf (a count, the step) is replicated."""
        from ..checkpoint.shm_handler import MeshPiece

        if self.n_pp > 1:
            raise NotImplementedError(
                "the checkpoint of a pipelined state is not ported (ROADMAP "
                "queue 1 item 8c): a stage holds rows of the stacked "
                "blocks/... leaves (PipelinedLM.state_layout) that no "
                "piece of the flash format names yet")
        parts = path.split("/")
        param, child = None, None
        for k in range(len(parts)):
            param = params.get("/".join(parts[k:]))
            if param is not None:
                break
        if param is None and parts[-1] in ("0", "1"):
            for k in range(len(parts) - 1):
                param = params.get("/".join(parts[k:-1]))
                if param is not None:
                    child = int(parts[-1])
                    break
        local = t.to_local() if is_dtensor(t) else t
        if param is not None and not is_dtensor(t):
            p_local = param.to_local() if is_dtensor(param) else param
            shape, index, number, owner = self._layout(param)
            if tuple(local.shape) == tuple(p_local.shape):
                return MeshPiece(local, shape, index, number, owner)
            if child is not None and _is_quantized(child, local,
                                                   p_local.numel()):
                return quantized_piece(child, local, param,
                                       (shape, index, number, owner))
            if index != [[0, s] for s in shape]:
                raise NotImplementedError(
                    f"{path}: a state leaf of shape {tuple(local.shape)} "
                    f"beside the {tuple(p_local.shape)} piece of its "
                    "parameter is neither laid out as the parameter nor "
                    "an adamw8bit child (codes (rows, 256) int8, scales "
                    "(rows,) float32, 256 elements a row): no checkpoint "
                    "layout names its elements")
        return MeshPiece(local, *self._layout(t))


# ------------------------------------------------------- quantized state


def _is_quantized(child: int, local: torch.Tensor, n: int) -> bool:
    """Is `local` adamw8bit's codes (`child` 0) or scales (1) of an
    `n`-element piece?"""
    from ..optimizers.low_bit import BLOCK

    rows = -(-n // BLOCK)
    if child == 0:
        return local.dtype == torch.int8 and \
            tuple(local.shape) == (rows, BLOCK)
    return local.dtype == torch.float32 and tuple(local.shape) == (rows,)


def _numel(index) -> int:
    n = 1
    for a, b in index:
        n *= max(0, b - a)
    return n


def _aligned_rows(index, shape) -> Optional[int]:
    """The first row of the leaf's blocks where piece `index` of a
    `shape` leaf starts, if the piece is a run of the leaf's flattening
    on a block boundary, a whole number of blocks long or ending the
    leaf (layout A); else None.  An empty piece fits anywhere."""
    from ..optimizers.leaf import _aligned_run
    from ..optimizers.low_bit import BLOCK

    n = _numel(index)
    total = _numel([[0, s] for s in shape])
    if n == 0:
        return -(-total // BLOCK)
    if not _aligned_run(index, list(shape), BLOCK):
        return None
    cut = [d for d, (r, s) in enumerate(zip(index, shape)) if r != [0, s]]
    start = 0
    if cut:
        inner = _numel([[0, s] for s in shape[cut[0] + 1:]])
        start = index[cut[0]][0] * inner
    if n % BLOCK and start + n != total:
        return None
    return start // BLOCK


def _pieces(param, layout) -> List:
    """[(number, index)] of every distinct piece of `param` (one, whole,
    for a plain tensor)."""
    from .sharding import dtensor_pieces

    if is_dtensor(param):
        return dtensor_pieces(param)
    return [(layout[2], layout[1])]


def quantized_piece(child: int, local: torch.Tensor, param, layout):
    """The `MeshPiece` of adamw8bit's codes (`child` 0) or scales (1) of
    a parameter's piece, in layout A or B (module docstring; a whole
    piece is A);
    `layout` is the parameter piece's (global shape, index, number,
    owner).  Its restore hook reads both children of the checkpoint."""
    from ..checkpoint.shm_handler import MeshPiece
    from ..optimizers.low_bit import BLOCK

    shape, index, number, owner = layout
    pieces = _pieces(param, layout)
    firsts = {num: _aligned_rows(idx, shape) for num, idx in pieces}
    n, total = _numel(index), _numel([[0, s] for s in shape])
    rows = -(-n // BLOCK)
    hook = _QuantRestore(child, shape, index, n, local)
    if all(r is not None for r in firsts.values()):
        r0 = firsts[number]
        g_rows = -(-total // BLOCK)
        if child == 0:
            return MeshPiece(local, [g_rows, BLOCK],
                             [[r0, r0 + rows], [0, BLOCK]], number, owner,
                             hook)
        return MeshPiece(local, [g_rows], [[r0, r0 + rows]], number, owner,
                         hook)
    if child == 0:
        codes = local.reshape(-1)[:n].view([b - a for a, b in index])
        return MeshPiece(codes, shape, index, number, owner, hook)
    head = 2 * len(shape)
    width = head + max(-(-_numel(idx) // BLOCK) for _, idx in pieces)
    row = torch.ones((1, width), dtype=torch.float32, device=local.device)
    row[0, :head] = torch.tensor([x for ab in index for x in ab],
                                 dtype=torch.float32)
    row[0, head:head + rows] = local
    return MeshPiece(row, [len(pieces), width],
                     [[number, number + 1], [0, width]], number, owner, hook)


class _QuantRestore:
    """A quantized piece's restore hook: (`target`, its value), the
    piece's codes (`child` 0) or scales (1) from the checkpoint's
    ``<base>/0`` and ``<base>/1``, whatever layout wrote them (module
    docstring)."""

    def __init__(self, child: int, shape, index, n: int,
                 target: torch.Tensor):
        self.child, self.shape, self.index, self.n = child, shape, index, n
        self.target = target

    def __call__(self, name: str, flat):
        return self.target, self._value(name, flat)

    def _value(self, name: str, flat) -> torch.Tensor:
        from ..checkpoint.engine import _host_tensor
        from ..optimizers.low_bit import (
            BLOCK,
            dequantize_rows,
            quantize_blockwise,
        )

        base = name.rsplit("/", 1)[0]
        for k in (f"{base}/0", f"{base}/1"):
            if k not in flat:
                raise KeyError(f"checkpoint missing tensor {k!r}")
        codes = _host_tensor(flat[f"{base}/0"])
        scales = _host_tensor(flat[f"{base}/1"])
        rows = -(-self.n // BLOCK)
        region = tuple(slice(a, b) for a, b in self.index)
        first = _aligned_rows(self.index, self.shape)
        if scales.dim() == 1:  # layout A: the leaf's own blocks
            if first is not None:
                got = (codes[first:first + rows], scales[first:first + rows])
                return got[self.child]
            total = _numel([[0, s] for s in self.shape])
            moment = dequantize_rows(codes, scales, total).reshape(
                self.shape)
        else:  # layout B: each piece's blocks, after its index
            head = 2 * len(self.shape)
            mine = torch.tensor([x for ab in self.index for x in ab],
                                dtype=torch.float32)
            moment = torch.zeros(self.shape, dtype=torch.float32)
            for row in scales:
                idx = row[:head].long().reshape(-1, 2).tolist()
                cut = tuple(slice(a, b) for a, b in idx)
                m = _numel(idx)
                q = torch.zeros((-(-m // BLOCK)) * BLOCK, dtype=torch.int8)
                q[:m] = codes[cut].reshape(-1)
                q = q.reshape(-1, BLOCK)
                s = row[head:head + q.shape[0]]
                if torch.equal(row[:head], mine):
                    return (q, s)[self.child]
                moment[cut] = dequantize_rows(q, s, m).reshape(
                    [b - a for a, b in idx])
        qt = quantize_blockwise(moment[region].contiguous())
        return (qt.q, qt.scale)[self.child]


def shard_model(model: nn.Module, mesh, plan: MeshPlan,
                planner: ShardingPlanner, tensor_parallel: bool = False,
                reshard_after_forward: bool = True,
                replica_dim: Optional[str] = None) -> MeshState:
    """Shard `model` (parameters on ``meta``) in place: tensor parallel
    over ``tp`` (with `tensor_parallel`, or any ``tp`` size above 1),
    then FSDP2 on each block and on the root over the data dims, or,
    with `replica_dim` (local SGD's ``dp``), over ``fsdp`` alone: each
    coordinate on `replica_dim` then holds a replica of its own."""
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

    data_mesh = mesh["dp", "fsdp"] if plan.dp > 1 and replica_dim is None \
        else mesh["fsdp"]
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
    return MeshState(model, mesh, plan, planner, replicated, replica_dim)


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
    float32 tensor) in init order), keeping each rank's piece.  A
    pipeline stage draws every leaf and keeps its own
    (``model.holds_elsewhere``)."""
    model.to_empty(device=device)
    named = dict(model.named_parameters())
    elsewhere = getattr(model, "holds_elsewhere", lambda name: False)
    for name, full in model.init_leaves(seed, device):
        if name not in named and elsewhere(name):
            continue  # another pipeline stage's block
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
