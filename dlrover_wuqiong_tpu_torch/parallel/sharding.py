"""Sharding specs for transformer parameters and batches, as DTensor
placements.

Parity: dlrover_wuqiong_tpu/parallel/sharding.py — `TRANSFORMER_RULES`
(:37), `MOE_RULES` (:69), `spec_for_path` (:94), `_fit_spec` (:105),
`_add_fsdp` (:117), `ShardingPlanner` (:146) and `constrain` (:206), with
the same regexes and rules.

A spec is JAX's ``PartitionSpec`` spelled as a tuple: one entry a
tensor dim, each an axis name of `parallel.mesh.AXIS_ORDER`, a tuple of
them, or None.  The port keeps dense kernels in flax's ``(in, out)``
layout under flax's names, so a spec maps onto DTensor placements dim
for dim (`placements`): mesh dim ``a`` at position ``d`` of the spec is
``Shard(d)``, every other mesh dim ``Replicate()``.  A rank's slice of
a tensor is then the slice the same JAX spec gives the device at the
same mesh position, and a checkpoint's ``name#shardN`` leaf has the same
global index in both packages.

Paths are the flax paths, "/"-joined: a port parameter's dotted name
with "." read as "/" (``h_0/attn/c_attn/kernel``).  A mesh argument is a
DeviceMesh with dims named `AXIS_ORDER`, or anything that gives the
dims' sizes (a `MeshPlan`, a ``{axis: size}`` dict), which is all the
specs need.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.log import get_logger
from .mesh import MeshPlan

logger = get_logger("sharding")

Spec = Tuple[Any, ...]
Rule = Tuple[str, Spec]  # (path regex, spec)


# Default rules for transformer LMs (flax param-tree paths).  Order matters:
# first match wins.  Conventions: embedding tables (vocab, embed);
# attention/MLP kernels (in_features, out_features).
TRANSFORMER_RULES: List[Rule] = [
    # embeddings: vocab-parallel over tp
    (r".*(wte|embed_tokens|token_embed|embedding)/embedding$",
     ("tp", "fsdp")),
    (r".*(wpe|pos_embed)/embedding$", (None, "fsdp")),
    # attention qkv: column-parallel (heads split over tp)
    (r".*(attn|attention).*(q_proj|k_proj|v_proj|qkv|c_attn|query|key|value)"
     r"/kernel$", ("fsdp", "tp")),
    # attention out: row-parallel
    (r".*(attn|attention).*(o_proj|out_proj|c_proj|dense|out)/kernel$",
     ("tp", "fsdp")),
    # MLP up/gate: column-parallel
    (r".*(mlp|ffn|feed_forward).*(up_proj|gate_proj|c_fc|fc1|w1|w3)/kernel$",
     ("fsdp", "tp")),
    # MLP down: row-parallel
    (r".*(mlp|ffn|feed_forward).*(down_proj|c_proj|fc2|w2)/kernel$",
     ("tp", "fsdp")),
    # lm head: vocab-parallel
    (r".*(lm_head|output_proj)/kernel$", ("fsdp", "tp")),
    # biases follow their kernel's output dim
    (r".*(q_proj|k_proj|v_proj|qkv|c_attn|up_proj|gate_proj|c_fc|fc1|w1|w3)"
     r"/bias$", ("tp",)),
    # norms, scalars: replicated
    (r".*(ln|norm|layernorm|rmsnorm).*", ()),
    (r".*/bias$", ()),
    (r".*scale$", ()),
]

MOE_RULES: List[Rule] = [
    # expert weights: (num_experts, in, out) — experts over ep
    (r".*experts.*(w_in|w_gate|w1|w3|up|gate).*", ("ep", "fsdp", "tp")),
    (r".*experts.*(w_down|w2|down).*", ("ep", "tp", "fsdp")),
    (r".*(router|gate)/kernel$", ("fsdp", None)),
]


def path_of(name: str) -> str:
    """A parameter's dotted name (``h_0.attn.c_attn.kernel``) as its flax
    path (``h_0/attn/c_attn/kernel``)."""
    return name.replace(".", "/")


def spec_for_path(path: str, rules: Sequence[Rule],
                  ndim: Optional[int] = None) -> Spec:
    for pattern, spec in rules:
        if re.match(pattern, path, re.IGNORECASE):
            if ndim is not None:
                spec = _fit_spec(spec, ndim)
            return tuple(spec)
    return ()  # default: replicated (fsdp handled by _add_fsdp)


def _fit_spec(spec: Spec, ndim: int) -> Spec:
    """Trim/pad a spec to the array's rank."""
    parts = list(spec)
    if len(parts) > ndim:
        parts = [p for p in parts if p is not None][:ndim]
        parts += [None] * (ndim - len(parts))
    elif len(parts) < ndim:
        parts += [None] * (ndim - len(parts))
    return tuple(parts)


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, a `MeshPlan` or a dict of sizes."""
    if isinstance(mesh, MeshPlan):
        return mesh.sizes()
    if isinstance(mesh, dict):
        return dict(mesh)
    names = mesh.mesh_dim_names
    return {n: mesh.size(i) for i, n in enumerate(names)}


def _add_fsdp(spec: Spec, shape: Tuple[int, ...], mesh,
              min_size: int = 2 ** 16) -> Spec:
    """ZeRO-3: also shard large replicated-dim params along "fsdp".

    Picks the largest dim not already sharded and divisible by the fsdp
    size."""
    fsdp_size = mesh_sizes(mesh).get("fsdp", 1)
    if fsdp_size <= 1:
        return spec
    if "fsdp" in [a for part in spec for a in _axes(part)]:
        return spec
    if math.prod(shape) < min_size:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    # choose largest unsharded, divisible dim
    best, best_size = -1, 0
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % fsdp_size == 0 and dim > best_size:
            best, best_size = i, dim
    if best < 0:
        return spec
    parts[best] = "fsdp"
    return tuple(parts)


def placements(spec: Spec, mesh, names: Sequence[str] = None) -> list:
    """DTensor placements of `spec` over `mesh`'s dims (or `names`):
    ``Shard(d)`` on the mesh dim each axis at spec position ``d`` names,
    ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(names or mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        for a in _axes(part):
            if a in names:
                out[names.index(a)] = Shard(d)
    return out


def _chunk(lo: int, hi: int, n: int, i: int) -> Tuple[int, int]:
    """The `i`-th of `n` chunks of [lo, hi), as torch.chunk and DTensor
    split it (ceil-sized chunks, the last ones short or empty)."""
    size = -(-(hi - lo) // n)
    return min(lo + i * size, hi), min(lo + (i + 1) * size, hi)


def spec_index(shape: Sequence[int], spec: Spec, sizes: Dict[str, int],
               coord: Dict[str, int]) -> List[List[int]]:
    """[start, stop) per dim of the slice that the device at mesh
    coordinates `coord` holds of a `shape` tensor under `spec` (axes of
    one spec entry major to minor, as JAX orders them)."""
    index = [[0, s] for s in shape]
    for d, part in enumerate(_fit_spec(spec, len(shape))):
        for a in _axes(part):
            lo, hi = index[d]
            index[d] = list(_chunk(lo, hi, sizes.get(a, 1), coord.get(a, 0)))
    return index


def dtensor_layout(t, coord: Sequence[int] = None
                   ) -> Tuple[List[List[int]], int, bool]:
    """(index, shard number, owner) of this rank's local piece of DTensor
    `t` (or of the piece at mesh coordinates `coord`): the [start, stop)
    per dim within the global tensor; the piece's number among the
    distinct pieces, counted row-major over the mesh dims that shard it
    (the order in which JAX's device-ordered shards first show each
    piece); and whether this rank writes it (coordinate 0 on every mesh
    dim that replicates it)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate() if coord is None else list(coord)
    index = [[0, s] for s in t.shape]
    number, owner = 0, True
    for i, p in enumerate(t.placements):
        n = mesh.size(i)
        if p.is_shard():
            lo, hi = index[p.dim]
            index[p.dim] = list(_chunk(lo, hi, n, coord[i]))
            number = number * n + coord[i]
        elif coord[i] != 0:
            owner = False
    return index, number, owner


def dtensor_pieces(t) -> List[Tuple[int, List[List[int]]]]:
    """Every distinct piece of DTensor `t` over its mesh, as (shard
    number, index), in number order."""
    import itertools

    mesh = t.device_mesh
    out = {}
    for coord in itertools.product(*(range(n) for n in mesh.shape)):
        index, number, owner = dtensor_layout(t, coord)
        if owner:
            out[number] = index
    return sorted(out.items())


@dataclass
class ShardingPlanner:
    """Maps named parameters to specs and placements over a mesh."""

    mesh: Any
    rules: List[Rule] = field(default_factory=lambda:
                              list(TRANSFORMER_RULES))
    fsdp_min_size: int = 2 ** 16

    def with_moe(self) -> "ShardingPlanner":
        self.rules = list(MOE_RULES) + self.rules
        return self

    @staticmethod
    def _shapes(params) -> Dict[str, Tuple[int, ...]]:
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        return {n: tuple(getattr(v, "shape", v)) for n, v in params.items()}

    def spec(self, name: str, shape: Sequence[int]) -> Spec:
        spec = spec_for_path(path_of(name), self.rules, ndim=len(shape))
        return _add_fsdp(spec, tuple(shape), self.mesh, self.fsdp_min_size)

    def param_specs(self, params) -> Dict[str, Spec]:
        """{name: spec} for a module's parameters, or for a {name: tensor
        or shape} map."""
        return {n: self.spec(n, s) for n, s in self._shapes(params).items()}

    def param_placements(self, params) -> Dict[str, list]:
        return {n: placements(s, self.mesh)
                for n, s in self.param_specs(params).items()}

    def shard_params(self, params: Dict[str, Any],
                     coord: Optional[Dict[str, int]] = None
                     ) -> Dict[str, Any]:
        """This rank's slice (or the slice of the mesh position `coord`)
        of each global tensor or numpy array in `params`."""
        coord = coord if coord is not None else self.coordinate()
        sizes = mesh_sizes(self.mesh)
        out = {}
        for name, value in params.items():
            idx = spec_index(value.shape, self.spec(name, value.shape),
                             sizes, coord)
            out[name] = value[tuple(slice(a, b) for a, b in idx)]
        return out

    def coordinate(self) -> Dict[str, int]:
        """{axis: this rank's coordinate} on the mesh."""
        coord = self.mesh.get_coordinate()
        return dict(zip(self.mesh.mesh_dim_names, coord))

    # ------------------------------------------------------------ batches

    def batch_spec(self, ndim: int = 2, seq_axis: Optional[int] = None,
                   batch_axis: int = 0) -> Spec:
        """Batch activations: batch dim over (dp, fsdp), the sequence dim
        `seq_axis` (if given) over sp."""
        parts: List[Any] = [None] * ndim
        parts[batch_axis] = ("dp", "fsdp")
        if seq_axis is not None and mesh_sizes(self.mesh).get("sp", 1) > 1:
            parts[seq_axis] = "sp"
        return tuple(parts)

    def place_batch(self, batch: Dict[str, Any], batch_axis: int = 0,
                    seq_axis: Optional[int] = None,
                    microbatches: int = 1) -> Dict[str, Any]:
        """This rank's slice of every leaf of a global batch (numpy
        arrays or tensors) along `batch_axis`, and along `seq_axis` over
        sp for a leaf that has that axis; leaves without the batch axis
        pass whole.  With `microbatches` M > 1 (a pipeline's) the rank
        takes its slice of each of the M row blocks, in order: its
        microbatch m is its piece of the global microbatch m, as JAX
        shards each pipeline microbatch over the data dims."""
        sizes, coord = mesh_sizes(self.mesh), self.coordinate()
        out = {}
        for k, x in batch.items():
            if np.ndim(x) <= batch_axis:
                out[k] = x
                continue
            seq = seq_axis if seq_axis is not None and \
                np.ndim(x) > seq_axis else None
            shape = tuple(x.shape)
            if microbatches > 1:
                b = shape[batch_axis]
                if b % microbatches:
                    raise ValueError(f"batch {b} not divisible by "
                                     f"microbatches {microbatches}")
                x = x.reshape(shape[:batch_axis] + (
                    microbatches, b // microbatches) + shape[batch_axis + 1:])
            shift = 1 if microbatches > 1 else 0
            idx = spec_index(x.shape, self.batch_spec(
                np.ndim(x), None if seq is None else seq + shift,
                batch_axis + shift), sizes, coord)
            piece = x[tuple(slice(a, b) for a, b in idx)]
            if microbatches > 1:
                ps = tuple(piece.shape)
                piece = piece.reshape(ps[:batch_axis] + (-1,)
                                      + ps[batch_axis + 2:])
            out[k] = piece
        return out


#: the dims that shard the tokens: the batch over (dp, fsdp), the
#: sequence over sp
TOKEN_AXES = ("dp", "fsdp", "sp")


def tokens_sharded(mesh) -> bool:
    """Does `mesh` (or None) split the tokens over more than one rank?"""
    if mesh is None:
        return False
    sizes = mesh_sizes(mesh)
    return any(sizes.get(a, 1) > 1 for a in TOKEN_AXES)


@torch.no_grad()
def gather_tokens(x: torch.Tensor, mesh) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Every token rank's `x` (B_l, T_l, ...), this rank's block of the
    global (B, T) tokens, assembled in the global order: returns (the
    (B * T, ...) tensor with token b * T + t at row b * T + t, this rank's
    rows of it).  Ranks of one block (ep, tp) hold the same tokens; every
    block must have the same shape (the batch divides the data dims).
    No gradient."""
    import torch.distributed as dist

    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    b, t = x.shape[:2]
    out = x.contiguous()
    for a in ("sp", "fsdp", "dp"):  # inner to outer: leading dims dp, fsdp, sp
        n = sizes.get(a, 1)
        if n > 1:
            buf = torch.empty((n * out.shape[0], *out.shape[1:]),
                              dtype=out.dtype, device=out.device)
            dist.all_gather_into_tensor(buf, out, group=mesh.get_group(a))
            out = buf.view(n, *out.shape)
        else:
            out = out[None]
    n_data, sp = sizes.get("dp", 1) * sizes.get("fsdp", 1), sizes.get("sp", 1)
    rest = x.shape[2:]
    out = out.reshape(n_data, sp, b, t, *rest).transpose(1, 2)
    out = out.reshape(n_data * b * sp * t, *rest)
    block = coord.get("dp", 0) * sizes.get("fsdp", 1) + coord.get("fsdp", 0)
    rows_b = block * b + torch.arange(b, device=x.device)
    rows_t = coord.get("sp", 0) * t + torch.arange(t, device=x.device)
    rows = (rows_b[:, None] * (sp * t) + rows_t[None, :]).reshape(-1)
    return out, rows


def redistribute(x, mesh, spec: Spec):
    """`x` (a DTensor) laid out as `spec` over `mesh` (the collectives it
    takes to get there) — JAX's ``constrain``."""
    return x.redistribute(mesh, placements(spec, mesh))
