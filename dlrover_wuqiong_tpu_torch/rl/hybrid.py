"""Hybrid RLHF engine: separate train and decode meshes with weight sync.

Parity: dlrover_wuqiong_tpu/rl/hybrid.py — `HybridEngine` (:39) with
`place_train` (:58), `sync_to_decode` (:61, timed in `last_sync_s`),
`place_prompts` (:83) and `place_batch_train` (:88).  Both meshes are
DeviceMeshes over the ranks of the default process group:

- train mesh: fsdp over the ranks (or any `MeshPlan`), each leaf placed
  by `parallel.sharding.ShardingPlanner`'s spec on it;
- decode mesh: tp x dp, parameters sharded over tp only and the prompts
  over dp.

A leaf is a DTensor over its mesh (this rank's piece).  Two DeviceMeshes
cannot ``redistribute`` into each other, and JAX's ``device_put``
between the placements is XLA's own route, so the sync is a piece-wise
copy: each rank's decode piece is assembled from the overlaps of the
train pieces with it, each overlap sent by one rank that holds it
(the receiver itself when it does, else the lowest rank), all of a
sync's sends and receives in one ``batch_isend_irecv``.  No rank
gathers a whole leaf: each receives its decode piece less what it holds
already (`last_sync_bytes` counts the bytes received over the world).
"""

from __future__ import annotations

import time
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..convert import _flatten
from ..parallel.mesh import AXIS_ORDER, MeshPlan, build_mesh
from ..parallel.sharding import (
    ShardingPlanner,
    mesh_sizes,
    placements,
    spec_index,
)
from ..trainer.train_step import nest

Index = List[List[int]]


def _coord(sizes: Dict[str, int], rank: int) -> Dict[str, int]:
    """The mesh coordinates of `rank` (ranks row-major over AXIS_ORDER,
    as `parallel.mesh.build_mesh` lays them out)."""
    pos = np.unravel_index(rank, [sizes[a] for a in AXIS_ORDER])
    return {a: int(c) for a, c in zip(AXIS_ORDER, pos)}


def _overlap(a: Index, b: Index) -> Optional[Index]:
    out = [[max(x[0], y[0]), min(x[1], y[1])] for x, y in zip(a, b)]
    return out if all(lo < hi for lo, hi in out) else None


def _within(region: Index, piece: Index) -> Tuple[slice, ...]:
    return tuple(slice(lo - p[0], hi - p[0])
                 for (lo, hi), p in zip(region, piece))


class HybridEngine:
    """Two placements of the actor over one set of ranks + timed sync."""

    def __init__(self, devices=None, train_plan: Optional[MeshPlan] = None,
                 decode_tp: int = 1, device=None):
        n = dist.get_world_size()
        if devices is not None and len(list(devices)) != n:
            raise ValueError(f"{len(list(devices))} devices given in a "
                             f"torch.distributed world of {n}: each rank "
                             "holds one device")
        if decode_tp < 1 or n % decode_tp:
            raise ValueError(f"decode_tp={decode_tp} must be >= 1 and "
                             f"divide the {n} devices")
        self.device = resolve_device(device)
        self.train_mesh = build_mesh(train_plan or MeshPlan(fsdp=n),
                                     self.device.type)
        self.train_planner = ShardingPlanner(self.train_mesh)
        self.decode_mesh = build_mesh(
            MeshPlan(tp=decode_tp, dp=n // decode_tp), self.device.type)
        self.decode_planner = ShardingPlanner(self.decode_mesh)
        self.rank, self.world = dist.get_rank(), n
        self.last_sync_s = 0.0
        self.last_sync_bytes = 0

    # ------------------------------------------------------------ placing

    def _place(self, planner, name: str, value: torch.Tensor, spec=None):
        from torch.distributed.tensor import DTensor

        value = torch.as_tensor(value)
        spec = planner.spec(name, value.shape) if spec is None else spec
        idx = spec_index(value.shape, spec, mesh_sizes(planner.mesh),
                         planner.coordinate())
        local = value[tuple(slice(a, b) for a, b in idx)].to(
            self.device).contiguous()
        return DTensor.from_local(local, planner.mesh,
                                  placements(spec, planner.mesh),
                                  run_check=False, shape=value.shape,
                                  stride=value.contiguous().stride())

    def place_train(self, params: Mapping) -> Dict[str, Any]:
        """A flax-layout tree of global tensors (or numpy arrays) as
        DTensors over the train mesh: each rank keeps its piece."""
        return nest({n: self._place(self.train_planner, n, v)
                      for n, v in _flatten(params).items()})

    def sync_to_decode(self, actor_params: Mapping) -> Dict[str, Any]:
        """Reshard trained actor weights (`place_train`'s DTensors) onto
        the decode placement, piece by piece (module docstring); the
        wall time to the last piece's arrival is `last_sync_s`."""
        from torch.distributed.tensor import DTensor

        flat = _flatten(actor_params)
        t_sizes = mesh_sizes(self.train_mesh)
        d_sizes = mesh_sizes(self.decode_mesh)
        t_coords = [_coord(t_sizes, r) for r in range(self.world)]
        d_coords = [_coord(d_sizes, r) for r in range(self.world)]
        me = self.rank
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        ops, copies, outs, received = [], [], {}, 0
        for name, dt in flat.items():
            shape = list(dt.shape)
            t_spec = self.train_planner.spec(name, shape)
            d_spec = self.decode_planner.spec(name, shape)
            t_idx = [spec_index(shape, t_spec, t_sizes, c) for c in t_coords]
            d_idx = [spec_index(shape, d_spec, d_sizes, c) for c in d_coords]
            local = dt.to_local()
            out = torch.empty([b - a for a, b in d_idx[me]],
                              dtype=local.dtype, device=local.device)
            outs[name] = (out, d_spec)
            holders: Dict[tuple, List[int]] = {}
            for r, idx in enumerate(t_idx):
                holders.setdefault(tuple(map(tuple, idx)), []).append(r)
            for dst in range(self.world):
                for piece, ranks in holders.items():
                    piece = [list(p) for p in piece]
                    region = _overlap(piece, d_idx[dst])
                    if region is None:
                        continue
                    src = dst if dst in ranks else min(ranks)
                    if src == me and dst == me:
                        copies.append((out[_within(region, d_idx[me])],
                                       local[_within(region, t_idx[me])]))
                    elif src == me:
                        ops.append(dist.P2POp(
                            dist.isend,
                            local[_within(region, t_idx[me])].contiguous(),
                            dst))
                    elif dst == me:
                        buf = torch.empty([b - a for a, b in region],
                                          dtype=local.dtype,
                                          device=local.device)
                        ops.append(dist.P2POp(dist.irecv, buf, src))
                        copies.append((out[_within(region, d_idx[me])], buf))
                        received += buf.numel() * buf.element_size()
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for dst, src in copies:
            dst.copy_(src)
        placed = {}
        for name, (out, d_spec) in outs.items():
            dt = flat[name]
            placed[name] = DTensor.from_local(
                out, self.decode_mesh, placements(d_spec, self.decode_mesh),
                run_check=False, shape=dt.shape, stride=dt.stride())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_sync_s = time.perf_counter() - t0
        total = torch.tensor([received], dtype=torch.int64,
                             device=self.device)
        dist.all_reduce(total)
        self.last_sync_bytes = int(total.item())
        return nest(placed)

    def place_prompts(self, prompts) -> Any:
        """Batch over the decode mesh's dp axis."""
        return self._place(self.decode_planner, "prompts", prompts,
                           ("dp",) + (None,) * (np.ndim(prompts) - 1))

    def place_batch_train(self, x) -> Any:
        """Batch over the train mesh's data axes (for the PPO update)."""
        return self._place(self.train_planner, "batch", x,
                           self.train_planner.batch_spec(np.ndim(x), None, 0))
