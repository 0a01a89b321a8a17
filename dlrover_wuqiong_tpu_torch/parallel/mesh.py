"""Mesh planning: the sizes of the parallel dims, and their DeviceMesh.

Parity: dlrover_wuqiong_tpu/parallel/mesh.py — `AXIS_ORDER` (:28),
`MeshPlan` (:31), `build_mesh` (:64), `auto_plan` (:79),
`detect_hbm_per_device` (:137), `_largest_pow2_leq` (:152) and
`hybrid_slice_plan` (:156), with the same names, fields, rules and
messages.

A plan's dims are the dims of one ``torch.distributed`` DeviceMesh over
the default process group, outer (slow links, ``dp`` across slices)
to inner (``tp``, the fastest).  Every dim exists, size 1 included, so a
parameter's placements name the same mesh dims under every plan.  A
mesh's device type follows the device: ``cuda`` meshes communicate
through NCCL, ``cpu`` meshes through gloo.

JAX's `context_mesh` and `in_manual_context` serve ``shard_map``
nesting (the sequence- and pipeline-parallel bodies); the port has no
``shard_map``: those bodies run on each rank with their transport
(`parallel.long_context`, `parallel.pipeline`), so it needs neither.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..common.log import get_logger

logger = get_logger("mesh")

# canonical axis order: outer (slow links) -> inner (fast links)
AXIS_ORDER = ("dp", "pp", "fsdp", "ep", "sp", "tp")


@dataclass
class MeshPlan:
    """Sizes of every parallel dim; product must equal device count."""

    dp: int = 1    # pure data parallel (replicated params)
    pp: int = 1    # pipeline stages
    fsdp: int = 1  # data parallel with sharded params/opt-state (ZeRO-3)
    ep: int = 1    # expert parallel
    sp: int = 1    # sequence/context parallel
    tp: int = 1    # tensor parallel

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @property
    def num_devices(self) -> int:
        return math.prod(self.sizes().values())

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes over which the batch is split."""
        return ("dp", "fsdp")

    def validate(self, num_devices: int):
        if self.num_devices != num_devices:
            raise ValueError(
                f"mesh plan {self.sizes()} needs {self.num_devices} devices, "
                f"have {num_devices}")

    def describe(self) -> str:
        return "x".join(f"{a}{n}" for a, n in self.sizes().items() if n > 1) \
            or "single"


def build_mesh(plan: MeshPlan, device_type: Optional[str] = None):
    """The plan's DeviceMesh over the default process group: shape
    ``plan.sizes()[a] for a in AXIS_ORDER``, dims named `AXIS_ORDER`,
    ranks laid out row-major (rank r holds the devices' r-th position,
    as JAX's mesh reshapes its device list).  `device_type` defaults to
    ``cuda``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    plan.validate(dist.get_world_size())
    shape = tuple(plan.sizes()[a] for a in AXIS_ORDER)
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=AXIS_ORDER)


def auto_plan(num_devices: int, num_params: Optional[int] = None,
              hbm_per_device: int = 16 << 30,
              seq_len: int = 0, num_experts: int = 0,
              max_tp: int = 8) -> MeshPlan:
    """Heuristic dim planner.

    Strategy: fit first (enough combined memory for params+opt+
    activations), then throughput — prefer pure DP/FSDP (no per-layer
    collectives), add TP only when a single device cannot hold a layer's
    working set, SP for very long sequences, EP sized to expert count.
    """
    plan = MeshPlan()
    remaining = num_devices

    if num_params:
        # bytes/param: bf16 params + f32 master+m+v ≈ 14; activations extra
        state_bytes = num_params * 14
        min_shards = max(1, math.ceil(state_bytes / (hbm_per_device * 0.7)))
        # TP when even sharded state per device is huge (very large models)
        if num_params > 30e9 and remaining >= 4:
            plan.tp = min(max_tp, _largest_pow2_leq(min(remaining, max_tp)))
            remaining //= plan.tp
    if seq_len >= 32768 and remaining >= 2:
        plan.sp = min(_largest_pow2_leq(remaining), max(2, seq_len // 32768))
        plan.sp = _largest_pow2_leq(plan.sp)
        remaining //= plan.sp
    if num_experts and remaining >= 2:
        plan.ep = min(_largest_pow2_leq(remaining), num_experts)
        remaining //= plan.ep
    # everything else: FSDP
    plan.fsdp = remaining
    plan.validate(num_devices)
    if num_params:
        # enforce the fit: state must shard across enough devices.  sp/ep
        # don't shard the optimizer state, so only tp*fsdp counts.  Before
        # giving up, reclaim sp/ep devices for fsdp — fitting beats the
        # nice-to-have axes.
        while plan.tp * plan.fsdp < min_shards and (plan.sp > 1
                                                    or plan.ep > 1):
            if plan.sp > 1:
                plan.sp //= 2
            else:
                plan.ep //= 2
            plan.fsdp *= 2
            logger.info("reclaimed a device axis for state fit: %s",
                        plan.describe())
        if plan.tp * plan.fsdp < min_shards:
            raise ValueError(
                f"model state (~{num_params * 14 / 1e9:.0f} GB) does not fit: "
                f"needs ≥{min_shards} state shards but plan "
                f"{plan.describe()} provides {plan.tp * plan.fsdp} "
                f"(devices with ≥{hbm_per_device >> 30} GiB HBM)")
    logger.info("auto mesh plan for %d devices: %s", num_devices,
                plan.describe())
    return plan


def detect_hbm_per_device(device=None) -> int:
    """Per-device accelerator memory: the card's total memory, and
    16 GiB on the CPU (JAX's default where the runtime reports none)."""
    device = torch.device(device) if device is not None else None
    if (device is None or device.type == "cuda") and \
            torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(
            device if device is not None and device.index is not None
            else torch.cuda.current_device()).total_memory)
    return 16 << 30


def _largest_pow2_leq(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def hybrid_slice_plan(num_slices: int, devices_per_slice: int,
                      tp: int = 1, sp: int = 1) -> MeshPlan:
    """Multi-slice plan: dp over slices, fsdp/tp within a slice so heavy
    collectives stay on the fast links inside a slice."""
    inner = devices_per_slice // (tp * sp)
    return MeshPlan(dp=num_slices, fsdp=inner, tp=tp, sp=sp)
