"""torch.distributed.checkpoint (DCP) layout interop for flash checkpoints.

Parity: dlrover_wuqiong_tpu/checkpoint/orbax_compat.py, whose Orbax is
JAX's interchange format; torch's own is DCP, which ships with torch.
Flash checkpoints use a framework-internal layout (shm-staged raw shard
files + done-dir commit) made for sub-second saves; this module converts
both ways so that checkpoints are not framework-locked:

    export_dcp(flash_dir, dcp_path, template)   # flash -> DCP
    state = load_dcp(dcp_path, template)        # DCP -> sharded state
    import_dcp(dcp_path, flash_dir, template)   # DCP -> flash layout

`template` is a tree of tensors or a `trainer.train_step.TrainState`
(``state.tree()``, a `parallel.local_sgd.DiLoCoState`'s too): a restore
lands on the template's placements, so a checkpoint written on one mesh
reloads onto another, with the flash loader's restore-with-resharding
semantics (`checkpoint.engine.restore_tree`).

The DCP checkpoint holds the flash checkpoint's leaves under their flash
names.  A leaf every rank holds whole (the step, a count, a replicated
parameter) is one key, which DCP writes once.  A rank's piece of a
sharded leaf (a `checkpoint.shm_handler.MeshPiece` or a DTensor: an
fsdp piece, a quantized state's rows, a DiLoCo replica) is a key of its
own, ``<name>#shard<N>[<start>:<stop>,...]of[<global shape>]``, written
by the rank that owns the piece: a plain tensor under the leaf's own
name would be taken for a replicated one and written by one rank only.
A load reads every piece of each leaf the template names and assembles
the global array on each rank, as the flash loader does, then keeps
each rank's slice.

The calls are the DCP ones that torch 2.11 and 2.13 both have:
``dcp.save``/``dcp.load`` with ``FileSystemWriter``/``FileSystemReader``
and ``checkpoint_id``.  The port cannot read an Orbax checkpoint; a
JAX checkpoint reaches the port through the flash layout, whose bytes
the two packages share.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..common.log import get_logger

logger = get_logger("dcp_compat")

_PIECE = re.compile(r"^(.*)#shard(\d+)\[([0-9:,]*)\]of\[([0-9,]*)\]$")


def _piece_key(name: str, number: int, index, global_shape) -> str:
    return (f"{name}#shard{number}["
            + ",".join(f"{a}:{b}" for a, b in index) + "]of["
            + ",".join(str(s) for s in global_shape) + "]")


def _parse_piece(key: str):
    """(name, index, global shape) of a piece key, or None."""
    m = _PIECE.match(key)
    if m is None:
        return None
    index = [[int(x) for x in ab.split(":")]
             for ab in m.group(3).split(",") if ab]
    shape = [int(s) for s in m.group(4).split(",") if s]
    return m.group(1), index, shape


def _tree_of(state: Any) -> Any:
    """A `TrainState` (or anything with ``tree()``) as its checkpoint
    tree; any other tree as it is."""
    tree = getattr(state, "tree", None)
    return tree() if callable(tree) else state


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def dcp_state_dict(state: Any) -> Dict[str, torch.Tensor]:
    """The DCP state dict this rank saves for `state`: {key: tensor},
    its whole leaves under their names and its pieces under piece keys
    (module docstring).  The tensors are the state's own (no copy)."""
    from .shm_handler import _leaf_refs, flatten_state_dict

    out: Dict[str, torch.Tensor] = {}
    for name, leaf in flatten_state_dict(_tree_of(state)).items():
        for ename, ref, gshape, index in _leaf_refs(name, leaf):
            if not torch.is_tensor(ref):
                ref = torch.from_numpy(np.ascontiguousarray(ref))
            if "#shard" in ename:
                if ref.numel() == 0:
                    continue  # an empty piece holds nothing
                number = int(ename.rsplit("#shard", 1)[1])
                ename = _piece_key(name, number, index, gshape)
            out[ename] = ref.contiguous()
    return out


def save_dcp(path: str, state: Any) -> None:
    """Write `state` (a tree, or a `TrainState`) as a DCP checkpoint;
    collective over the default process group when there is one."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    dcp.save(dcp_state_dict(state),
             storage_writer=dcp.FileSystemWriter(path),
             checkpoint_id=path)


def read_dcp(path: str, names) -> Dict[str, torch.Tensor]:
    """{name: the global CPU tensor} of the leaves `names` in the DCP
    checkpoint at `path`, assembled from their pieces (every rank reads
    all of them; collective like `dcp.load`).  A name the checkpoint
    lacks is left out."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    wanted = set(names)
    request: Dict[str, torch.Tensor] = {}
    pieces: Dict[str, list] = {}
    for key, md in meta.items():
        parsed = _parse_piece(key)
        name = key if parsed is None else parsed[0]
        if name not in wanted or not hasattr(md, "size"):
            continue
        request[key] = torch.empty(tuple(md.size),
                                   dtype=md.properties.dtype)
        if parsed is not None:
            pieces.setdefault(name, []).append((key, parsed[1], parsed[2]))
    if request:
        dcp.load(request, storage_reader=dcp.FileSystemReader(path),
                 checkpoint_id=path)
    out = {k: v for k, v in request.items() if k in wanted}
    for name, parts in pieces.items():
        shape = parts[0][2]
        full = torch.empty(shape, dtype=request[parts[0][0]].dtype)
        covered = 0
        for key, index, _ in parts:
            full[tuple(slice(a, b) for a, b in index)] = request[key]
            covered += request[key].numel()
        if covered < full.numel():
            raise ValueError(f"{path}: the pieces of {name!r} cover "
                             f"{covered} of its {full.numel()} elements")
        out[name] = full
    return out


def load_dcp(path: str, template: Any) -> Any:
    """Read a DCP checkpoint into `template` (in place, on its devices
    and placements; a `TrainState` through its ``load_tree``) and return
    it."""
    from .engine import restore_tree
    from .shm_handler import flatten_state_dict

    names = flatten_state_dict(_tree_of(template)).keys()
    flat = read_dcp(path, names)
    return restore_tree(template, flat)


def _checkpointer(flash_dir: str, job_name: str):
    """A `FlashCheckpointer` of this rank: in a world of several, its own
    saver (job ``<job>-r<rank>``, node ``rank``), committed once every
    rank's shards landed."""
    from .checkpointer import FlashCheckpointer

    rank, world = _rank_world()
    if world == 1:
        return FlashCheckpointer(flash_dir, job_name=job_name)
    return FlashCheckpointer(flash_dir, job_name=f"{job_name}-r{rank}",
                             node_rank=rank, world_shard_num=world)


def _close(ck) -> None:
    """Close `ck`, and the async saver it hosted (one a process)."""
    from .ckpt_saver import AsyncCheckpointSaver

    hosted = ck.engine._saver is not None
    ck.close()
    if hosted:
        AsyncCheckpointSaver.reset()


def export_dcp(flash_dir: str, dcp_path: str, template: Any,
               step: Optional[int] = None,
               job_name: str = "dcp-export") -> Any:
    """Flash checkpoint dir -> DCP layout; returns the exported state
    (the template, restored in place)."""
    ck = _checkpointer(flash_dir, job_name)
    try:
        state = ck.load_checkpoint(template, step=step)
    finally:
        _close(ck)
    if state is None:
        raise FileNotFoundError(
            f"no committed flash checkpoint under {flash_dir}")
    save_dcp(dcp_path, state)
    logger.info("exported flash checkpoint %s (step=%s) to dcp %s",
                flash_dir, step, dcp_path)
    return state


def import_dcp(dcp_path: str, flash_dir: str, template: Any,
               step: int = 0, job_name: str = "dcp-import") -> Any:
    """DCP checkpoint -> committed flash layout; returns the state (the
    template, restored in place)."""
    from .checkpointer import StorageType

    state = load_dcp(dcp_path, template)
    ck = _checkpointer(flash_dir, job_name)
    try:
        ck.save_checkpoint(step, _tree_of(state),
                           storage_type=StorageType.DISK)
        if not ck.wait_latest_checkpoint(600):
            raise TimeoutError(f"flash checkpoint step {step} under "
                               f"{flash_dir} did not commit")
    finally:
        _close(ck)
    logger.info("imported dcp %s into flash layout %s (step=%d)",
                dcp_path, flash_dir, step)
    return state
