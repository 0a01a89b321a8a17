"""Pipeline parallelism over the mesh's ``pp`` dim: GPipe, interleaved
(circular virtual stages) and 1F1B schedules.

Parity: dlrover_wuqiong_tpu/parallel/pipeline.py — `schedule_ticks`
(:97), `default_pp_microbatches` (:112), `circular_layer_order` (:119),
`_apply_block` / `_scan_blocks` (:137-158), `pipeline_apply` (:161),
`_interleaved_apply` (:245), `pipeline_1f1b` (:315), the layer split /
stack / unstack helpers (:477-501) and `PipelinedLM` (:504), with the
same names, tick arithmetic, stash ring and messages.

The JAX package runs every stage in lockstep under ``shard_map`` over
``pp`` and hands activations on with ``ppermute``.  Here each rank of
the ``pp`` group is one stage: a `PipelinedLM` holds the embedding and
head leaves and only its own stage's blocks (in `circular_layer_order`
for the interleaved schedule), and the schedules below run on a list
of the stages this process holds, one tick at a time:

- After every tick the stages trade tensors through a transport
  (`WorldHop`: ``dist.batch_isend_irecv`` over the ``pp`` group, the
  counterpart of ``ppermute``; `LocalHop`: the stages of one process).
  Whether a stage sends at tick t is one rule (`_sends`, `_slot_f`,
  `_slot_b`); a stage posts a receive exactly when its neighbour's rule
  says that neighbour sends, so every send meets its receive at t + 1.
- A slot's validity is a host integer (t, stage and M are Python ints),
  so a stage runs only its valid slots where JAX computes every slot
  and masks the results: the same numbers, less work.
- GPipe and interleaved train through an explicit fill-drain backward:
  the forward keeps each microbatch's stage graph, and the backward
  walks the forward's ticks in reverse, one ``torch.autograd.backward(
  [y, aux], [dy, g_aux / M])`` per event, the input's cotangent handed
  back by the reverse hop.  The hop itself carries no autograd graph:
  the cotangents travel by the explicit schedule, which is what keeps
  the ranks' point-to-point calls in the same order (an autograd-driven
  hop would leave their order to each rank's autograd engine).
- 1F1B runs one forward (no graph) and one backward a tick; the
  backward recomputes the stage from its stashed input (a ring of
  ``min(M, 2 pp - 1)``), and the last stage seeds each microbatch's
  backward with its head loss's in the same tick.  The MoE aux
  cotangent ``1 / M`` is seeded in every backward slot.
- The loss lives on the last stage.  `PipelinedLM.forward` returns the
  logits on every stage (the last stage's outputs broadcast over
  ``pp``, JAX's psum), and the leaves every stage holds (embedding,
  head, ``ln_f`` / ``norm``) get, on each stage, only the gradient that
  stage computed: the embedding's on stage 0, the head's on the last
  (GPT's tied ``wte`` in both).  `parallel.fsdp.MeshState` sums them
  over ``pp``; a stage's block gradients stay local.

`EmulatedPipeline` runs the pp stages in one process with `LocalHop`:
the same stage bodies, tick arithmetic and stash ring (NCCL puts no two
ranks on one card, so that is what the chip check runs).
"""

from __future__ import annotations

import contextlib
import functools
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

SCHEDULES = ("gpipe", "interleaved", "1f1b")


def schedule_ticks(schedule: str, num_microbatches: int, pp: int,
                   virtual_stages: int = 1) -> Tuple[int, float]:
    """(tick count, bubble fraction) of a schedule's forward pass.

    Per-tick work is one layer-*chunk* (a full per-device stage for
    gpipe/1f1b, 1/v of it for interleaved), so bubble fractions are directly
    comparable across schedules."""
    M, v = num_microbatches, virtual_stages
    if schedule == "interleaved":
        ticks = M * v + pp - 1
        return ticks, (pp - 1) / ticks
    ticks = M + pp - 1
    return ticks, (pp - 1) / ticks


def check_schedule(schedule: str) -> None:
    """The schedule's name, refused as JAX's `_s_pp` refuses it."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} — "
                         "expected 'gpipe', 'interleaved' or '1f1b'")


def check_layers(n_layer: Optional[int], pp: int) -> None:
    """Layers divisible by pp (JAX :557)."""
    if n_layer is None or n_layer % pp:
        raise ValueError(f"pipeline_parallel needs layers ({n_layer}) "
                         f"divisible by pp={pp}")


def default_pp_microbatches(accum_steps: int, pp: int) -> int:
    """The microbatch-count policy shared by auto_accelerate (what gets
    built) and the strategy engine's bubble estimate (what gets scored) —
    one definition so they cannot silently diverge."""
    return max(accum_steps, 2 * pp)


def circular_layer_order(n_layer: int, pp: int, v: int) -> List[int]:
    """Layer permutation for the interleaved (circular) schedule.

    Chunk c (layers [c*Lc, (c+1)*Lc)) lives on device `c % pp` at local
    position `c // pp`; this order makes each device's `P("pp")` slice of the
    stacked layer axis exactly its v chunks, concatenated."""
    if n_layer % (pp * v):
        raise ValueError(f"layers ({n_layer}) must divide by pp*v="
                         f"{pp * v} for the interleaved schedule")
    lc = n_layer // (pp * v)
    order = []
    for d in range(pp):
        for j in range(v):
            c = d + j * pp
            order.extend(range(c * lc, (c + 1) * lc))
    return order


# ------------------------------------------------------------ stage bodies


def _apply_block(block_fn: Callable, h):
    """block_fn may return h, (h, aux) or (h, None) — MoE blocks surface
    their load-balancing aux loss this way; the aux comes back float32
    (a float32 zero for a dense block)."""
    out = block_fn(h)
    if isinstance(out, tuple):
        h2, aux = out
        if aux is not None:
            return h2, aux.float()
        out = h2
    return out, torch.zeros((), dtype=torch.float32, device=_local(out).device)


def _scan_blocks(block_fns: Sequence[Callable], h):
    """Apply the blocks in order, summing their aux: the ONE aux-carry
    implementation shared by every schedule."""
    aux = None
    for fn in block_fns:
        h, a = _apply_block(fn, h)
        aux = a if aux is None else aux + a
    return h, aux


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


# ------------------------------------------------------------ slot rules


def _event(t: int, stage: int, M: int, pp: int,
           v: int) -> Optional[Tuple[int, int]]:
    """(microbatch, chunk) that `stage` runs at forward tick `t` of the
    gpipe (v = 1) or interleaved schedule, or None.  Interleaved: event
    (m, chunk c) at tick ``c + (m % pp) + pp*v*(m // pp)`` on device
    ``c % pp`` (JAX :248)."""
    u = t - stage
    if u < 0:
        return None
    if v == 1:
        return (u, 0) if u < M else None
    r, k = u % pp, u // pp
    j, q = k % v, k // v
    if q >= M // pp:
        return None
    return r + pp * q, j


def _sends(t: int, stage: int, M: int, pp: int, v: int) -> bool:
    """Does `stage` hand its output of tick `t` to stage ``(stage + 1) %
    pp`` (every event but the last chunk of the last stage, which is an
    output of the pipeline)?  The receiver posts its receive on this
    same rule, and the backward mirrors it."""
    ev = _event(t, stage, M, pp, v)
    return ev is not None and not (stage == pp - 1 and ev[1] == v - 1)


def _slot_f(t: int, stage: int, M: int) -> Optional[int]:
    """1F1B forward slot: microbatch ``t - stage``, or None."""
    m = t - stage
    return m if 0 <= m < M else None


def _slot_b(t: int, stage: int, M: int, pp: int) -> Optional[int]:
    """1F1B backward slot: microbatch ``t - 2(pp - 1) + stage``, or None."""
    m = t - 2 * (pp - 1) + stage
    return m if 0 <= m < M else None


# ------------------------------------------------------------ transports


class LocalHop:
    """The transport between stages of one process: a send is the
    receiver's tensor (the graphs are cut by the schedules, not here)."""

    def exchange(self, sends: Dict[tuple, torch.Tensor],
                 wants: Dict[tuple, Tuple]) -> Dict[tuple, torch.Tensor]:
        if set(sends) != set(wants):
            raise AssertionError(f"pipeline slot rule broken: sends "
                                 f"{sorted(sends)} != wants {sorted(wants)}")
        return dict(sends)

    def last_to_all(self, value: Dict[int, Any], like: Tuple) -> Any:
        return value[max(value)]

    def sum(self, values: Dict[int, torch.Tensor]) -> torch.Tensor:
        total = None
        for s in sorted(values):
            total = values[s] if total is None else total + values[s]
        return total


class WorldHop:
    """The transport over a ``torch.distributed`` ``pp`` group (stage k
    is the group's rank k): point-to-point sends and receives, one
    ``batch_isend_irecv`` an exchange, waited on before the next tick."""

    def __init__(self, group):
        self.group = group
        self.pp = dist.get_world_size(group)
        self.stage = dist.get_rank(group)

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def exchange(self, sends: Dict[tuple, torch.Tensor],
                 wants: Dict[tuple, Tuple]) -> Dict[tuple, torch.Tensor]:
        """`sends` {(src, dst, kind): tensor} from this stage, `wants`
        {(src, dst, kind): (shape, dtype, device)} to this stage."""
        ops, got = [], {}
        for key in sorted(sends):
            ops.append(dist.P2POp(dist.isend, sends[key].contiguous(),
                                  self._peer(key[1]), self.group))
        for key in sorted(wants):
            shape, dtype, device = wants[key]
            got[key] = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, got[key], self._peer(key[0]),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got

    def last_to_all(self, value: Dict[int, Any], like: Tuple) -> Any:
        """The last stage's tensor on every stage (a broadcast)."""
        shape, dtype, device = like
        buf = value.get(self.pp - 1)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, device=device)
        else:
            buf = buf.detach().contiguous()
        dist.broadcast(buf, self._peer(self.pp - 1), group=self.group)
        return buf

    def sum(self, values: Dict[int, torch.Tensor]) -> torch.Tensor:
        out = values[self.stage].detach().clone()
        dist.all_reduce(out, group=self.group)
        return out


# ------------------------------------------------------------ schedules


class _Run:
    """A gpipe/interleaved forward's records, for its backward."""

    def __init__(self, M: int, pp: int, v: int, like: Tuple):
        self.M, self.pp, self.v, self.like = M, pp, v, like
        self.events: Dict[int, Dict[int, tuple]] = {}
        self.ticks = M * v + pp - 1


def pipeline_apply(stages: Sequence["PipelinedLM"], xm: Optional[List],
                   hop, num_microbatches: int, like: Tuple,
                   virtual_stages: int = 1, keep_graph: bool = False):
    """Run the stages this process holds through the gpipe (v = 1) or
    interleaved (v > 1) schedule's forward.

    Args:
        stages: this process's `PipelinedLM` stages (one in a world).
        xm: the M embedded microbatches (on stage 0's process; None
            elsewhere).  With `keep_graph` each must be a leaf that
            requires grad: its ``.grad`` is stage 0's input cotangent.
        like: (shape, dtype, device) of one microbatch's activation.
        keep_graph: keep every event's graph for `pipeline_backward`.
    Returns (outs: the last stage's M outputs, or None where it is not
    held; aux: {stage: its float32 aux sum}; the `_Run` record)."""
    M, v = num_microbatches, virtual_stages
    pp = stages[0].pp
    run = _Run(M, pp, v, like)
    outs: List = [None] * M
    aux = {st.stage: torch.zeros((), dtype=torch.float32,
                                 device=like[2]) for st in stages}
    inbox: Dict[int, torch.Tensor] = {}
    for t in range(run.ticks):
        sends = {}
        for st in stages:
            s = st.stage
            ev = _event(t, s, M, pp, v)
            if ev is None:
                continue
            m, j = ev
            if s == 0 and j == 0:
                h = xm[m]
            else:
                h = inbox.pop(s)
                if keep_graph:
                    h = h.detach().requires_grad_()
            with torch.set_grad_enabled(keep_graph):
                y, a = _scan_blocks(st.chunk(j), st.as_activation(h))
                y = st.settle(y)
            aux[s] = aux[s] + a.detach()
            if keep_graph:
                run.events.setdefault(s, {})[t] = (m, j, h, y, a)
            if s == pp - 1 and j == v - 1:
                outs[m] = y
            else:
                sends[(s, (s + 1) % pp, "f")] = st.to_wire(y)
        wants = {((s - 1) % pp, s, "f"): like for s in (st.stage
                                                         for st in stages)
                 if _sends(t, (s - 1) % pp, M, pp, v)}
        inbox = {k[1]: x for k, x in hop.exchange(sends, wants).items()}
    for st in stages:
        st.ticks += run.ticks
    held = any(st.stage == pp - 1 for st in stages)
    return (outs if held else None), aux, run


def pipeline_backward(stages: Sequence["PipelinedLM"], run: _Run, hop,
                      dys: Optional[List], aux_cotangent) -> Optional[List]:
    """The fill-drain backward of a `pipeline_apply` run: the forward's
    ticks in reverse, each event's ``autograd.backward([y, aux], [dy,
    aux_cotangent / M])``, its input's cotangent sent back to the stage
    that sent the input.  `dys`: the last stage's M output cotangents.
    Returns stage 0's M input cotangents (None where stage 0 is not
    held); every block's gradient is left in its ``.grad``."""
    M, pp, v = run.M, run.pp, run.v
    g_aux = None
    d_x: List = [None] * M
    inbox: Dict[int, torch.Tensor] = {}
    for tau in range(run.ticks):
        t = run.ticks - 1 - tau
        sends = {}
        for st in stages:
            s = st.stage
            ev = run.events.get(s, {}).pop(t, None)
            if ev is None:
                continue
            m, j, h, y, a = ev
            dy = dys[m] if s == pp - 1 and j == v - 1 else inbox.pop(s)
            outs, grads = [y], [st.from_wire(dy, y)]
            if a.requires_grad:
                if g_aux is None:
                    g_aux = torch.as_tensor(aux_cotangent, dtype=torch.float32,
                                            device=a.device) / M
                outs.append(a)
                grads.append(g_aux)
            torch.autograd.backward(outs, grads)
            if s == 0 and j == 0:
                d_x[m] = h.grad
            else:
                sends[(s, (s - 1) % pp, "b")] = h.grad
        wants = {(((s + 1) % pp), s, "b"): run.like
                 for s in (st.stage for st in stages)
                 if _sends(t - 1, s, M, pp, v)}
        inbox = {k[1]: x for k, x in hop.exchange(sends, wants).items()}
    for st in stages:
        st.ticks += run.ticks
    return d_x if any(st.stage == 0 for st in stages) else None


def pipeline_1f1b(stages: Sequence["PipelinedLM"], xm: Optional[List],
                  labels: List, head_loss: Callable, hop,
                  num_microbatches: int, like: Tuple):
    """One-forward-one-backward training schedule (JAX :315-468).

    Per tick, every stage runs one microbatch forward (no graph) and one
    backward, recomputing the stage from its stashed *input*: the stash
    is a ring of ``S = min(M, 2 pp - 1)`` stage inputs, independent of
    M.  Stage d at tick t: forward of microbatch ``t - d``, backward of
    ``t - 2(pp - 1) + d``; both chains hop one tick.  The last stage
    runs the head and its loss (``head_loss(stage, h, labels_m)``) on
    each forward and seeds the microbatch's backward in the same tick,
    with the cotangent ``1 / M``; every backward slot seeds the MoE aux
    with ``1 / M``.

    Returns (loss: the mean-over-M loss plus aux, summed over the stages
    and the same on each; stage 0's M input cotangents, or None where
    stage 0 is not held).  The gradients of the blocks and of the head
    (scaled by 1 / M) are left in their ``.grad``."""
    M = num_microbatches
    pp = stages[0].pp
    S = min(M, 2 * pp - 1)
    n_ticks = M + 2 * (pp - 1)
    device = like[2]
    inv_m = torch.full((), 1.0 / M, dtype=torch.float32, device=device)
    stash = {st.stage: [None] * S for st in stages}
    loss = {st.stage: torch.zeros((), dtype=torch.float32, device=device)
            for st in stages}
    seed: Dict[int, torch.Tensor] = {}
    d_x: List = [None] * M
    in_f: Dict[int, torch.Tensor] = {}
    in_b: Dict[int, torch.Tensor] = {}
    for t in range(n_ticks):
        sends = {}
        for st in stages:
            s = st.stage
            # ---- forward slot
            m_f = _slot_f(t, s, M)
            if m_f is not None:
                h_in = xm[m_f] if s == 0 else in_f.pop(s)
                with torch.no_grad():
                    y, a = _scan_blocks(st.chunk(0), st.as_activation(h_in))
                    y = st.settle(y)
                stash[s][m_f % S] = h_in
                loss[s] = loss[s] + a / M
                if s == pp - 1:
                    y_leaf = _local(y).detach().requires_grad_()
                    lm = head_loss(st, st.as_activation(y_leaf), labels[m_f])
                    torch.autograd.backward(lm, inv_m.to(lm.dtype))
                    seed[s] = y_leaf.grad
                    loss[s] = loss[s] + lm.detach().float() / M
                else:
                    sends[(s, s + 1, "f")] = st.to_wire(y)
            # ---- backward slot (recompute from the stash)
            m_b = _slot_b(t, s, M, pp)
            if m_b is not None:
                h = _local(stash[s][m_b % S]).detach().requires_grad_()
                stash[s][m_b % S] = None
                y, a = _scan_blocks(st.chunk(0), st.as_activation(h))
                y = st.settle(y)
                dy = seed.pop(s) if s == pp - 1 else in_b.pop(s)
                outs, grads = [y], [st.from_wire(dy, y)]
                if a.requires_grad:
                    outs.append(a)
                    grads.append(inv_m)
                torch.autograd.backward(outs, grads)
                if s == 0:
                    d_x[m_b] = h.grad
                else:
                    sends[(s, s - 1, "b")] = h.grad
        wants = {}
        for s in (st.stage for st in stages):
            if s > 0 and _slot_f(t, s - 1, M) is not None:
                wants[(s - 1, s, "f")] = like
            if s < pp - 1 and _slot_b(t, s + 1, M, pp) is not None:
                wants[(s + 1, s, "b")] = like
        got = hop.exchange(sends, wants)
        in_f = {k[1]: x for k, x in got.items() if k[2] == "f"}
        in_b = {k[1]: x for k, x in got.items() if k[2] == "b"}
    for st in stages:
        st.ticks += n_ticks
    total = hop.sum(loss)
    return total, (d_x if any(st.stage == 0 for st in stages) else None)


# --------------------------------------------------------- model integration


_LAYER_RE = re.compile(r"^(h|layers)_(\d+)$")


def split_layer_params(params: Dict) -> Tuple[Dict, List[Dict], str]:
    """Split a flax param dict into (non_layer, [layer_0..layer_{L-1}], key
    prefix).  Layers are the `h_<i>` / `layers_<i>` subtrees."""
    non_layer, layers = {}, {}
    prefix = None
    for k, v in params.items():
        m = _LAYER_RE.match(k)
        if m:
            prefix = m.group(1)
            layers[int(m.group(2))] = v
        else:
            non_layer[k] = v
    ordered = [layers[i] for i in range(len(layers))]
    if not ordered:
        raise ValueError("model has no h_<i>/layers_<i> blocks to pipeline")
    return non_layer, ordered, prefix or "h"


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack(xs):
    if torch.is_tensor(xs[0]):
        return torch.stack(list(xs))
    import numpy as np

    return np.stack([np.asarray(x) for x in xs])


def stack_layer_params(layers: List[Dict]) -> Dict:
    """[per-layer tree] -> one tree with a leading layer axis (tensors or
    numpy arrays)."""
    return _tree_map(lambda *xs: _stack(xs), *layers)


def unstack_layer_params(stacked: Dict, n: int) -> List[Dict]:
    return [_tree_map(lambda x: x[i], stacked) for i in range(n)]


class PipelinedLM(nn.Module):
    """One pipeline stage of a block-structured LM (GPT/Llama family).

    Holds the inner model's embedding and head modules and its stage's
    blocks, registered under the inner model's names (``wte``,
    ``h_<i>``, ``ln_f``; ``embed_tokens``, ``layers_<i>``, ``norm``,
    ``lm_head``); stage s of pp holds positions ``[s L/pp, (s+1) L/pp)``
    of `_order` (the layer order: `circular_layer_order` for the
    interleaved schedule, else 0..L-1).  The pipelined state tree
    (`from_flat_params`, `state_layout`) is JAX's:
    ``{non-layer..., "blocks": stacked}`` with the stacked axis in
    `_order`, sharded over ``pp``.

    `mesh` (a DeviceMesh with a ``pp`` dim) gives the stage and the
    transport (`WorldHop`); without one, `pp` and `stage` say which
    stage this is, for `EmulatedPipeline`.  ``forward(idx)`` returns the
    logits on every stage; `value_and_grad` (1F1B) and
    `loss_and_backward` (gpipe / interleaved) fill ``.grad`` and return
    the loss.  Adapter hooks as JAX's: ``embed_fn(stage, idx)``,
    ``block_builder(stage, idx, deterministic) -> [block_fn per layer
    of the stage]``, ``head_fn(stage, h)``, `embed_keys` / `head_keys`
    (both or neither), `head_loss_fn(head_params, h, labels)` (1F1B
    only; `head_params` the head_keys' modules), `block_returns_aux`."""

    def __init__(self, inner: nn.Module, num_microbatches: int,
                 schedule: str = "gpipe", virtual_stages: int = 1,
                 mesh=None, pp: Optional[int] = None, stage: int = 0,
                 embed_fn: Optional[Callable] = None,
                 block_builder: Optional[Callable] = None,
                 head_fn: Optional[Callable] = None,
                 embed_keys: Optional[Tuple[str, ...]] = None,
                 head_keys: Optional[Tuple[str, ...]] = None,
                 head_loss_fn: Optional[Callable] = None,
                 block_returns_aux: Optional[bool] = None):
        super().__init__()
        self.config = inner.config
        cfg = self.config
        self._n_layer = getattr(cfg, "n_layer", getattr(cfg, "num_layers", 0))
        check_schedule(schedule)
        if head_loss_fn is not None and schedule != "1f1b":
            raise ValueError(
                "head_loss_fn only applies to schedule='1f1b' — gpipe/"
                "interleaved train through a whole-batch loss_fn and "
                "would silently ignore it")
        if getattr(cfg, "moe_experts", 0) and block_builder is not None \
                and block_returns_aux is None:
            raise ValueError(
                "MoE config with a custom block_builder: set "
                "block_returns_aux=True if the builder's block_fn returns "
                "(h, aux), False if the aux loss is handled elsewhere")
        if bool(embed_keys) != bool(head_keys):
            raise ValueError("embed_keys and head_keys must be supplied "
                             "together for adapter-hook models")
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.virtual_stages = virtual_stages
        self.embed_fn, self.block_builder = embed_fn, block_builder
        self.head_fn, self.head_loss_fn = head_fn, head_loss_fn
        self.embed_keys, self.head_keys = embed_keys, head_keys
        self.block_returns_aux = block_returns_aux
        self.mesh = mesh
        if mesh is not None:
            from .sharding import mesh_sizes

            self.pp = mesh_sizes(mesh).get("pp", 1)
            self.stage = mesh.get_local_rank("pp") if self.pp > 1 else 0
        else:
            self.pp, self.stage = pp or 1, stage
        check_layers(self._n_layer, self.pp)
        if schedule == "interleaved":
            if num_microbatches % self.pp:
                raise ValueError(
                    f"interleaved schedule needs microbatches "
                    f"({num_microbatches}) divisible by pp={self.pp}")
            self._order = circular_layer_order(self._n_layer, self.pp,
                                               virtual_stages)
        else:
            self._order = list(range(self._n_layer))
        per = self._n_layer // self.pp
        self.stage_layers = self._order[self.stage * per:
                                        (self.stage + 1) * per]
        self._prefix = "h"
        for name, child in inner.named_children():
            m = _LAYER_RE.match(name)
            if m:
                self._prefix = m.group(1)
                if int(m.group(2)) not in self.stage_layers:
                    continue
            self.add_module(name, child)
        self.intermediates: Dict = {}
        # the tp DeviceMesh of a tensor-parallel stage (auto_accelerate)
        self.activation_mesh = None
        self.ticks = 0  # schedule ticks run, for the chip check
        self._hop = None
        self._pending = None

    # ------------------------------------------------------------ plumbing

    def hop(self):
        if self._hop is None:
            self._hop = (WorldHop(self.mesh.get_group("pp"))
                         if self.mesh is not None and self.pp > 1
                         else LocalHop())
        return self._hop

    def holds_elsewhere(self, name: str) -> bool:
        """Is `name` a leaf of a block that another stage holds?"""
        m = _LAYER_RE.match(name.split(".", 1)[0])
        return bool(m) and int(m.group(2)) not in self.stage_layers

    def init_leaves(self, seed: int = 0, device=None):
        """Every leaf of the inner model's seeded init, in its order (a
        stage keeps its own: `parallel.fsdp.materialize`)."""
        from ..models import gpt, llama

        if hasattr(self.config, "n_layer"):
            return gpt.init_leaves(self.config, seed, device)
        return llama.init_leaves(self.config, seed, device)

    def fsdp_units(self):
        return self.blocks()

    def blocks(self) -> List[nn.Module]:
        """The stage's block modules, in stage (`_order`) order."""
        return [getattr(self, f"{self._prefix}_{i}")
                for i in self.stage_layers]

    def block_names(self) -> List[str]:
        """Parameter names of the stage's blocks (local over ``pp``)."""
        mods = {f"{self._prefix}_{i}" for i in self.stage_layers}
        return [n for n, _ in self.named_parameters()
                if n.split(".", 1)[0] in mods]

    # -- param plumbing (JAX :570-587)

    def from_flat_params(self, flat: Dict) -> Dict:
        """The inner model's layout -> pipelined layout (ckpt import)."""
        non_layer, layers, self._prefix = split_layer_params(dict(flat))
        out = dict(non_layer)
        out["blocks"] = stack_layer_params([layers[i] for i in self._order])
        return out

    def to_flat_params(self, params: Dict) -> Dict:
        """Pipelined layout -> the inner model's layout (for export)."""
        out = {k: v for k, v in params.items() if k != "blocks"}
        stacked = unstack_layer_params(params["blocks"], self._n_layer)
        for pos, layer_idx in enumerate(self._order):
            out[f"{self._prefix}_{layer_idx}"] = stacked[pos]
        return out

    def stage_rows(self) -> Tuple[int, int]:
        """[start, stop) of this stage's rows of the stacked layer axis."""
        per = self._n_layer // self.pp
        return self.stage * per, (self.stage + 1) * per

    def state_layout(self) -> Dict[str, Tuple[List[int], List[List[int]]]]:
        """{pipelined flax path: (global shape, this rank's [start, stop)
        per dim)} of every leaf of the stage: a ``blocks/...`` leaf is
        (L, *layer shape), its rows `stage_rows` (``P("pp", ...)``) and
        the inner dims as the layer's piece; every other leaf as its
        parameter's piece."""
        from torch.distributed.fsdp import FSDPModule

        from .fsdp import is_dtensor
        from .sharding import dtensor_layout

        if isinstance(self, FSDPModule):
            self.reshard()  # a forward leaves the root's leaves gathered

        def piece(p):
            if is_dtensor(p):
                return list(p.shape), dtensor_layout(p)[0]
            return list(p.shape), [[0, s] for s in p.shape]

        first = f"{self._prefix}_{self.stage_layers[0]}."
        lo, hi = self.stage_rows()
        out = {}
        for name, p in self.named_parameters():
            head, _, rest = name.partition(".")
            if _LAYER_RE.match(head):
                if not name.startswith(first):
                    continue
                shape, index = piece(p)
                out["blocks/" + rest.replace(".", "/")] = (
                    [self._n_layer] + shape, [[lo, hi]] + index)
            else:
                out[name.replace(".", "/")] = piece(p)
        return out

    # ------------------------------------------------------------ adapters

    def _is_gpt(self) -> bool:
        return hasattr(self.config, "n_layer")

    def _seq(self, idx) -> Tuple[int, int]:
        from .long_context import seq_offset

        T = idx.shape[1]
        return seq_offset(getattr(self.config, "mesh", None), T), T

    def embed(self, idx: torch.Tensor):
        if self.embed_fn is not None:
            return self.embed_fn(self, idx)
        cfg = self.config
        if self._is_gpt():
            t0, T = self._seq(idx)
            return self.wte(idx) + \
                self.wpe.embedding[t0:t0 + T].to(cfg.dtype)[None]
        return self.embed_tokens(idx)

    def head(self, h):
        if self.head_fn is not None:
            return self.head_fn(self, h)
        cfg = self.config
        if self._is_gpt():
            return self.ln_f(h) @ self.wte.embedding.to(cfg.dtype).t()
        return self.lm_head(self.norm(h))

    def _embed_head_keys(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        if self.embed_keys or self.head_keys:
            return tuple(self.embed_keys), tuple(self.head_keys)
        if self._is_gpt():  # GPT: tied wte appears in BOTH (grads sum)
            return ("wte", "wpe"), ("ln_f", "wte")
        return ("embed_tokens",), ("norm", "lm_head")

    def head_params(self) -> Dict[str, nn.Module]:
        return {k: getattr(self, k) for k in self._embed_head_keys()[1]}

    def want_aux(self) -> bool:
        if self.block_returns_aux is not None:
            return self.block_returns_aux
        return bool(getattr(self.config, "moe_experts", 0))

    def _block_fns(self, idx, deterministic: bool = True) -> List[Callable]:
        """One ``h -> h | (h, aux)`` a block of the stage, in stage order
        (remat-wrapped as the model's own forward wraps them)."""
        if self.block_builder is not None:
            return list(self.block_builder(self, idx, deterministic))
        cfg = self.config
        blocks = self.blocks()
        if getattr(cfg, "remat", False):
            from ..ops.remat import (
                MODEL_CHECKPOINT_NAMES,
                resolve_remat_policy,
                trace_remat_policy,
            )

            wrap = resolve_remat_policy(
                trace_remat_policy(cfg.remat_policy),
                cfg.remat_names or MODEL_CHECKPOINT_NAMES)
            blocks = [functools.partial(wrap, b) for b in blocks]
        if self._is_gpt():
            return [functools.partial(_gpt_block, b) for b in blocks]
        from ..models.llama import rope_freqs

        t0, _ = self._seq(idx)
        cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                              idx.device)
        cos, sin = cos[t0:], sin[t0:]
        return [functools.partial(_llama_block, b, cos, sin) for b in blocks]

    def chunk(self, j: int) -> List[Callable]:
        """Chunk j's block functions (of `virtual_stages` chunks a
        stage; the whole stage at v = 1)."""
        fns = self._fns
        lc = len(fns) // self.virtual_stages
        return fns[j * lc:(j + 1) * lc]

    # -- the wire: what crosses a hop is a plain tensor.  Under tensor
    #    parallel the residual stream is a DTensor replicated over ``tp``
    #    (`activation_mesh`): a stage's output is made Replicate inside
    #    its graph, sent as its local tensor, and rebuilt on arrival.

    def as_activation(self, h):
        """A received (or stashed) stage input as the blocks take it."""
        mesh = self.activation_mesh
        if mesh is None or _is_dtensor(h):
            return h
        from torch.distributed.tensor import DTensor, Replicate

        return DTensor.from_local(h, mesh, [Replicate()], run_check=False)

    def settle(self, y):
        """A stage's output, replicated over ``tp`` (in the graph)."""
        if not _is_dtensor(y):
            return y
        from torch.distributed.tensor import Replicate

        rep = [Replicate()] * y.device_mesh.ndim
        return y if tuple(y.placements) == tuple(rep) else \
            y.redistribute(y.device_mesh, rep)

    def to_wire(self, y):
        return _local(y).detach()

    def from_wire(self, g, like):
        """The plain cotangent `g` laid out as the output `like`."""
        if not _is_dtensor(like) or _is_dtensor(g):
            return g
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(g, like.device_mesh, like.placements,
                                  run_check=False)

    def _like(self, idx) -> Tuple:
        M = self.num_microbatches
        width = getattr(self.config, "n_embd",
                        getattr(self.config, "hidden_size", None))
        return ((idx.shape[0] // M, idx.shape[1], width),
                self.config.dtype, idx.device)

    # ------------------------------------------------------------ forward

    def forward(self, idx: torch.Tensor, labels: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator=None):
        """The logits (B, T, vocab) on every stage; with `labels`, the
        1F1B step instead (`value_and_grad`): its loss, the gradients
        in ``.grad``.  (The step runs inside the module's forward so
        that FSDP2's root runs first.)"""
        if not deterministic and getattr(self.config, "dropout", 0) > 0:
            raise NotImplementedError(
                "dropout under pipeline_parallel is not ported (the train "
                "step runs deterministic, as in the JAX package)")
        if labels is not None:
            return _one_f_one_b([self], self.hop(), idx, labels)
        return _apply([self], self.hop(), idx)

    def value_and_grad(self, batch: Dict) -> torch.Tensor:
        """The 1F1B step on {input_ids, labels}: the loss (the head
        loss's mean over microbatches plus the MoE aux, the same on
        every stage), the gradients in ``.grad`` (JAX :631-666)."""
        with _fsdp_deferred(self):
            return self(batch["input_ids"], labels=batch["labels"])

    def loss_and_backward(self, loss_fn: Callable, batch: Dict
                          ) -> torch.Tensor:
        """The gpipe / interleaved step of a whole-batch
        ``loss_fn(model, batch)``: its forward through the pipeline,
        then the fill-drain backward; returns the loss."""
        with _fsdp_deferred(self):
            loss = loss_fn(self, batch)
            _backward([self], self.hop(), loss)
        return loss.detach().float()


def _gpt_block(block, h):
    return block(h, None)  # deterministic: no dropout seed


def _llama_block(block, cos, sin, h):
    return block(h, cos, sin)


def _prepare(stages, idx, deterministic: bool = True):
    for st in stages:
        st._fns = st._block_fns(idx, deterministic)


def _embed_microbatches(stages: Sequence[PipelinedLM], idx, leaf: bool):
    """The step's inputs: every stage's block functions, one
    microbatch's activation (shape, dtype, device), and on stage 0's
    process the embedded batch and its M microbatches, detached (leaves
    that require grad with `leaf`); (None, None) elsewhere."""
    M = stages[0].num_microbatches
    if idx.shape[0] % M:
        raise ValueError(f"batch {idx.shape[0]} not divisible by "
                         f"microbatches {M}")
    _prepare(stages, idx)
    first = _stage(stages, 0)
    if first is None:
        return None, None, stages[0]._like(idx)
    x = first.embed(idx)
    xm = [p.detach().requires_grad_(leaf) for p in x.chunk(M, 0)]
    return x, xm, stages[0]._like(idx)


def _apply(stages: Sequence[PipelinedLM], hop, idx: torch.Tensor):
    """The gpipe / interleaved forward of the stages this process holds
    (1F1B's forward is gpipe): (B, T, vocab) logits from the last
    stage's outputs, broadcast over ``pp``.  With grad enabled, the
    events' graphs wait in ``stages[0]._pending`` for `_backward`."""
    last = _stage(stages, stages[0].pp - 1)
    M = stages[0].num_microbatches
    B = idx.shape[0]
    grad = torch.is_grad_enabled()
    x, xm, like = _embed_microbatches(stages, idx, grad)
    v = stages[0].virtual_stages if stages[0].schedule == "interleaved" \
        else 1
    outs, aux, run = pipeline_apply(stages, xm, hop, M, like, v,
                                    keep_graph=grad)
    pp = stages[0].pp
    full = (B,) + like[0][1:]
    h_last = torch.cat([_local(o) for o in outs]) if outs is not None \
        else None
    h = hop.last_to_all({pp - 1: h_last} if h_last is not None else {},
                        (full, like[1], like[2]))
    if grad and last is not None:
        h = h.detach().requires_grad_()
    head_st = last if last is not None else stages[0]
    logits = head_st.head(head_st.as_activation(h))
    aux_leaf = None
    if head_st.want_aux():
        total = hop.sum(aux) / M
        aux_leaf = total.detach().requires_grad_(grad)
        head_st.intermediates = {"moe_aux_loss": aux_leaf}
    else:
        head_st.intermediates = {}
    if grad:
        stages[0]._pending = (run, x, xm, h if last is not None else None,
                              aux_leaf)
    return logits


def _backward(stages: Sequence[PipelinedLM], hop, loss: torch.Tensor):
    """`_apply`'s training backward for the whole-batch `loss`: the loss
    backward on the last stage (the head's gradients, the outputs' and
    the aux's cotangents), the aux cotangent broadcast, the fill-drain
    backward of the events, then stage 0's embedding backward."""
    run, x, xm, h, aux_leaf = stages[0]._pending
    stages[0]._pending = None
    pp, M = run.pp, run.M
    last = _stage(stages, pp - 1)
    dys = None
    if last is not None:
        torch.autograd.backward(loss)
        g = h.grad if h.grad is not None else torch.zeros_like(h)
        dys = list(g.chunk(M, 0))
    g_aux = 1.0
    if aux_leaf is not None:
        mine = {}
        if last is not None:
            mine[pp - 1] = (aux_leaf.grad if aux_leaf.grad is not None
                            else torch.zeros_like(aux_leaf)).reshape(1)
        g_aux = hop.last_to_all(mine, ((1,), torch.float32, run.like[2]))[0]
    d_x = pipeline_backward(stages, run, hop, dys, g_aux)
    if d_x is not None:
        torch.autograd.backward(x, torch.cat([
            g if g is not None else torch.zeros_like(p)
            for g, p in zip(d_x, xm)]))


def _one_f_one_b(stages: Sequence[PipelinedLM], hop, idx, labels):
    """`pipeline_1f1b` over the stages this process holds, with the
    embedding's backward on stage 0 (JAX :631-666)."""
    from ..models.gpt import cross_entropy_loss

    st0 = stages[0]
    M = st0.num_microbatches
    x, xm, like = _embed_microbatches(stages, idx, False)
    if st0.head_loss_fn is not None:
        def head_loss(st, h, lbl):
            return st.head_loss_fn(st.head_params(), h, lbl)
    else:
        def head_loss(st, h, lbl):
            return cross_entropy_loss(st.head(h), lbl)
    loss, d_x = pipeline_1f1b(stages, xm, list(labels.chunk(M, 0)),
                              head_loss, hop, M, like)
    if d_x is not None:
        first = _stage(stages, 0)
        torch.autograd.backward(x, first.from_wire(torch.cat(d_x), x))
    for st in stages:
        st.intermediates = {}
    return loss


def _stage(stages, s: int) -> Optional[PipelinedLM]:
    for st in stages:
        if st.stage == s:
            return st
    return None


@contextlib.contextmanager
def _fsdp_deferred(model):
    """FSDP2 around a pipeline step (as torch.distributed.pipelining
    drives it): every backward of the step accumulates the unsharded
    gradients, and at the end each group's post-backward reduces them
    once and FSDP's final callback syncs the streams.  A model without
    FSDP2 passes through."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(model, FSDPModule):
        yield
        return
    model.set_requires_gradient_sync(False)
    model.set_reshard_after_backward(False)
    model.set_is_last_backward(False)
    try:
        yield
    finally:
        model.set_requires_gradient_sync(True)
        model.set_reshard_after_backward(True)
        model.set_is_last_backward(True)
        from torch.distributed.fsdp import fully_shard

        state = fully_shard.state(model)
        for st in state._state_ctx.all_states:
            groups = getattr(st, "_fsdp_param_groups", None)
            if groups is None:
                one = getattr(st, "_fsdp_param_group", None)
                groups = [one] if one is not None else []
            for group in groups:
                group.post_backward()
        state._root_post_backward_final_callback()


# ------------------------------------------------------------ one process


class EmulatedPipeline:
    """pp stages of one model in one process, through the same schedule
    bodies with `LocalHop`: the stages share the model's modules (the
    embedding and head leaves are one set of tensors, so the gradients
    that JAX sums over ``pp`` land in one ``.grad``).

    ``pipe(idx)`` gives the logits; `pipeline_step` (or
    ``pipe.value_and_grad(batch)`` under 1F1B,
    ``pipe.loss_and_backward(loss_fn, batch)`` under gpipe and
    interleaved) fills the model's ``.grad`` and returns the loss.
    `stage_kw` goes to every `PipelinedLM` (the adapter hooks,
    ``head_loss_fn``, ``block_returns_aux``)."""

    def __init__(self, model: nn.Module, pp: int, num_microbatches: int,
                 schedule: str = "gpipe", virtual_stages: int = 1,
                 **stage_kw):
        if pp < 2:
            raise ValueError("an emulated pipeline needs pp >= 2")
        self.model = model
        self.pp = pp
        self.schedule = schedule
        self.stages = [PipelinedLM(model, num_microbatches, schedule,
                                   virtual_stages, pp=pp, stage=s,
                                   **stage_kw)
                       for s in range(pp)]
        self.hop = LocalHop()

    @property
    def ticks(self) -> int:
        return self.stages[0].ticks

    @property
    def intermediates(self) -> Dict:
        return self.stages[-1].intermediates

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        return _apply(self.stages, self.hop, idx)

    def value_and_grad(self, batch: Dict) -> torch.Tensor:
        return _one_f_one_b(self.stages, self.hop, batch["input_ids"],
                            batch["labels"])

    def loss_and_backward(self, loss_fn: Callable, batch: Dict
                          ) -> torch.Tensor:
        loss = loss_fn(self, batch)
        _backward(self.stages, self.hop, loss)
        return loss.detach().float()


def pipeline_step(pipe, loss_fn: Callable, batch: Dict) -> torch.Tensor:
    """One training step of `pipe` (a `PipelinedLM` stage or an
    `EmulatedPipeline`) on `batch`, the gradients left in ``.grad``: the
    1F1B schedule's own (its head loss; `loss_fn` is not used), else
    gpipe / interleaved through the whole-batch `loss_fn`.  Returns the
    loss, the same on every stage."""
    if pipe.schedule == "1f1b":
        return pipe.value_and_grad(batch)
    return pipe.loss_and_backward(loss_fn, batch)
