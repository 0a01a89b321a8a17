"""Mixture-of-Experts MLP on one device: router, top-k gating, dispatch.

Parity: dlrover_wuqiong_tpu/models/moe.py — `MoEConfig` (:29),
`top_k_gating` (:42), `grouped_moe` (:94), `MoEMLP` (:131) and
`collect_moe_aux_loss` (:181).  The JAX package dispatches densely and lets
GSPMD add the all-to-alls under a mesh; without a mesh nothing else is
needed, so the port runs the same dense math on one device.

- "capacity" (the default, GShard): the router in float32, top-k gating
  into a (T, E, C) combine (float32) and dispatch (bool) tensor, tokens
  past an expert's capacity C dropped; dispatch and combine are 2-D
  products over the flattened (T, E*C) tensors in ``cfg.dtype`` (as JAX's
  ``tec,td->ecd`` and ``tec,ecd->td`` einsums, dots without batch dims),
  the experts batched products over E.
- "grouped" (dropless): tokens stably sorted by expert, one grouped
  product per projection, and ``index_add_`` as ``segment_sum``.  On the
  card the grouped product is ``torch._grouped_mm`` (bf16, int32
  cumulative group ends); it raises where torch lacks it or refuses the
  dtype.  A CPU tensor takes the plain form, a loop over the groups.

Ties: ``jnp.argmax`` and ``torch.argmax`` both return the first maximum;
``lax.top_k`` puts the lower index first among equal values, which a
stable descending sort reproduces (`_top_k`; ``torch.topk`` makes no such
promise).

The Switch load-balance loss, ``mean(top1) . mean(probs) * E^2 *
aux_loss_weight``, is `MoEMLP.forward`'s second output: the GPT block
returns it beside its activations (through a remat checkpoint too) and
`models.gpt.GPT` keeps it in ``intermediates`` for
`collect_moe_aux_loss`.

Over a mesh (``MoEMLP.mesh``: the model config's ``mesh``, which
`auto_accelerate` sets under every mesh strategy) the layer computes JAX's global semantics, which GSPMD gives the JAX package
over the global token axis:

- Where the tokens are sharded (the batch over dp x fsdp, the sequence
  over sp), the router's float32 probabilities of every token rank are
  gathered (no gradient, N x E floats) and the gating decides over the
  global flattened (B, T) order: the capacity from the global token
  count N, each expert's queue counted in token order b * T + t.  The
  rank keeps its own rows of ``combine`` and ``dispatch``, built from its
  own probabilities, so a router gradient stays with its token.  Each
  slot holds one token, so the rank keeps only the slots its own tokens
  fill: each expert's queue compacted, in queue order, to this rank's
  entries (``C_local`` = the most any expert holds of them, read on the
  host), and the experts run on (E, C_local) slots, not the global C.
  The buffers and the expert products are then those of the rank's own
  tokens, as on one device.  The aux
  loss's value is the product of global means; its gradient is this
  rank's share, which the data ranks' gradient mean sums to the global
  one (`_global_aux`).
- Over ``ep`` the tokens are replicated, as in JAX (`ep` is no batch
  dim), and each rank holds E / ep experts (a DTensor over ``ep``).
  Every ep rank computes the dispatch of all experts' slots, runs its
  own experts on its slice (`_TakeSlice`), and gathers every rank's
  outputs before the combine (`_GatherSlices`): the combine is JAX's sum
  over all experts, and each ep rank holds the whole gradient of every
  parameter but the experts, whose gradient is its own slice's.
  ``impl="grouped"`` over ep > 1 raises.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.fsdp import is_dtensor
from ..parallel.sharding import gather_tokens, mesh_sizes, tokens_sharded
from .fp8 import Dense


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    # "capacity": GShard dense dispatch (drops overflow tokens)
    # "grouped": dropless sort + grouped product
    impl: str = "capacity"


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, the lower index
    first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_gating(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(combine (T, E, C) float32, dispatch bool (T, E, C)) for (T, E)
    router logits: each token's top-k experts picked one at a time (the
    chosen ones masked with -inf), its place in each expert's queue
    counted over the tokens, tokens beyond `capacity` dropped, and each
    token's kept gates renormalized to sum to one."""
    probs = torch.softmax(logits.float(), dim=-1)
    rows = torch.arange(probs.shape[0], device=probs.device)
    return _global_gating(probs, probs.detach(), rows, k, capacity)


def _ragged_dot(x: torch.Tensor, w: torch.Tensor,
                group_sizes: torch.Tensor) -> torch.Tensor:
    """``lax.ragged_dot``: rows of x in consecutive groups, group g times
    w[g].  On the card ``torch._grouped_mm``; on the CPU a loop."""
    if x.is_cuda:
        grouped_mm = getattr(torch, "_grouped_mm", None)
        if grouped_mm is None:
            raise RuntimeError("grouped MoE on CUDA needs torch._grouped_mm, "
                               f"which torch {torch.__version__} lacks")
        ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
        return grouped_mm(x, w, offs=ends)
    outs, start = [], 0
    for g, n in enumerate(group_sizes.tolist()):
        outs.append(x[start:start + n] @ w[g])
        start += n
    return torch.cat(outs)


def grouped_moe(tokens: torch.Tensor, probs: torch.Tensor,
                w_gate: torch.Tensor, w_in: torch.Tensor,
                w_down: torch.Tensor, top_k: int) -> torch.Tensor:
    """Dropless MoE: tokens (T, d), router softmax probs (T, E), SwiGLU
    experts w_gate/w_in (E, d, f) and w_down (E, f, d); returns (T, d)."""
    T, d = tokens.shape
    E = probs.shape[-1]
    gates, experts = _top_k(probs, top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_expert = experts.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    token_idx = order // top_k
    group_sizes = torch.bincount(flat_expert, minlength=E)
    xs = tokens[token_idx].to(w_in.dtype)
    h = F.silu(_ragged_dot(xs, w_gate, group_sizes)) * \
        _ragged_dot(xs, w_in, group_sizes)
    ys = _ragged_dot(h, w_down, group_sizes)
    flat_gates = gates.reshape(-1)[order].to(ys.dtype)
    out = torch.zeros((T, d), dtype=ys.dtype, device=ys.device)
    out.index_add_(0, token_idx, ys * flat_gates[:, None])
    return out.to(tokens.dtype)


class MoEMLP(nn.Module):
    """Router + E stacked SwiGLU experts.  Parameters at flax's paths:
    ``router.kernel`` (d, E) float32, ``experts_w_in`` and
    ``experts_w_gate`` (E, d, f), ``experts_w_down`` (E, f, d).
    ``forward(x)`` takes (B, T, d) and returns (out (B, T, d), aux)."""

    def __init__(self, hidden: int, ffn: int, moe: MoEConfig, device=None,
                 mesh=None):
        super().__init__()
        self.moe = moe
        E = moe.num_experts
        self.router = Dense(hidden, E, torch.float32, device, use_bias=False)
        self.experts_w_in = nn.Parameter(torch.empty((E, hidden, ffn),
                                                     device=device))
        self.experts_w_gate = nn.Parameter(torch.empty((E, hidden, ffn),
                                                       device=device))
        self.experts_w_down = nn.Parameter(torch.empty((E, ffn, hidden),
                                                       device=device))
        # the DeviceMesh the layer's tokens and experts are sharded over,
        # or None
        self.mesh = mesh

    def forward(self, x: torch.Tensor):
        cfg, mesh = self.moe, self.mesh
        B, T, d = x.shape
        E = cfg.num_experts
        n_tok = B * T
        tokens = x.reshape(n_tok, d)
        logits = self.router(tokens.float())
        probs = torch.softmax(logits, dim=-1)
        sharded = tokens_sharded(mesh)
        if sharded:
            probs_all, rows = gather_tokens(
                probs.detach().reshape(B, T, E), mesh)
        else:
            probs_all = probs.detach()
            rows = torch.arange(n_tok, device=probs.device)
        aux = _global_aux(probs, probs_all, E) * cfg.aux_loss_weight
        # over ep the stacks are DTensors: this rank's experts
        w_in, w_gate, w_out = (
            (p.to_local() if is_dtensor(p) else p).to(cfg.dtype)
            for p in (self.experts_w_in, self.experts_w_gate,
                      self.experts_w_down))
        group = None
        if mesh is not None and mesh_sizes(mesh)["ep"] > 1:
            group = mesh.get_group("ep")
        if cfg.impl == "grouped":
            if group is not None:
                raise NotImplementedError(
                    "grouped (dropless) MoE over ep > 1 is not ported: "
                    "use impl='capacity'")
            out = grouped_moe(tokens, probs, w_gate, w_in, w_out, cfg.top_k)
            return out.reshape(B, T, d), aux
        n_all = probs_all.shape[0]
        capacity = max(1, int(cfg.capacity_factor * n_all * cfg.top_k / E))
        # the gates from a softmax of their own, as JAX's top_k_gating
        # takes the logits: the router's gradient sums in its order
        combine, dispatch = _global_gating(
            torch.softmax(logits.float(), dim=-1), probs_all, rows,
            cfg.top_k, capacity, compact=sharded)
        slots = combine.shape[-1]
        xe = (dispatch.to(cfg.dtype).reshape(n_tok, E * slots).t()
              @ tokens.to(cfg.dtype)).reshape(E, slots, d)
        if group is not None:
            xe = _TakeSlice.apply(xe, group)
        h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_in)
        ye = torch.bmm(h, w_out)
        if group is not None:
            ye = _GatherSlices.apply(ye, group)
        out = combine.to(cfg.dtype).reshape(n_tok, E * slots) \
            @ ye.reshape(E * slots, d)
        return out.reshape(B, T, d), aux


def _global_gating(probs: torch.Tensor, probs_all: torch.Tensor,
                   rows: torch.Tensor, k: int, capacity: int,
                   compact: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`top_k_gating` decided over every token (`probs_all` (N, E) in the
    global order, no gradient) and kept for this rank's `rows`: (combine
    (n, E, C) float32 from this rank's `probs` (n, E), dispatch bool).
    With `compact`, C is the most slots any expert gives this rank's
    tokens, each expert's slots renumbered in queue order."""
    N, E = probs_all.shape
    n = probs.shape[0]
    dev = probs.device
    picks = []
    masked = probs_all
    fill = torch.zeros(E, dtype=torch.int64, device=dev)
    local = torch.arange(n, device=dev)
    for _ in range(k):
        choice = masked.argmax(-1)                               # (N,)
        onehot = F.one_hot(choice, E)                            # (N, E)
        pos = onehot.cumsum(0) - 1 + fill[None, :]
        fill = fill + onehot.sum(0)
        pos_tok = pos.gather(1, choice[:, None])[:, 0]
        mine, slot = choice[rows], pos_tok[rows]
        keep = slot < capacity
        gate = probs.gather(1, mine[:, None])[:, 0]
        picks.append((local[keep], mine[keep], slot[keep], gate[keep]))
        masked = masked.masked_fill(onehot > 0, -torch.inf)
    if compact:
        used = torch.zeros((E, capacity), dtype=torch.bool, device=dev)
        for _, e, c, _ in picks:
            used[e, c] = True
        renumber = used.cumsum(1) - 1
        capacity = max(1, int(used.sum(1).max()))
        picks = [(t, e, renumber[e, c], g) for t, e, c, g in picks]
    combine = torch.zeros((n, E, capacity), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((n, E, capacity), dtype=torch.bool, device=dev)
    for t, e, c, gate in picks:
        # each (token, expert) pair is taken once, so the sum JAX forms
        # over the k one-hot terms is this assignment
        combine[t, e, c] = gate
        dispatch[t, e, c] = gate > 0
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / torch.where(denom > 0, denom, torch.ones_like(denom))
    return combine, dispatch


def _global_aux(probs: torch.Tensor, probs_all: torch.Tensor,
                E: int) -> torch.Tensor:
    """The Switch loss ``mean(top1) . mean(probs) * E^2`` over every
    token (`probs_all`), with this rank's gradient: the global top-1
    share against the mean of this rank's `probs`, whose mean over the
    token ranks (the gradient mean of equal slices) is the global
    gradient."""
    top1 = F.one_hot(probs_all.argmax(-1), E).float().mean(0)
    local = (top1 * probs.mean(0)).sum() * E ** 2
    value = (top1 * probs_all.mean(0)).sum() * E ** 2
    return local + (value - local).detach()


class _TakeSlice(torch.autograd.Function):
    """This rank's chunk (dim 0) of a tensor every rank of `group` holds
    whole; the backward gathers every rank's chunk of the cotangent, so
    each rank gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.group = group
        return x.chunk(n, 0)[me].contiguous()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        n = dist.get_world_size(ctx.group)
        buf = torch.empty((n * g.shape[0], *g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        dist.all_gather_into_tensor(buf, g.contiguous(), group=ctx.group)
        return buf, None


class _GatherSlices(torch.autograd.Function):
    """Every rank's chunk concatenated on dim 0; the ranks compute the
    same loss from it, so the backward keeps this rank's chunk of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.slot = (n, me)
        buf = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(buf, x.contiguous(), group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        n, me = ctx.slot
        return g.chunk(n, 0)[me].contiguous(), None


def _aux_leaves(tree: Mapping):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _aux_leaves(val)
        elif key == "moe_aux_loss":
            yield val


def collect_moe_aux_loss(intermediates: Mapping) -> torch.Tensor:
    """Sum of the ``moe_aux_loss`` leaves of an intermediates tree (as
    `models.gpt.GPT.intermediates` holds it), in float32, in tree order;
    any other leaf is no loss term."""
    total = torch.zeros((), dtype=torch.float32)
    for leaf in _aux_leaves(intermediates):
        total = total.to(leaf.device) + leaf.float().sum()
    return total
