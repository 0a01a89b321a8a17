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
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
    T, E = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    combine = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((T, E, capacity), dtype=torch.bool, device=dev)
    masked = probs
    fill = torch.zeros(E, dtype=torch.int64, device=dev)
    rows = torch.arange(T, device=dev)
    for _ in range(k):
        choice = masked.argmax(-1)                               # (T,)
        onehot = F.one_hot(choice, E)                            # (T, E)
        pos = onehot.cumsum(0) - 1 + fill[None, :]
        fill = fill + onehot.sum(0)
        pos_tok = pos.gather(1, choice[:, None])[:, 0]
        keep = pos_tok < capacity
        gate = probs.gather(1, choice[:, None])[:, 0]
        t, e, c = rows[keep], choice[keep], pos_tok[keep]
        # each (token, expert) pair is taken once, so the sum JAX forms
        # over the k one-hot terms is this assignment
        combine[t, e, c] = gate[keep]
        dispatch[t, e, c] = gate[keep] > 0
        masked = masked.masked_fill(onehot > 0, -torch.inf)
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / torch.where(denom > 0, denom, torch.ones_like(denom))
    return combine, dispatch


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

    def __init__(self, hidden: int, ffn: int, moe: MoEConfig, device=None):
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

    def forward(self, x: torch.Tensor):
        cfg = self.moe
        B, T, d = x.shape
        E = cfg.num_experts
        n_tok = B * T
        tokens = x.reshape(n_tok, d)
        capacity = max(1, int(cfg.capacity_factor * n_tok * cfg.top_k / E))
        logits = self.router(tokens.float())
        w_in = self.experts_w_in.to(cfg.dtype)
        w_gate = self.experts_w_gate.to(cfg.dtype)
        w_out = self.experts_w_down.to(cfg.dtype)
        probs = torch.softmax(logits, dim=-1)
        top1 = F.one_hot(probs.argmax(-1), E).float()
        aux = (top1.mean(0) * probs.mean(0)).sum() * E ** 2 \
            * cfg.aux_loss_weight
        if cfg.impl == "grouped":
            out = grouped_moe(tokens, probs, w_gate, w_in, w_out, cfg.top_k)
            return out.reshape(B, T, d), aux
        combine, dispatch = top_k_gating(logits, cfg.top_k, capacity)
        xe = (dispatch.to(cfg.dtype).reshape(n_tok, E * capacity).t()
              @ tokens.to(cfg.dtype)).reshape(E, capacity, d)
        h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_in)
        ye = torch.bmm(h, w_out)
        out = combine.to(cfg.dtype).reshape(n_tok, E * capacity) \
            @ ye.reshape(E * capacity, d)
        return out.reshape(B, T, d), aux


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
