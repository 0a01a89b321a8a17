"""Autoregressive generation with a KV cache for the GPT family.

Parity: dlrover_wuqiong_tpu/rl/generation.py — `_ln` (:39), `_dense`
(:43), `_cached_block` (:47), `forward_step` (:91), `init_caches` (:121),
`sample_token` (:133) and `generate` (:162), over the same flax-layout
parameter tree and the same ``(B, max_len, H, D)`` cache layout.

This module is the one decode step of the port: the serving engine drives
`forward_step` with a vector of per-slot positions (continuous batching),
`generate` with a scalar position (all rows in lockstep).

Semantics kept from the JAX version, each a trap with torch defaults:

- LayerNorm is flax's: epsilon 1e-6, statistics in float32 with the fast
  variance ``E[x^2] - E[x]^2`` clipped at 0, scale and bias in float32.
- GELU is the tanh approximation (``jax.nn.gelu``'s default).
- Attention scores are in ``cfg.dtype``, divided by ``sqrt(D)`` rounded to
  ``cfg.dtype``, masked with ``finfo(dtype).min``; softmax runs in float32
  and is cast back.  The lm head is tied to ``wte``.

Two differences of form, neither of value:

- Caches are updated in place and returned.  The per-row write is an index
  scatter ``cache[arange(B), pos] = k`` where JAX writes through a one-hot
  ``jnp.where``; both store the new (k, v) at ``pos`` and nothing else.
- With a scalar ``pos`` a call may carry T > 1 tokens (a whole prompt):
  all T (k, v) are written first and query t attends positions
  ``<= pos + t``, which is what T one-token steps compute (write then
  attend).  Only the last token's logits are returned, as the JAX step
  returns its one token's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models.gpt import GPTConfig

Caches = List[Tuple[torch.Tensor, torch.Tensor]]

_LN_EPS = 1e-6


def _ln(p: Dict, x: torch.Tensor, dtype) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mu * mu, 0.0)
    mul = torch.rsqrt(var + _LN_EPS) * p["scale"].float()
    return ((xf - mu) * mul + p["bias"].float()).to(dtype)


def _dense(p: Dict, x: torch.Tensor, dtype) -> torch.Tensor:
    return x @ p["kernel"].to(dtype) + p["bias"].to(dtype)


def _attn_mask(pos: Union[int, torch.Tensor], T: int, L: int,
               device) -> torch.Tensor:
    """True where a query may attend: key position <= query position.
    (1, 1, T, L) for an int `pos`, (B, 1, 1, L) for per-row positions."""
    keys = torch.arange(L, device=device)
    if isinstance(pos, int):
        qpos = pos + torch.arange(T, device=device)
        return (keys[None, :] <= qpos[:, None])[None, None]
    return (keys[None, :] <= pos[:, None])[:, None, None]


@functools.lru_cache(maxsize=None)
def _sqrt_d(D: int, dtype: torch.dtype) -> float:
    """sqrt(D) computed in float32 and rounded to `dtype`, as JAX does."""
    return float(torch.tensor(math.sqrt(D), dtype=torch.float32).to(dtype))


def _cached_block(cfg: GPTConfig, p: Dict, x: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: Union[int, torch.Tensor], mask: torch.Tensor):
    """One decoder block over T new tokens with a KV cache.

    x: (B, T, C); cache_k/v: (B, max_len, H, D), written in place; pos: an
    int (token t sits at ``pos + t``) or a (B,) long tensor (T == 1, one
    position per row); mask: `_attn_mask` of pos, shared by all layers.
    Returns (y, cache_k, cache_v).
    """
    B, T, _ = x.shape
    H, D = cfg.n_head, cfg.head_dim
    dtype = cfg.dtype
    h = _ln(p["ln_1"], x, dtype)
    qkv = _dense(p["attn"]["c_attn"], h, dtype)          # (B, T, 3C)
    q, k, v = qkv.split(H * D, dim=-1)
    q = q.reshape(B, T, H, D)
    k = k.reshape(B, T, H, D)
    v = v.reshape(B, T, H, D)
    if isinstance(pos, int):
        cache_k[:, pos:pos + T] = k
        cache_v[:, pos:pos + T] = v
    else:
        rows = torch.arange(B, device=x.device)
        cache_k[rows, pos] = k[:, 0]
        cache_v[rows, pos] = v[:, 0]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, cache_k) / _sqrt_d(D, dtype)
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    att = torch.softmax(scores.float(), dim=-1).to(dtype)
    y = torch.einsum("bhqk,bkhd->bqhd", att, cache_v).reshape(B, T, H * D)
    y = _dense(p["attn"]["c_proj"], y, dtype)
    x = x + y
    h = _ln(p["ln_2"], x, dtype)
    h = _dense(p["mlp"]["c_fc"], h, dtype)
    h = F.gelu(h, approximate="tanh")
    h = _dense(p["mlp"]["c_proj"], h, dtype)
    return x + h, cache_k, cache_v


def forward_step(cfg: GPTConfig, params: Dict, token: torch.Tensor,
                 caches: Caches, pos: Union[int, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Caches]:
    """token (B, T) long -> logits (B, vocab) of the last token; writes
    every layer's cache in place.

    ``pos`` is an int (lockstep rows; T tokens at ``pos .. pos+T-1``) or a
    (B,) long tensor of per-row positions (T must be 1).
    """
    dtype = cfg.dtype
    T = token.shape[1]
    tok = params["wte"]["embedding"][token].to(dtype)            # (B, T, C)
    if isinstance(pos, int):
        pe = params["wpe"]["embedding"][pos:pos + T][None].to(dtype)
    else:
        if T != 1:
            raise ValueError("per-row positions take one token per row")
        pe = params["wpe"]["embedding"][pos][:, None].to(dtype)
    x = tok + pe
    mask = _attn_mask(pos, T, caches[0][0].shape[1], x.device)
    for i in range(cfg.n_layer):
        ck, cv = caches[i]
        x, _, _ = _cached_block(cfg, params[f"h_{i}"], x, ck, cv, pos, mask)
    x = _ln(params["ln_f"], x[:, -1], dtype)
    logits = x @ params["wte"]["embedding"].to(dtype).t()
    return logits, caches


def init_caches(cfg: GPTConfig, batch: int, max_len: int,
                dtype: Optional[torch.dtype] = None, device=None) -> Caches:
    """Zeroed per-layer (k, v) buffers: list of (B, max_len, H, D) pairs
    on `device` (default ``cuda``)."""
    device = resolve_device(device)
    dtype = dtype if dtype is not None else cfg.dtype
    shape = (batch, max_len, cfg.n_head, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layer)]


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float = 1.0, top_k: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sampled token per row + its log-probability.

    temperature <= 0 means greedy argmax (the generator is unused).  The
    sampled branch is Gumbel-max over noise drawn from `generator` (JAX's
    threefry bits cannot be reproduced, so only the distribution matches).
    """
    logits = logits.float()
    if temperature > 0:
        logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if temperature > 0:
        noise = _gumbel(logits.shape, generator, logits.device)
        tok = torch.argmax(logits + noise, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    return tok, logp.gather(1, tok[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: int = 0           # 0 = full softmax
    eos_token: int = -1      # -1 = never stop early


@torch.no_grad()
def generate(cfg: GPTConfig, params: Dict, prompt: torch.Tensor,
             generator: Optional[torch.Generator],
             sample: SampleConfig = SampleConfig()
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample continuations. prompt (B, P) long -> (tokens (B, P+N),
    logprobs (B, N)).  Deterministic for a generator in the same state.
    The prompt is prefilled in one call (T = P), then N one-token steps.
    """
    B, P = prompt.shape
    N = sample.max_new_tokens
    total = P + N
    if total > cfg.block_size:
        raise ValueError(f"prompt+new ({total}) exceeds block size "
                         f"{cfg.block_size}")
    caches = init_caches(cfg, B, total, device=prompt.device)
    logits, caches = forward_step(cfg, params, prompt, caches, 0)
    toks, logps = [], []
    for i in range(N):
        tok, logp = sample_token(logits, generator, sample.temperature,
                                 sample.top_k)
        toks.append(tok)
        logps.append(logp)
        logits, caches = forward_step(cfg, params, tok[:, None], caches,
                                      P + i)
    tokens = torch.cat([prompt, torch.stack(toks, 1).to(prompt.dtype)], 1)
    return tokens, torch.stack(logps, 1)
