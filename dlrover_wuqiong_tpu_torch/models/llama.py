"""Llama family (RMSNorm, RoPE, SwiGLU, GQA): configuration, seeded init and
the training module.

Parity: dlrover_wuqiong_tpu/models/llama.py — `LlamaConfig` and presets
(:21-69), `RMSNorm` (:71), `rope_freqs` (:84), `apply_rope` (:92),
`LlamaAttention` (:106), `LlamaMLP` (:144), `LlamaBlock` (:159) and `Llama`
(:176).  The loss is GPT's `cross_entropy_loss`, as in the JAX package.

Parameters are named as flax names them, so a flax tree loads by path
(``convert.load_params``): ``embed_tokens.embedding``,
``layers_<i>.attention.q_proj.kernel``, ``layers_<i>.feed_forward.
gate_proj.kernel``, ``layers_<i>.input_norm.scale``,
``layers_<i>.post_attn_norm.scale``, ``norm.scale``, ``lm_head.kernel``.
No projection has a bias, and the head is not tied to the embedding.
Master parameters are float32; compute runs in ``cfg.dtype``.  `Llama(cfg)`
is a definition whose parameters live on the ``meta`` device until
`Llama.init_params` or ``convert.load_params`` puts them on a device.

Traps kept from flax/JAX: the RoPE table is computed in float32 (a
float64 ``inv`` differs by an ulp, which a position of 8191 turns into a
visible phase error); RoPE rotates halves of the head (``x[:d/2]`` with
``x[d/2:]``), not interleaved pairs; GQA repeats each kv head in place
(``jnp.repeat`` on the head axis is ``repeat_interleave``, not
``.repeat``); the einsum branch divides the float32 scores by the float32
``sqrt(head_dim)`` and masks with ``-inf`` (GPT's masks with
``finfo.min``).

Not ported, raising at build: ``fp8`` and remat policies other than
"full" (ROADMAP queue 1 item 3); the JAX fields ``remat_names`` and
``fp8_filter`` come back with them.  "ring" and "ulysses" over a mesh raise
in `models.attention.attend`; without a mesh they run the flash route.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .gpt import Embed, _dense, _embed


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    # compute dtype; on a CUDA device the flash route's attention runs in
    # bfloat16 whatever it says (models/attention.py, the dtype contract)
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"
    use_flash_attention: bool = True
    attn_impl: str = "flash"  # "flash" | "ring" | "ulysses"
    mesh: Any = None
    fp8: bool = False

    @classmethod
    def nano(cls):
        return cls(vocab_size=512, hidden_size=128, intermediate_size=256,
                   num_layers=2, num_heads=4, num_kv_heads=2,
                   max_seq_len=128)

    @classmethod
    def llama3_8b(cls):
        return cls()  # defaults are 8B

    @classmethod
    def llama3_70b(cls):
        return cls(hidden_size=8192, intermediate_size=28672, num_layers=80,
                   num_heads=64, num_kv_heads=8)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, i = self.hidden_size, self.intermediate_size
        kv = self.num_kv_heads * self.head_dim
        per_layer = h * h + 2 * h * kv + h * h + 3 * h * i + 2 * h
        return (2 * self.vocab_size * h + self.num_layers * per_layer + h)


@torch.no_grad()
def init_params(cfg: LlamaConfig, seed: int = 0, device=None) -> Dict:
    """Seeded float32 parameters in the flax tree layout, made on `device`
    (default ``cuda``) with flax's initializers: lecun-normal Dense kernels
    and no biases, RMSNorm scale 1, flax Embed's normal."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    h, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    kv = cfg.num_kv_heads * hd
    dense = functools.partial(_dense, gen=gen, device=device, use_bias=False)
    ones = lambda: {"scale": torch.ones(h, device=device)}
    params: Dict = {"embed_tokens": _embed(cfg.vocab_size, h, gen, device)}
    for n in range(cfg.num_layers):
        params[f"layers_{n}"] = {
            "input_norm": ones(),
            "attention": {"q_proj": dense(h, cfg.num_heads * hd),
                          "k_proj": dense(h, kv), "v_proj": dense(h, kv),
                          "o_proj": dense(cfg.num_heads * hd, h)},
            "post_attn_norm": ones(),
            "feed_forward": {"gate_proj": dense(h, i),
                             "up_proj": dense(h, i),
                             "down_proj": dense(i, h)},
        }
    params["norm"] = ones()
    params["lm_head"] = dense(h, cfg.vocab_size)
    return params


# ------------------------------------------------------------ functions


def rope_freqs(head_dim: int, max_seq: int, theta: float, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (max_seq, head_dim / 2) cos and sin of ``t * inv`` with
    ``inv = 1 / theta ** (arange(0, head_dim, 2) / head_dim)``, all in
    float32 (`:84-89`)."""
    f32 = torch.float32
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=f32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=f32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (b, s, h, d) rotated by halves: ``[x1 c - x2 s, x2 c + x1 s]`` with
    ``x1, x2 = x[..., :d/2], x[..., d/2:]``, in float32, cast back.  The
    angles are rows ``0..s-1`` of the table, or ``positions`` (b, s)."""
    s = x.shape[1]
    if positions is None:
        c, si = cos[:s][None, :, None, :], sin[:s][None, :, None, :]
    else:
        c, si = cos[positions][:, :, None, :], sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * si, x2 * c + x1 * si], -1).to(x.dtype)


# ------------------------------------------------------------ modules


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32 over a float32
    ``scale``, cast to `dtype`."""

    def __init__(self, features: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                 + self.eps)
        return (norm * self.scale).to(self.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        from .fp8 import dense

        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        kv = cfg.num_kv_heads * hd
        self.q_proj = dense(cfg, h, cfg.num_heads * hd, "q_proj", device,
                            use_bias=False)
        self.k_proj = dense(cfg, h, kv, "k_proj", device, use_bias=False)
        self.v_proj = dense(cfg, h, kv, "v_proj", device, use_bias=False)
        self.o_proj = dense(cfg, cfg.num_heads * hd, h, "o_proj", device,
                            use_bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = apply_rope(self.q_proj(x).reshape(B, T, H, hd), cos, sin)
        k = apply_rope(self.k_proj(x).reshape(B, T, KV, hd), cos, sin)
        v = self.v_proj(x).reshape(B, T, KV, hd)
        rep = H // KV
        if rep > 1:  # GQA: each kv head serves `rep` consecutive q heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if cfg.use_flash_attention:
            from .attention import attend

            y = attend(q, k, v, cfg, causal=True)
        else:
            # divide by a device tensor: a Python float divisor is a
            # reciprocal multiply on CUDA, not IEEE division
            sqrt_d = torch.full((), hd, dtype=torch.float32,
                                device=x.device).sqrt()
            att = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / sqrt_d
            mask = torch.ones((T, T), dtype=torch.bool,
                              device=x.device).tril()
            att = att.masked_fill(~mask, -math.inf)
            att = torch.softmax(att, dim=-1).to(cfg.dtype)
            y = torch.einsum("bhqk,bkhd->bqhd", att, v)
        return self.o_proj(y.reshape(B, T, H * hd))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        from .fp8 import dense

        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = dense(cfg, h, i, "gate_proj", device, use_bias=False)
        self.up_proj = dense(cfg, h, i, "up_proj", device, use_bias=False)
        self.down_proj = dense(cfg, i, h, "down_proj", device, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.input_norm = RMSNorm(h, cfg.rms_eps, cfg.dtype, device)
        self.attention = LlamaAttention(cfg, device)
        self.post_attn_norm = RMSNorm(h, cfg.rms_eps, cfg.dtype, device)
        self.feed_forward = LlamaMLP(cfg, device)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.input_norm(x), cos, sin)
        return x + self.feed_forward(self.post_attn_norm(x))


def _check_ported(cfg: LlamaConfig) -> None:
    if cfg.fp8:
        raise NotImplementedError("fp8 projections are not ported yet "
                                  "(ROADMAP queue 1 item 3)")
    if cfg.remat:
        from ..ops.remat import resolve_remat_policy

        resolve_remat_policy(cfg.remat_policy)


class Llama(nn.Module):
    """Llama with an untied lm head.  ``forward(idx)`` takes (B, T) token
    ids, T <= ``max_seq_len``, and returns (B, T, vocab) logits in
    ``cfg.dtype``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        from .fp8 import Dense

        _check_ported(cfg)
        self.config = cfg
        meta = torch.device("meta")
        h = cfg.hidden_size
        self.embed_tokens = Embed(cfg.vocab_size, h, cfg.dtype, meta)
        for i in range(cfg.num_layers):
            setattr(self, f"layers_{i}", LlamaBlock(cfg, meta))
        self.norm = RMSNorm(h, cfg.rms_eps, cfg.dtype, meta)
        self.lm_head = Dense(h, cfg.vocab_size, cfg.dtype, meta,
                             use_bias=False)

    def init_params(self, seed: int = 0, device=None) -> "Llama":
        """Seeded flax-layout init (`init_params`) on `device` (default
        ``cuda``); returns self."""
        from ..convert import load_params

        return load_params(self, init_params(self.config, seed, device),
                           device)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.embed_tokens(idx)
        cos, sin = rope_freqs(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                              idx.device)
        blocks = [getattr(self, f"layers_{i}") for i in range(cfg.num_layers)]
        if cfg.remat:
            from ..ops.remat import resolve_remat_policy, trace_remat_policy

            wrap = resolve_remat_policy(trace_remat_policy(cfg.remat_policy))
            blocks = [functools.partial(wrap, b) for b in blocks]
        for block in blocks:
            x = block(x, cos, sin)
        return self.lm_head(self.norm(x))
