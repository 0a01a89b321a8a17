"""GPT-2 family: configuration, seeded init, the training module and its loss.

Parity: dlrover_wuqiong_tpu/models/gpt.py — `GPTConfig` and presets
(:23-82), `CausalSelfAttention` (:85), `MLP` (:118), `Block` (:133), `GPT`
(:158, `init_params` :204) and `cross_entropy_loss` (:209-252).

Parameters are named as flax names them, so a flax tree loads by path
(``convert.load_params``): ``wte.embedding``, ``h_<i>.attn.c_attn.kernel``,
``h_<i>.ln_1.scale``, ``ln_f.bias``, ...  Dense kernels are kept ``(in,
out)``: the int8 serving store quantizes the flattened row-major kernel in
256-element blocks, so a transposed kernel would get other blocks and
other numbers.  Master parameters are float32; compute runs in
``cfg.dtype``.  `init_params` gives the same tree as a nested dict (the
serving engine's input).

`GPT(cfg)` is a definition, as the flax module is: its parameters live on
the ``meta`` device until `GPT.init_params` (seeded flax init) or
``convert.load_params`` (a given tree) puts them on a device.

Traps kept from flax/JAX: LayerNorm has epsilon 1e-6 and float32 fast
variance (`rl/generation._ln`); ``jax.nn.gelu`` is the tanh approximation;
the tied head multiplies by ``wte`` cast to ``cfg.dtype``; the einsum
attention branch divides by ``sqrt(head_dim)`` rounded to ``cfg.dtype`` and
masks with ``finfo.min``.  One difference of rounding, not of value: the
token embedding gathers float32 rows and casts them, so its gradient
accumulates in float32 where flax's scatter-adds in ``cfg.dtype``.

Not ported, raising at build: ``dropout > 0``, ``moe_experts > 0``,
``fp8`` and remat policies other than "full" (ROADMAP).  Without a mesh,
"ring" and "ulysses" run the flash route, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # GPT-2's 50257 padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024
    dropout: float = 0.0
    # compute dtype; on a CUDA device the flash route's attention runs in
    # bfloat16 whatever it says (models/attention.py, the dtype contract)
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"
    use_flash_attention: bool = True
    attn_impl: str = "flash"  # "flash" | "ring" | "ulysses"
    fp8: bool = False
    moe_experts: int = 0

    @classmethod
    def nano(cls):  # tiny config for tests
        return cls(vocab_size=512, n_layer=2, n_head=2, n_embd=128,
                   block_size=128)

    @classmethod
    def gpt2(cls):
        return cls(n_layer=12, n_head=12, n_embd=768)

    @classmethod
    def gpt2_medium(cls):
        return cls(n_layer=24, n_head=16, n_embd=1024)

    @classmethod
    def gpt2_large(cls):
        return cls(n_layer=36, n_head=20, n_embd=1280)

    @classmethod
    def gpt2_xl(cls):  # 1.5B
        return cls(n_layer=48, n_head=25, n_embd=1600)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def num_params(self) -> int:
        wte = self.vocab_size * self.n_embd
        wpe = self.block_size * self.n_embd
        per_layer = 12 * self.n_embd * self.n_embd + 13 * self.n_embd
        return wte + wpe + self.n_layer * per_layer + 2 * self.n_embd


# flax's lecun_normal draws a [-2, 2] truncated normal and divides the
# stddev by the truncated distribution's own stddev
_TRUNC_STD = 0.87962566103423978


def _dense(fan_in: int, fan_out: int, gen, device,
           use_bias: bool = True) -> Dict[str, torch.Tensor]:
    """flax Dense init: a lecun-normal (in, out) kernel and, with
    `use_bias`, a zero bias."""
    kernel = torch.empty((fan_in, fan_out), device=device)
    torch.nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=gen)
    kernel.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
    if not use_bias:
        return {"kernel": kernel}
    return {"kernel": kernel, "bias": torch.zeros(fan_out, device=device)}


def _layer_norm(n: int, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(n, device=device),
            "bias": torch.zeros(n, device=device)}


def _embed(num: int, features: int, gen, device) -> Dict[str, torch.Tensor]:
    # flax Embed default: variance_scaling(1, "fan_in", "normal",
    # out_axis=0), whose fan_in for a (num, features) table is `features`
    emb = torch.randn((num, features), generator=gen, device=device)
    return {"embedding": emb.mul_(math.sqrt(1.0 / features))}


@torch.no_grad()
def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> Dict:
    """Seeded float32 parameters in the flax tree layout, made on `device`
    (default ``cuda``) with flax's initializers: lecun-normal Dense kernels,
    zero biases, LayerNorm scale 1 and bias 0, flax Embed's normal."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    C = cfg.n_embd
    params: Dict = {
        "wte": _embed(cfg.vocab_size, C, gen, device),
        "wpe": _embed(cfg.block_size, C, gen, device),
    }
    for i in range(cfg.n_layer):
        params[f"h_{i}"] = {
            "ln_1": _layer_norm(C, device),
            "attn": {"c_attn": _dense(C, 3 * C, gen, device),
                     "c_proj": _dense(C, C, gen, device)},
            "ln_2": _layer_norm(C, device),
            "mlp": {"c_fc": _dense(C, 4 * C, gen, device),
                    "c_proj": _dense(4 * C, C, gen, device)},
        }
    params["ln_f"] = _layer_norm(C, device)
    return params


# ------------------------------------------------------------ modules


class Embed(nn.Module):
    """flax ``nn.Embed``: a float32 ``embedding`` table, rows cast to
    `dtype` on lookup."""

    def __init__(self, num: int, features: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty((num, features),
                                                  device=device))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.embedding).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: epsilon 1e-6, float32 fast
    variance, float32 ``scale`` and ``bias``."""

    def __init__(self, features: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..rl.generation import _ln

        return _ln({"scale": self.scale, "bias": self.bias}, x, self.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        from .fp8 import dense

        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.c_attn = dense(cfg, C, 3 * C, "c_attn", device=device)
        self.c_proj = dense(cfg, C, C, "c_proj", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, C = x.shape
        H, D = cfg.n_head, cfg.head_dim
        q, k, v = self.c_attn(x).split(C, dim=-1)
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, H, D)
        v = v.reshape(B, T, H, D)
        if cfg.use_flash_attention:
            from .attention import attend

            y = attend(q, k, v, cfg, causal=True)
        else:
            from ..rl.generation import _sqrt_d

            att = torch.einsum("bqhd,bkhd->bhqk", q, k) / _sqrt_d(D, q.dtype)
            mask = torch.ones((T, T), dtype=torch.bool,
                              device=x.device).tril()
            att = att.masked_fill(~mask, torch.finfo(att.dtype).min)
            att = torch.softmax(att.float(), dim=-1).to(q.dtype)
            y = torch.einsum("bhqk,bkhd->bqhd", att, v)
        return self.c_proj(y.reshape(B, T, C))


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        from .fp8 import dense

        super().__init__()
        C = cfg.n_embd
        self.c_fc = dense(cfg, C, 4 * C, "c_fc", device=device)
        self.c_proj = dense(cfg, 4 * C, C, "c_proj", device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


def _check_ported(cfg: GPTConfig) -> None:
    if cfg.dropout > 0:
        raise NotImplementedError("dropout > 0 is not ported yet (ROADMAP "
                                  "queue 1 item 3)")
    if cfg.moe_experts:
        raise NotImplementedError("MoE blocks (moe_experts > 0) are not "
                                  "ported yet (ROADMAP queue 1 item 10)")
    if cfg.fp8:
        raise NotImplementedError("fp8 projections are not ported yet "
                                  "(ROADMAP queue 1 item 3)")
    if cfg.remat:
        from ..ops.remat import resolve_remat_policy

        resolve_remat_policy(cfg.remat_policy)


class GPT(nn.Module):
    """GPT-2 with a tied lm head.  ``forward(idx)`` takes (B, T) token ids
    and returns (B, T, vocab) logits in ``cfg.dtype``."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        _check_ported(cfg)
        self.config = cfg
        meta = torch.device("meta")
        self.wte = Embed(cfg.vocab_size, cfg.n_embd, cfg.dtype, meta)
        self.wpe = Embed(cfg.block_size, cfg.n_embd, cfg.dtype, meta)
        for i in range(cfg.n_layer):
            setattr(self, f"h_{i}", Block(cfg, meta))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.dtype, meta)

    def init_params(self, seed: int = 0, device=None) -> "GPT":
        """Seeded flax-layout init (`init_params`) on `device` (default
        ``cuda``); returns self."""
        from ..convert import load_params

        return load_params(self, init_params(self.config, seed, device),
                           device)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        T = idx.shape[1]
        x = self.wte(idx) + self.wpe.embedding[:T].to(cfg.dtype)[None]
        blocks = [getattr(self, f"h_{i}") for i in range(cfg.n_layer)]
        if cfg.remat:
            from ..ops.remat import resolve_remat_policy, trace_remat_policy

            wrap = resolve_remat_policy(trace_remat_policy(cfg.remat_policy))
            blocks = [functools.partial(wrap, b) for b in blocks]
        for block in blocks:
            x = block(x)
        x = self.ln_f(x)
        return x @ self.wte.embedding.to(cfg.dtype).t()


# ------------------------------------------------------------ loss

# rows of logits per chunk of the loss: a float32 (rows, vocab) temporary
# of at most 256 MiB (1334 rows at vocab 50304)
_CE_CHUNK_BYTES = 1 << 28


def _ce_rows(vocab: int) -> int:
    return max(1, _CE_CHUNK_BYTES // (4 * vocab))


class _CrossEntropy(torch.autograd.Function):
    """Mean token cross-entropy over non-ignored targets, f32 math over
    the logits' dtype.  Neither pass holds a float32 (B, T, V) tensor:
    both work over row chunks, and the backward writes
    ``(softmax - onehot) * scale`` straight into a logits-dtype buffer
    (parity: `_ce_fwd` :228, `_ce_bwd` :242)."""

    @staticmethod
    def forward(ctx, logits, targets, ignore_index):
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        tgt = targets.reshape(-1)
        valid = tgt != ignore_index
        safe = torch.where(valid, tgt, 0)
        lse = torch.empty(flat.shape[0], dtype=torch.float32,
                          device=logits.device)
        step = _ce_rows(V)
        for r in range(0, flat.shape[0], step):
            lse[r:r + step] = torch.logsumexp(flat[r:r + step].float(), -1)
        tl = flat.gather(1, safe[:, None])[:, 0].float()
        n_valid = valid.sum().clamp_min(1)
        loss = ((lse - tl) * valid).sum() / n_valid
        ctx.save_for_backward(logits, safe, valid, lse, n_valid)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, safe, valid, lse, n_valid = ctx.saved_tensors
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        scale = (g * valid / n_valid).float()
        out = torch.empty_like(flat)
        step = _ce_rows(V)
        for r in range(0, flat.shape[0], step):
            p = torch.exp(flat[r:r + step].float() - lse[r:r + step, None])
            p.scatter_add_(1, safe[r:r + step, None],
                           torch.full_like(p[:, :1], -1.0))
            out[r:r + step] = p * scale[r:r + step, None]
        return out.reshape(logits.shape), None, None


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = -1) -> torch.Tensor:
    """Token cross-entropy (scalar float32) of (B, T, V) logits against
    (B, T) targets; targets equal to `ignore_index` do not count."""
    return _CrossEntropy.apply(logits, targets, ignore_index)
