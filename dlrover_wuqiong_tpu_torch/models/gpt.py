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

The model knobs of the JAX config: ``fp8`` with ``fp8_filter`` (the
name-filtered projections as `models.fp8.Fp8Dense`), the five remat
policies with ``remat_names`` (`ops.remat`; each block anchors
``attn_out`` and ``mlp_out`` as JAX's `Block` does), ``dropout`` after
each ``c_proj`` (active only with ``deterministic=False``, which no train
path passes, as in the JAX package), and ``moe_experts`` with
``moe_top_k`` and ``moe_capacity_factor`` (the block's MLP becomes
`models.moe.MoEMLP`, named ``moe_mlp``; its aux loss lands in
`GPT.intermediates`, where `trainer.train_step.make_lm_loss` adds it).
Without a mesh, "ring" and "ulysses" run the flash route, as in the JAX
package; with one (sequence parallel, `parallel.long_context`) each rank
holds chunk r of the sequence, so its positions start at r * T / sp.

Dropout keeps flax's semantics (keep with probability ``1 - rate``, kept
values scaled by ``1 / (1 - rate)``, zeros at rate 1), but its masks come
from torch's generator, not JAX's bits.  `GPT.forward` draws one seed a
block from the caller's `generator` outside any checkpoint, and the block
draws its masks from a generator seeded with it, so a remat recompute
draws the same masks (``torch.utils.checkpoint`` restores the global RNG
states, not a caller's generator).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .attention import local_heads


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
    # ops/remat.py: "full" | "dots" | "offload_dots" | "save_names" |
    # "offload_names"
    remat_policy: str = "full"
    # checkpoint_name anchors for the *_names policies; () = the models'
    # ("attn_out", "mlp_out")
    remat_names: tuple = ()
    use_flash_attention: bool = True
    # "flash" | "ring" | "ulysses" | "gspmd" (parallel/long_context.py)
    attn_impl: str = "flash"
    mesh: Any = None  # the DeviceMesh of a mesh strategy (auto_accelerate)
    # fp8 products on the name-filtered projections (models/fp8.py)
    fp8: bool = False
    fp8_filter: tuple = ("c_attn", "c_proj", "c_fc")
    # MoE: 0 experts = dense MLP (models/moe.py)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

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


def _moe(cfg: GPTConfig, gen, device) -> Dict[str, torch.Tensor]:
    """`models.moe.MoEMLP`'s leaves: a lecun-normal (d, E) router kernel
    and normal(0.02) expert stacks."""
    C, E = cfg.n_embd, cfg.moe_experts
    out = {"router": _dense(C, E, gen, device, use_bias=False)}
    for name, shape in (("experts_w_in", (E, C, 4 * C)),
                        ("experts_w_gate", (E, C, 4 * C)),
                        ("experts_w_down", (E, 4 * C, C))):
        w = torch.randn(shape, generator=gen, device=device)
        out[name] = w.mul_(0.02)
    return out


def _embed(num: int, features: int, gen, device) -> Dict[str, torch.Tensor]:
    # flax Embed default: variance_scaling(1, "fan_in", "normal",
    # out_axis=0), whose fan_in for a (num, features) table is `features`
    emb = torch.randn((num, features), generator=gen, device=device)
    return {"embedding": emb.mul_(math.sqrt(1.0 / features))}


def _leaves(prefix: str, tree: Dict):
    """(dotted name, tensor) of a nested dict's leaves, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(f"{prefix}{k}.", v)
        else:
            yield prefix + k, v


@torch.no_grad()
def init_leaves(cfg: GPTConfig, seed: int = 0, device=None):
    """`init_params`'s leaves one module at a time, as (dotted name,
    tensor) in the order the generator draws them: a sharded build keeps
    each rank's piece of a leaf and frees the rest before the next."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    C = cfg.n_embd
    yield from _leaves("wte.", _embed(cfg.vocab_size, C, gen, device))
    yield from _leaves("wpe.", _embed(cfg.block_size, C, gen, device))
    for i in range(cfg.n_layer):
        h = f"h_{i}."
        yield from _leaves(h + "ln_1.", _layer_norm(C, device))
        yield from _leaves(h + "attn.c_attn.", _dense(C, 3 * C, gen, device))
        yield from _leaves(h + "attn.c_proj.", _dense(C, C, gen, device))
        yield from _leaves(h + "ln_2.", _layer_norm(C, device))
        if cfg.moe_experts:
            yield from _leaves(h + "moe_mlp.", _moe(cfg, gen, device))
        else:
            yield from _leaves(h + "mlp.c_fc.", _dense(C, 4 * C, gen, device))
            yield from _leaves(h + "mlp.c_proj.",
                               _dense(4 * C, C, gen, device))
    yield from _leaves("ln_f.", _layer_norm(C, device))


def init_params(cfg: GPTConfig, seed: int = 0, device=None) -> Dict:
    """Seeded float32 parameters in the flax tree layout, made on `device`
    (default ``cuda``) with flax's initializers: lecun-normal Dense kernels,
    zero biases, LayerNorm scale 1 and bias 0, flax Embed's normal, and
    with ``moe_experts`` the MoE leaves at flax's paths (`_moe`)."""
    from ..trainer.train_step import nest

    return nest(dict(init_leaves(cfg, seed, device)))


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
        from ..parallel.fsdp import is_dtensor

        if is_dtensor(self.embedding) and not is_dtensor(idx):
            return _vocab_parallel_embed(idx, self.embedding).to(self.dtype)
        return F.embedding(idx, self.embedding).to(self.dtype)


def _vocab_parallel_embed(idx: torch.Tensor, table) -> torch.Tensor:
    """The rows of a tensor-parallel `table` (a DTensor over ``tp``,
    the vocab sharded or not) for ids that every tp rank holds, as a
    replicated DTensor.  DTensor's own embedding rule keeps a masked
    partial sum whose mask a later cast or a remat loses, so the lookup
    is by hand: each rank takes the rows its vocab piece holds, zeroes
    the others, and the partial rows are summed over ``tp`` (one rank
    contributes each row, so the sum is exact)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..parallel.sharding import _chunk

    mesh = table.device_mesh
    local = table.to_local()
    if not table.placements[0].is_shard():
        return DTensor.from_local(F.embedding(idx, local), mesh,
                                  [Replicate()], run_check=False)
    lo, hi = _chunk(0, table.shape[0], mesh.size(0), mesh.get_local_rank(0))
    inside = (idx >= lo) & (idx < hi)
    rows = F.embedding(torch.where(inside, idx - lo, 0), local)
    rows = rows * inside[..., None].to(rows.dtype)
    return DTensor.from_local(rows, mesh, [Partial()],
                              run_check=False).redistribute(
                                  mesh, [Replicate()])


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

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        B, T, C = x.shape
        H, D = cfg.n_head, cfg.head_dim
        # under tensor parallel c_attn's output is sharded over its 3C
        # columns, so a tp piece crosses the q/k/v boundary: the split is
        # global (DTensor gathers), and only then are the heads taken
        # local (the columns keep JAX's layout in the checkpoint)
        q, k, v = self.c_attn(x).split(C, dim=-1)
        q, k, v, to_global = local_heads(q.reshape(B, T, H, D),
                                         k.reshape(B, T, H, D),
                                         v.reshape(B, T, H, D))
        H = q.shape[2]
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
        y = to_global(y)
        return dropout(self.c_proj(y.reshape(B, T, C)), cfg.dropout, gen)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        from .fp8 import dense

        super().__init__()
        self.rate = cfg.dropout
        C = cfg.n_embd
        self.c_fc = dense(cfg, C, 4 * C, "c_fc", device=device)
        self.c_proj = dense(cfg, 4 * C, C, "c_proj", device=device)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))
        return dropout(h, self.rate, gen)


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``; `gen` None is the deterministic path
    (identity)."""
    if gen is None or rate == 0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Block(nn.Module):
    """``forward(x, seed)`` returns the block's output and its MoE aux
    loss (None for a dense MLP).  `seed` (an int, or None for the
    deterministic path) seeds the block's dropout masks."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.dtype, device)
        if cfg.moe_experts:
            from .moe import MoEConfig, MoEMLP

            self.moe_mlp = MoEMLP(cfg.n_embd, 4 * cfg.n_embd, MoEConfig(
                num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype),
                device, mesh=cfg.mesh)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None):
        from ..ops.remat import checkpoint_name

        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        attn = self.attn(self.ln_1(x), gen)
        x = x + checkpoint_name(attn, "attn_out")
        aux = None
        if hasattr(self, "moe_mlp"):
            h, aux = self.moe_mlp(self.ln_2(x))
        else:
            h = self.mlp(self.ln_2(x), gen)
        return x + checkpoint_name(h, "mlp_out"), aux


class GPT(nn.Module):
    """GPT-2 with a tied lm head.  ``forward(idx)`` takes (B, T) token ids
    and returns (B, T, vocab) logits in ``cfg.dtype``; `intermediates`
    then holds each MoE block's aux loss at flax's path
    (``h_<i>.moe_mlp.moe_aux_loss``), or nothing."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        if cfg.remat:
            from ..ops.remat import resolve_remat_policy

            resolve_remat_policy(cfg.remat_policy)  # an unknown name raises
        self.config = cfg
        self.intermediates: Dict = {}
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

    def init_leaves(self, seed: int = 0, device=None):
        """`init_leaves` of this model's config."""
        return init_leaves(self.config, seed, device)

    def fsdp_units(self):
        """The modules that FSDP2 shards and gathers one at a time below
        the root (`parallel.fsdp.shard_model`): the blocks."""
        return [getattr(self, f"h_{i}") for i in range(self.config.n_layer)]

    def forward(self, idx: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """With ``dropout > 0`` and ``deterministic=False`` the masks come
        from `generator` (None: torch's default generator), one seed a
        block."""
        from ..parallel.long_context import seq_offset

        cfg = self.config
        T = idx.shape[1]
        t0 = seq_offset(cfg.mesh, T)
        x = self.wte(idx) + self.wpe.embedding[t0:t0 + T].to(cfg.dtype)[None]
        blocks = [getattr(self, f"h_{i}") for i in range(cfg.n_layer)]
        if cfg.remat:
            from ..ops.remat import (
                MODEL_CHECKPOINT_NAMES,
                resolve_remat_policy,
                trace_remat_policy,
            )

            wrap = resolve_remat_policy(
                trace_remat_policy(cfg.remat_policy),
                cfg.remat_names or MODEL_CHECKPOINT_NAMES)
            blocks = [functools.partial(wrap, b) for b in blocks]
        seeds = [None] * cfg.n_layer
        if cfg.dropout > 0 and not deterministic:
            seeds = torch.randint(
                0, 2 ** 62, (cfg.n_layer,), generator=generator,
                device=generator.device if generator else "cpu").tolist()
        self.intermediates = {}
        for i, (block, seed) in enumerate(zip(blocks, seeds)):
            x, aux = block(x, seed)
            if aux is not None:
                self.intermediates[f"h_{i}"] = {
                    "moe_mlp": {"moe_aux_loss": aux}}
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
    from ..parallel.fsdp import is_dtensor

    if is_dtensor(logits):
        # tensor parallel: the chunked autograd.Function has no DTensor
        # rule, so the vocab-sharded logits are gathered on every tp rank
        # (their backward takes each rank's columns of the gradient)
        from torch.distributed.tensor import Replicate

        logits = logits.redistribute(
            placements=[Replicate()] * logits.device_mesh.ndim).to_local()
    return _CrossEntropy.apply(logits, targets, ignore_index)
