"""GPT-2 family configuration and seeded parameter init in the flax layout.

Parity: dlrover_wuqiong_tpu/models/gpt.py:23-82 (`GPTConfig`, presets,
`head_dim`, `num_params`) and the parameter tree that `GPT.init_params`
(:204) produces.  The `GPT` training module and `cross_entropy_loss` are
not ported yet.

Parameters are a nested dict keyed as flax keys them (``wte/embedding``,
``h_<i>/attn/c_attn/kernel``, ``h_<i>/ln_1/scale``, ``ln_f/bias``, ...) with
Dense kernels kept ``(in, out)``: the int8 store quantizes the flattened
row-major kernel in 256-element blocks, so a transposed kernel would get
other blocks and other numbers.  Master parameters are float32; compute
runs in ``cfg.dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # GPT-2's 50257 padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    block_size: int = 1024
    dtype: torch.dtype = torch.bfloat16

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


def _dense(fan_in: int, fan_out: int, gen, device) -> Dict[str, torch.Tensor]:
    kernel = torch.empty((fan_in, fan_out), device=device)
    torch.nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=gen)
    kernel.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
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
