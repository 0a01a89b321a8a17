"""Projection layer of the GPT and Llama families: flax's ``nn.Dense`` as a
torch module.

Parity: dlrover_wuqiong_tpu/models/fp8.py — `dense` (:66) and the
``nn.Dense(features, dtype=cfg.dtype, use_bias=use_bias)`` it returns when
fp8 is off.  The parameters keep flax's names and layout: ``kernel``
float32 ``(in, out)`` and ``bias`` float32 ``(out,)``, so a flax tree
loads by path.  With ``use_bias=False`` (Llama's projections) there is no
``bias`` parameter at all, as in flax.  The product is flax's with
``dtype=bf16``: ``x.to(dtype) @ kernel.to(dtype)``, rounded to ``dtype``,
then ``+ bias.to(dtype)`` (as dlrover_wuqiong_tpu/rl/generation.py:43
computes it).

`Fp8Dense` (fp8 matmuls on the name-filtered projections) is not ported
yet: ``cfg.fp8`` raises (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    """``y = x @ kernel (+ bias)`` in `dtype` over float32 parameters."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 device=None, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((in_features, features),
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def dense(cfg, in_features: int, features: int, name: str,
          device=None, use_bias: bool = True) -> Dense:
    """The projection `name` of a model built from `cfg`.  ``cfg.fp8``
    raises: `Fp8Dense` is not ported yet."""
    if getattr(cfg, "fp8", False):
        raise NotImplementedError(
            f"fp8 projections ({name}) are not ported yet: Fp8Dense is "
            "ROADMAP queue 1 item 3")
    return Dense(in_features, features, cfg.dtype, device, use_bias)
