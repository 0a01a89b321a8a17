"""Projection layers of the GPT and Llama families: flax's ``nn.Dense`` and
the fp8 projection, as torch modules.

Parity: dlrover_wuqiong_tpu/models/fp8.py — `Fp8Dense` (:26),
`fp8_selected` (:46) and `dense` (:66).  The parameters keep flax's names
and layout: ``kernel`` float32 ``(in, out)`` and ``bias`` float32
``(out,)``, so a flax tree loads by path.  With ``use_bias=False``
(Llama's projections) there is no ``bias`` parameter at all, as in flax.
`Dense`'s product is flax's with ``dtype=bf16``: ``x.to(dtype) @
kernel.to(dtype)``, rounded to ``dtype``, then ``+ bias.to(dtype)`` (as
dlrover_wuqiong_tpu/rl/generation.py:43 computes it).

`Fp8Dense` has `Dense`'s parameters, names and shapes, so
``convert.load_params`` and the flash checkpoint take an fp8 model's tree
unchanged; its product runs through ``ops.quantization.Fp8Einsum`` (e4m3
forward, e5m2 gradients, per-tensor current scaling) over the kernel cast
to ``dtype``, then adds the bias in ``dtype``.  `dense` builds one or the
other per the config's ``fp8`` flag (``DWT_FP8_DENSE`` overrides it) and
its ``fp8_filter`` of names.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import quantization


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


class Fp8Dense(Dense):
    """`Dense` with the product through the fp8 matmul.  As in flax, the
    kernel is cast to `dtype` before its fp8 rounding, so bf16 and fp8
    builds share the master-weight path."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quantization.Fp8Einsum.project(x, self.kernel.to(self.dtype),
                                           out_dtype=self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


def fp8_selected(cfg, name: str) -> bool:
    """Does the projection `name` take the fp8 path?  ``DWT_FP8_DENSE``
    (`ops.quantization.fp8_dense_override`) replaces the config's ``fp8``
    flag when set; the name filter ``fp8_filter`` always applies."""
    flt: Tuple[str, ...] = getattr(cfg, "fp8_filter", ())
    on = quantization.fp8_dense_override()
    if on is None:
        on = bool(getattr(cfg, "fp8", False))
    return on and any(p in name for p in flt)


def dense(cfg, in_features: int, features: int, name: str,
          device=None, use_bias: bool = True) -> Dense:
    """The projection `name` of a model built from `cfg`: `Fp8Dense` when
    `fp8_selected`, else `Dense`."""
    cls = Fp8Dense if fp8_selected(cfg, name) else Dense
    return cls(in_features, features, cfg.dtype, device, use_bias)
