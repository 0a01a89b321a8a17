"""Attention dispatch for model modules (GPT, and Llama after its GQA
repeat): the flash route.

Parity: dlrover_wuqiong_tpu/models/attention.py — `attend` (:20).  The
model config's ``attn_impl`` picks the implementation; only "flash" (the
one-device route) is ported.  "ring" and "ulysses" with a mesh raise:
context-parallel attention comes with `parallel/long_context.py`, ROADMAP
queue 1 item 8.

The dtype contract (``GPTConfig.dtype``, ``LlamaConfig.dtype``): the
flash route's CUDA kernels compute in bfloat16, so on a CUDA device
`attend` rounds q, k and v of another dtype to bfloat16 and casts the
output back.  A float32 model on the card therefore runs bfloat16
attention (products in bfloat16 with float32 accumulation); on the CPU
the plain versions compute in the model's dtype.  Past one 1024-row
block (Llama-3 at T = 4096) the backward takes the split dq and dk/dv
kernels (`ops.flash_attention.backward_route`).
"""

from __future__ import annotations

import torch

from ..ops.flash_attention import mha


def attend(q, k, v, cfg, causal: bool = True):
    """q/k/v in flax layout (b, T, h, d); returns (b, T, h, d)."""
    impl = getattr(cfg, "attn_impl", "flash")
    if impl in ("ring", "ulysses") and getattr(cfg, "mesh", None) is not None:
        raise NotImplementedError(
            f"attn_impl={impl!r} over a mesh is not ported yet: "
            "context-parallel attention is ROADMAP queue 1 item 8")
    if q.is_cuda and q.dtype != torch.bfloat16:
        bf = torch.bfloat16
        return mha(q.to(bf), k.to(bf), v.to(bf), causal=causal).to(q.dtype)
    return mha(q, k, v, causal=causal)
