"""Attention dispatch for model modules (GPT, and Llama after its GQA
repeat): the flash route, or sequence parallel attention over a mesh.

Parity: dlrover_wuqiong_tpu/models/attention.py — `attend` (:20).
Under tensor parallel the models hand `attend` each rank's heads
(`local_heads`).  The model config's ``attn_impl`` picks the
implementation: "ring", "ulysses" or "gspmd" with a ``mesh`` whose
``sp`` is above 1 take `parallel.long_context`'s attention over this
rank's chunk of the sequence (JAX routes "ring" and "ulysses" so, and
leaves "gspmd" to XLA's gathers); anything else, and sp 1, is the flash
route.

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


def local_heads(*xs):
    """(each of `xs` (b, T, h, d) with this rank's heads, ``to_global``).

    Under tensor parallel q, k and v are DTensors over ``tp``: the flash
    kernels and their plain versions have no DTensor rule, so each is laid
    out head-sharded (``Shard(2)``) and its local heads go to the kernel;
    ``to_global`` wraps the local output back as the head-sharded DTensor.
    Plain tensors pass through, and ``to_global`` is the identity."""
    from ..parallel.fsdp import is_dtensor

    if not is_dtensor(xs[0]):
        return (*xs, lambda y: y)
    from torch.distributed.tensor import DTensor, Shard

    mesh = xs[0].device_mesh
    heads = [Shard(2)] * mesh.ndim
    local = [x.redistribute(mesh, heads).to_local() for x in xs]
    return (*local, lambda y: DTensor.from_local(y, mesh, heads,
                                                  run_check=False))


def attend(q, k, v, cfg, causal: bool = True):
    """q/k/v in flax layout (b, T, h, d); returns (b, T, h, d)."""
    if q.is_cuda and q.dtype != torch.bfloat16:
        bf = torch.bfloat16
        return attend(q.to(bf), k.to(bf), v.to(bf), cfg,
                      causal=causal).to(q.dtype)
    impl = getattr(cfg, "attn_impl", "flash")
    mesh = getattr(cfg, "mesh", None)
    if mesh is not None and impl in ("ring", "ulysses", "gspmd"):
        from ..parallel.long_context import SP_ATTENTION

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return SP_ATTENTION[impl](qt, kt, vt, mesh,
                                  causal=causal).transpose(1, 2)
    return mha(q, k, v, causal=causal)
