"""Flash attention: forward and backward as CUDA kernels, with plain versions.

Parity: dlrover_wuqiong_tpu/ops/flash_attention.py — `flash_attention`
(:576), `flash_attention_with_lse` (:855) and `mha` (:884), with the same
signatures, layouts and numbers.  Both differentiable entry points are one
`torch.autograd.Function` whose forward and backward are kernels.

Semantics pinned from the JAX version:

- q, k, v are ``(b, h, s, d)``; the causal mask is aligned bottom-right
  (query i sees key j when ``j <= i + sk - sq``, `:254`).
- lse is float32 natural log, ``(b, h, sq)``; a row with no visible key
  gives ``o = 0`` and ``lse = -inf`` (`:204-209`).
- q is pre-scaled by ``sm_scale * log2(e)`` and rounded back to its dtype
  (`:153`, `:313`), so scores are in log2 units; p is cast to v's dtype
  before the PV product (`:168,179`).  The default ``sm_scale`` is
  ``1/sqrt(d)``.
- The lse cotangent folds into delta: ``delta = rowsum(dO*O) - glse``
  (`:476-481`), a torch reduction outside the kernels, as the JAX package
  computes it outside Pallas.
- The backward route follows `:488`: the fused dq+dk+dv kernel when one
  reference block covers each sequence (``num_q == num_kv == 1`` with the
  blocks `_fit_block` picks from ``block_q``/``block_k``, or
  ``bwd_block_q``/``bwd_block_k`` when nonzero), else the split dq and
  dk/dv pair; ``DWT_FA_NO_FUSED`` forces the split pair.  The block
  arguments choose the route only: the CUDA kernels choose their own tiles
  (see ``csrc/flash_attention.cu``: the forward is a persistent Hopper
  kernel of 128-row q tiles, wgmma products and TMA loads, and so are the
  split route's dq kernel, over 128-row q tiles, and its dk/dv kernel,
  over 128-row kv tiles; the fused kernel uses 64-row tiles).  On the
  card the fused route is one launch that does the split pair's work in
  two roles of independent blocks (dk/dv per kv tile, dq per q tile, each
  with a two-stage cp.async pipeline): it recomputes S and dP in both
  roles, 7 products where the Pallas fused kernel takes 5, and needs no
  scratch and no atomics, so its dq, dk and dv are bitwise reproducible.
  Its dq comes from other code than the split route's dq kernel, which
  adds the same products in the same order: the two have matched bitwise
  on the H100, and the checks hold them within rounding.

Each step is a wrapper over two versions of one computation:

- the CUDA kernels in ``csrc/flash_attention.cu`` (replacing the Pallas
  `_fa_fwd_kernel` :108, `_fa_bwd_dq_kernel` :327, `_fa_bwd_dkv_kernel`
  :375 and `_fa_bwd_fused_kernel` :429), launched for CUDA tensors on the
  current stream.  They take bfloat16 only, with head dim 64 or 128;
  other head dims are zero-padded to the next of the two (d > 128
  raises), and a CUDA tensor of another dtype raises.  A float32 model
  states its bfloat16 attention where it calls them
  (`models.attention.attend`, the dtype contract of ``GPTConfig``).
- the plain PyTorch versions `_fa_forward_plain` and `_fa_backward_plain`:
  a dense float32 recompute with the same masking and empty-row rules,
  taken only for CPU tensors (and by ``chip_smoke.py`` as the kernels'
  reference).  From a per-head score matrix of 2048² on (`use_streamed`,
  JAX `_use_streamed`), the CPU takes their streamed scans instead,
  `_fa_forward_streamed` over key blocks and `_fa_backward_streamed`
  over query blocks, whose temporaries are a block's, not the whole
  score matrix's.

A CUDA tensor launches the kernels or raises; nothing falls back.
`LAUNCHES` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Dict, Optional, Tuple

import torch

from .. import _build

NEG_INF = -1e30  # masked score: dominates any real score without inf-inf
LOG2E = 1.4426950408889634

#: kernel launches per kernel since the last `reset_launches`
LAUNCHES: Dict[str, int] = {
    "flash_attention_fwd": 0,
    "flash_attention_bwd_fused": 0,
    "flash_attention_bwd_dq": 0,
    "flash_attention_bwd_dkv": 0,
}

_KERNEL_HEAD_DIMS = (64, 128)
_LIB: Optional[ctypes.CDLL] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: argtypes of each C entry point of csrc/flash_attention.cu (all return int)
_SIGNATURES = {
    "fa_forward_bf16": [_P] * 5 + [_I] * 5 + [_F, _P],
    "fa_backward_dq_bf16": [_P] * 7 + [_I] * 5 + [_F, _F, _P],
    "fa_backward_dkv_bf16": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    "fa_backward_fused_bf16": [_P] * 9 + [_I] * 5 + [_F, _F, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# ------------------------------------------------------------ route rule


def _fit_block(seq: int, pref: int) -> Optional[int]:
    """Largest block <= pref that tiles `seq` (the JAX package's rule,
    `:597`); None if nothing reasonable."""
    for b in (pref, 1024, 512, 256, 128, 64, 32, 16, 8):
        if b <= pref and b <= seq and seq % b == 0:
            return b
    return seq if seq <= 2048 else None


def backward_route(sq: int, sk: int, block_q: int = 1024,
                   block_k: int = 1024) -> str:
    """"fused" when one block covers each sequence and DWT_FA_NO_FUSED is
    unset, else "split" (`:488`)."""
    bq = _fit_block(sq, block_q)
    bk = _fit_block(sk, block_k)
    single = bq is not None and bk is not None and sq // bq == 1 \
        and sk // bk == 1
    return "fused" if single and not os.getenv("DWT_FA_NO_FUSED") \
        else "split"


# ------------------------------------------------------------ plain versions


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    rows = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return torch.arange(sk, device=device)[None, :] <= rows


def _scaled_scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """(bh, sq, sk) float32 scores in log2 units from the pre-scaled q."""
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    s = qs @ k.float().transpose(1, 2)
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], k.shape[1], q.device),
                          NEG_INF)
    return s


def _fa_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (bh, sq, d), k/v (bh, sk, d) -> (o like q, lse (bh, sq) f32)."""
    s = _scaled_scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= NEG_INF, 0.0, torch.exp2(s - m))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l > 0, l, 1.0)
    o = (p.to(v.dtype).float() @ v.float()) / l_safe
    lse = torch.where(l > 0, m * (1.0 / LOG2E) + torch.log(l_safe),
                      -math.inf)[..., 0]
    return o.to(q.dtype), lse


def _delta(o: torch.Tensor, do: torch.Tensor,
           glse: Optional[torch.Tensor]) -> torch.Tensor:
    """rowsum(dO * O) - glse, (bh, sq) float32."""
    delta = (do.float() * o.float()).sum(-1)
    return delta if glse is None else delta - glse.float()


def _fa_backward_plain(q, k, v, o, lse, do, causal: bool, scale: float,
                       glse: Optional[torch.Tensor] = None):
    """Dense recompute of p from lse; returns (dq, dk, dv) in the input
    dtypes.  lse (bh, sq) f32, glse (bh, sq) or None."""
    s = _scaled_scores(q, k, causal, scale)
    fin = torch.isfinite(lse)
    lse2 = torch.where(fin, lse * LOG2E, 0.0)[..., None]
    p = torch.where(fin[..., None], torch.exp2(s - lse2), 0.0)
    delta = _delta(o, do, glse)[..., None]
    dp = do.float() @ v.float().transpose(1, 2)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = ds @ k.float()
    dk = ds.transpose(1, 2) @ q.float()
    dv = p.to(q.dtype).float().transpose(1, 2) @ do.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ streamed scan


def use_streamed(sq: int, sk: int) -> bool:
    """Does the CPU path take the streamed scan (JAX `_use_streamed`
    `:620-634`): from a per-head score matrix of 2048² on, or as
    ``DWT_FA_STREAMED`` (1/0) says.  CUDA tensors never do: the kernels
    are their only route."""
    env = os.getenv("DWT_FA_STREAMED")
    if env is not None:
        return env == "1"
    return sq * sk >= 2048 * 2048


def _fa_forward_streamed(q, k, v, causal: bool, scale: float,
                         block_k: int = 512):
    """`_fa_forward_plain` as an online-softmax scan over key blocks of
    `block_k` (JAX `_streamed_with_lse` `:700-747`): the same pre-scaled
    q, log2 scores, masking and empty-row rules, with float32 temporaries
    of O(bh * sq * block_k) where the dense version holds O(bh * sq * sk).
    q (bh, sq, d), k/v (bh, sk, d) -> (o like q, lse (bh, sq) f32)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bk = _fit_block(sk, min(block_k, 512)) or sk
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    acc = torch.zeros((bh, sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m = torch.full((bh, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=q.device)
    for j in range(0, sk, bk):
        s = qs @ k[:, j:j + bk].float().transpose(1, 2)
        if causal:
            cols = torch.arange(j, j + bk, device=q.device)[None, :]
            s = s.masked_fill(~(cols <= rows), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        # a masked score gives p = 0, so a row that sees no key keeps l = 0
        p = torch.where(s <= NEG_INF, 0.0, torch.exp2(s - m_new[..., None]))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + (p.to(v.dtype).float()
                                        @ v[:, j:j + bk].float())
        m = m_new
    l_safe = torch.where(l > 0, l, 1.0)
    o = acc / l_safe[..., None]
    lse = torch.where(l > 0, m * (1.0 / LOG2E) + torch.log(l_safe),
                      -math.inf)
    return o.to(q.dtype), lse


def _fa_backward_streamed(q, k, v, o, lse, do, causal: bool, scale: float,
                          glse: Optional[torch.Tensor] = None,
                          block_q: int = 512):
    """`_fa_backward_plain` as a recompute scan over query blocks of
    `block_q` (JAX `_streamed_bwd` `:750-792`): each block re-derives its
    p from lse (the lse cotangent folded into delta), writes its dq and
    adds into dk and dv, with float32 temporaries of O(bh * block_q *
    sk).  Returns (dq, dk, dv) in the input dtypes."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    bq = _fit_block(sq, min(block_q, 512)) or sq
    fin = torch.isfinite(lse)
    lse2 = torch.where(fin, lse * LOG2E, 0.0)
    delta = _delta(o, do, glse)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(q)
    dk = torch.zeros((bh, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((bh, sk, v.shape[-1]), dtype=torch.float32,
                     device=q.device)
    cols = torch.arange(sk, device=q.device)[None, :]
    for i in range(0, sq, bq):
        qb, dob = q[:, i:i + bq], do[:, i:i + bq].float()
        s = (qb.float() * (scale * LOG2E)).to(q.dtype).float() \
            @ kf.transpose(1, 2)
        if causal:
            rows = torch.arange(i, i + bq, device=q.device)[:, None] \
                + (sk - sq)
            s = s.masked_fill(~(cols <= rows), NEG_INF)
        p = torch.where(fin[:, i:i + bq, None],
                        torch.exp2(s - lse2[:, i:i + bq, None]), 0.0)
        dp = dob @ vf.transpose(1, 2)
        ds = (p * (dp - delta[:, i:i + bq, None]) * scale).to(
            q.dtype).float()
        dq[:, i:i + bq] = (ds @ kf).to(q.dtype)
        dk += ds.transpose(1, 2) @ qb.float()
        dv += p.to(q.dtype).float().transpose(1, 2) @ dob
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ kernels


def align16(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when its data starts on a 16-byte boundary, else a fresh
    contiguous copy (the caching allocator aligns every block).  The
    kernels read their operands with 16-byte or TMA accesses, and
    ``.contiguous()`` keeps a view's storage offset; the copy holds the
    same values, so the result is the one an aligned operand gives."""
    if t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kernel_operands(what: str, q, k, v, *rest):
    """Checks CUDA bf16 operands: q (bh, sq, d), k and v (bh, sk, d) with
    d in (64, 128), and `rest` shaped like q; returns them contiguous and
    16-byte aligned (lse and delta are read 4 bytes at a time and need
    no more than their dtype's alignment)."""
    ts = (q, k, v, *rest)
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: the kernels take bfloat16, got "
                             f"{t.dtype}; cast q, k and v first")
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{what}: the kernel takes CUDA tensors, "
                             f"got device {t.device}")
    if q.dim() != 3 or q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: q is (bh, s, d) with d in "
                         f"{_KERNEL_HEAD_DIMS}, got {tuple(q.shape)}")
    kv_shape = (q.shape[0], k.shape[1] if k.dim() == 3 else -1, q.shape[2])
    if tuple(k.shape) != kv_shape or tuple(v.shape) != kv_shape or any(
            t.shape != q.shape for t in rest):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if q.shape[0] > 65535:
        raise ValueError(f"{what}: batch*heads {q.shape[0]} exceeds 65535")
    return [align16(t.contiguous()) for t in ts]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fa_forward_kernel(q, k, v, causal: bool, scale: float):
    qb, kb, vb = _kernel_operands("flash_attention forward", q, k, v)
    bh, sq, d = qb.shape
    sk = kb.shape[1]
    o = torch.empty_like(qb)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh and sq:
        _check_rc(_lib().fa_forward_bf16(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq, sk, d, int(causal), scale * LOG2E,
            _stream(q)), "flash_attention_fwd")
        LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def _fa_backward_kernel(q, k, v, o, lse, do, causal: bool, scale: float,
                        glse, route: str):
    delta = _delta(o, do, glse).contiguous()
    qb, kb, vb, dob = _kernel_operands("flash_attention backward",
                                       q, k, v, do)
    bh, sq, d = qb.shape
    sk = kb.shape[1]
    lse = lse.float().contiguous()
    dq = torch.empty_like(qb)
    dk = torch.empty_like(kb)
    dv = torch.empty_like(vb)
    if bh and sq and sk:
        lib, stream = _lib(), _stream(q)
        common = (bh, sq, sk, d, int(causal), scale * LOG2E, scale, stream)
        ins = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dob.data_ptr(),
               lse.data_ptr(), delta.data_ptr())
        if route == "fused":
            _check_rc(lib.fa_backward_fused_bf16(
                *ins, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common),
                "flash_attention_bwd_fused")
            LAUNCHES["flash_attention_bwd_fused"] += 1
        else:
            _check_rc(lib.fa_backward_dq_bf16(*ins, dq.data_ptr(), *common),
                      "flash_attention_bwd_dq")
            LAUNCHES["flash_attention_bwd_dq"] += 1
            _check_rc(lib.fa_backward_dkv_bf16(
                *ins, dk.data_ptr(), dv.data_ptr(), *common),
                "flash_attention_bwd_dkv")
            LAUNCHES["flash_attention_bwd_dkv"] += 1
    elif sq:  # no keys: o = 0, so dq = 0
        dq.zero_()
    return dq, dk, dv


def _fa_forward(q, k, v, causal: bool, scale: float):
    """Flat (bh, s, d) forward: the kernel for CUDA; for the CPU the
    streamed scan from 2048² scores on (`use_streamed`), else the dense
    plain version."""
    if q.device.type == "cpu":
        if use_streamed(q.shape[1], k.shape[1]):
            return _fa_forward_streamed(q, k, v, causal, scale)
        return _fa_forward_plain(q, k, v, causal, scale)
    return _fa_forward_kernel(q, k, v, causal, scale)


def _fa_backward(q, k, v, o, lse, do, causal: bool, scale: float, glse,
                 route: str):
    if q.device.type == "cpu":
        if use_streamed(q.shape[1], k.shape[1]):
            return _fa_backward_streamed(q, k, v, o, lse, do, causal,
                                         scale, glse)
        return _fa_backward_plain(q, k, v, o, lse, do, causal, scale, glse)
    return _fa_backward_kernel(q, k, v, o, lse, do, causal, scale, glse,
                               route)


# ------------------------------------------------------------ public API


def _resolve_scale(sm_scale: Optional[float], d: int) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


def _kernel_head_dim(d: int, device: torch.device) -> int:
    """Head dim the kernels see: 64 or 128 on CUDA (zero-padded up), the
    true d on the CPU.  Padded q/k columns add 0 to the scores; padded v
    columns are sliced off."""
    if device.type == "cpu":
        return d
    for kd in _KERNEL_HEAD_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f"flash_attention: the CUDA kernels take head dims up "
                     f"to {_KERNEL_HEAD_DIMS[-1]}, got {d}")


def _flat_padded(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    b, h, s, d = x.shape
    x = x.reshape(b * h, s, d)
    if d != d_pad:
        x = torch.nn.functional.pad(x, (0, d_pad - d))
    return x


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (out, lse), kernel forward and kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, bwd_block_q, bwd_block_k):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        scale = _resolve_scale(sm_scale, d)
        d_pad = _kernel_head_dim(d, q.device)
        qf, kf, vf = (_flat_padded(t, d_pad) for t in (q, k, v))
        o, lse = _fa_forward(qf, kf, vf, causal, scale)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.meta = (b, h, sq, sk, d, d_pad, causal, scale,
                    backward_route(sq, sk, bwd_block_q, bwd_block_k))
        ctx.set_materialize_grads(False)
        out = o[..., :d].reshape(b, h, sq, d)
        return out, lse.reshape(b, h, sq)

    @staticmethod
    def backward(ctx, g, glse):
        qf, kf, vf, o, lse = ctx.saved_tensors
        b, h, sq, sk, d, d_pad, causal, scale, route = ctx.meta
        if g is None:
            do = torch.zeros_like(o)
        else:
            do = _flat_padded(g.to(o.dtype), d_pad)
        glse_f = None if glse is None else glse.reshape(b * h, sq)
        dq, dk, dv = _fa_backward(qf, kf, vf, o, lse, do, causal, scale,
                                  glse_f, route)
        return (dq[..., :d].reshape(b, h, sq, d),
                dk[..., :d].reshape(b, h, sk, d),
                dv[..., :d].reshape(b, h, sk, d), None, None, None, None)


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             sm_scale: Optional[float] = None,
                             block_q: int = 1024, block_k: int = 1024,
                             bwd_block_q: int = 0, bwd_block_k: int = 0):
    """Like `flash_attention`, also returning lse (b, h, sq) float32.
    Differentiable in both outputs (the lse cotangent folds into delta)."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale,
                                 bwd_block_q or block_q,
                                 bwd_block_k or block_k)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024,
                    bwd_block_q: int = 0, bwd_block_k: int = 0):
    """Multi-head attention.  q (b, h, sq, d); k, v (b, h, sk, d) ->
    (b, h, sq, d).  `block_q`/`block_k` (and `bwd_block_q`/`bwd_block_k`,
    0 = inherit) choose the backward route as the JAX package's blocks
    do; the kernels tile by themselves."""
    out, _ = flash_attention_with_lse(q, k, v, causal, sm_scale, block_q,
                                      block_k, bwd_block_q, bwd_block_k)
    return out


def mha(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """`flash_attention` over the flax layout (b, s, h, d)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal, sm_scale)
    return out.transpose(1, 2)
