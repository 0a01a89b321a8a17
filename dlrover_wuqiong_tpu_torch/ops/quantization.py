"""Quantization ops: the blockwise int8 pair as CUDA kernels, and fp8 scaling.

Parity: dlrover_wuqiong_tpu/ops/quantization.py — `quantize_int8_blockwise`
(:82), `dequantize_int8_blockwise` (:114), `fp8_quantize` (:142) and
`fp8_dequantize` (:157), with the same layout and the same numbers.

int8: a tensor of any shape is flattened, zero-padded to a multiple of 256
and cut into rows of 256; each row keeps ``scale = absmax / 127`` (1.0 for
an all-zero row) and ``q = clip(round_half_even(x / scale), -127, 127)``.
`quantize_int8_blockwise_grouped` quantizes many tensors into the rows of
one flat store, each tensor a range of whole rows, so the store of a model
is one (R, 256) q and one (R, 1) scale, and one dequantize call over all R
rows restores every tensor (the serving engine's layout).

Each int8 function is a wrapper over two versions of one computation:

- the CUDA kernels in ``csrc/int8_blockwise.cu`` (replacing the Pallas
  `_quant_kernel` :69 and `_dequant_kernel` :78), launched for CUDA
  tensors on the current stream: one quantize kernel, whose one-tensor
  case is `quantize_int8_blockwise` and whose many-tensor case is the
  grouped call, and one dequantize kernel.  Both are bound by device
  memory; the source note there says what the design does about it.
  Dequantize at GPT-2 124M moves ~375 MB per serving dispatch (int8 in,
  bf16 out, written directly): ~0.11 ms at 3.35 TB/s, in one launch.
- the plain PyTorch versions (`_quantize_plain`, `_dequantize_plain`, and
  `_quantize_plain` per tensor into the flat rows for the grouped call),
  taken only for CPU tensors.  They repeat the arithmetic exactly and are
  what the kernels are held against.

A CUDA tensor launches the kernel or raises; nothing falls back.  `LAUNCHES`
counts kernel launches per wrapper (plain calls are not counted; a grouped
call counts under ``quantize_int8_blockwise``).

fp8 stays plain torch (``torch.float8_e4m3fn`` / ``e5m2``): it is elementwise
scaling with no TPU kernel behind it.  `fp8_dot`, `fp8_matmul` and
`Fp8Einsum` are training-side and not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .flash_attention import align16

BLOCK = 256
#: leaves one grouped quantize launch takes (the kernel's table limit)
MAX_LEAVES = 1024

#: kernel launches per wrapper since the last `reset_launches`
LAUNCHES: Dict[str, int] = {
    "quantize_int8_blockwise": 0,
    "dequantize_int8_blockwise": 0,
}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_LIB: Optional[ctypes.CDLL] = None

_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
#: argtypes of each C entry point of csrc/int8_blockwise.cu (all return int)
_SIGNATURES = {
    **{f"quantize_int8_blockwise_{sfx}": [_P, _I64, _I64, _P, _P, _P]
       for sfx in _SUFFIX.values()},
    **{f"quantize_int8_blockwise_grouped_{sfx}":
       [_P, ctypes.c_int, _I64, _P, _P, _P] for sfx in _SUFFIX.values()},
    **{f"dequantize_int8_blockwise_{sfx}": [_P, _P, _I64, _P, _P]
       for sfx in _SUFFIX.values()},
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("int8_blockwise")
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: the kernel takes CUDA tensors, "
                         f"got device {t.device}")


# ------------------------------------------------------------ int8 plain


def _rows(n: int) -> int:
    """Rows of 256 that n values fill, the last one zero-padded."""
    return -(-n // BLOCK)


def _quantize_plain(x: torch.Tensor, block: int = BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    xf = flat.reshape(-1, block).float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor, not the float 127.0: on CUDA, torch divides by a
    # Python scalar as a multiply by its reciprocal, one ulp off IEEE
    div = torch.full_like(absmax, 127.0)
    scale = torch.where(absmax > 0, absmax / div, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _grouped_store(xs: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """Empty flat (R, 256) q and (R, 1) scales for `xs`, and each tensor's
    first row."""
    first, rows = [], 0
    for x in xs:
        first.append(rows)
        rows += _rows(x.numel())
    dev = xs[0].device
    return (torch.empty((rows, BLOCK), dtype=torch.int8, device=dev),
            torch.empty((rows, 1), dtype=torch.float32, device=dev), first)


def _quantize_grouped_plain(xs: Sequence[torch.Tensor]
                            ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """The grouped quantize, tensor by tensor: `_quantize_plain` of each
    written into its rows of the flat store."""
    q, scale, first = _grouped_store(xs)
    for x, r0 in zip(xs, first):
        qi, si = _quantize_plain(x)
        q[r0:r0 + qi.shape[0]] = qi
        scale[r0:r0 + qi.shape[0]] = si
    return q, scale, first


def _dequantize_plain(q: torch.Tensor, scale: torch.Tensor, size: int,
                      shape: Sequence[int], dtype=torch.float32
                      ) -> torch.Tensor:
    x = q.float() * scale
    return x.reshape(-1)[:size].reshape(tuple(shape)).to(dtype)


# ------------------------------------------------------------ int8 public


def quantize_int8_blockwise(x: torch.Tensor, block: int = BLOCK
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape, f32 or bf16) -> (int8 (rows, 256), f32 scales (rows, 1)).

    The quantize kernel's one-tensor case for a CUDA tensor, the plain
    version for a CPU one.
    """
    if x.device.type == "cpu":
        return _quantize_plain(x, block)
    _require_cuda(x, "quantize_int8_blockwise")
    if block != BLOCK:
        raise ValueError(f"the kernel quantizes rows of {BLOCK}, "
                         f"got block={block}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"quantize_int8_blockwise takes float32 or "
                         f"bfloat16, got {x.dtype}")
    x = x.contiguous()  # a misaligned start takes the kernel's scalar loads
    n = x.numel()
    rows = _rows(n)
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    fn = getattr(_lib(), f"quantize_int8_blockwise_{_SUFFIX[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check_rc(fn(x.data_ptr(), n, rows, q.data_ptr(), scale.data_ptr(),
                 stream), "quantize_int8_blockwise")
    LAUNCHES["quantize_int8_blockwise"] += 1
    return q, scale


def quantize_int8_blockwise_grouped(xs: Sequence[torch.Tensor]
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               List[int]]:
    """Tensors of one dtype (f32 or bf16) on one device -> (int8 (R, 256),
    f32 scales (R, 1), each tensor's first row).

    Tensor i owns ``ceil(numel_i / 256)`` rows from its first row on, and
    they hold what `quantize_int8_blockwise` gives for it alone.  CUDA
    tensors take one kernel launch (at most `MAX_LEAVES` tensors), CPU
    tensors the plain version.
    """
    xs = list(xs)
    if not xs:
        raise ValueError("quantize_int8_blockwise_grouped: no tensors")
    dtypes = sorted({str(x.dtype) for x in xs})
    devices = sorted({str(x.device) for x in xs})
    if len(dtypes) > 1 or len(devices) > 1:
        raise ValueError(f"quantize_int8_blockwise_grouped takes tensors of "
                         f"one dtype on one device, got {dtypes} on "
                         f"{devices}")
    if xs[0].device.type == "cpu":
        return _quantize_grouped_plain(xs)
    _require_cuda(xs[0], "quantize_int8_blockwise_grouped")
    if xs[0].dtype not in _SUFFIX:
        raise ValueError(f"quantize_int8_blockwise_grouped takes float32 "
                         f"or bfloat16, got {xs[0].dtype}")
    if len(xs) > MAX_LEAVES:
        raise ValueError(f"quantize_int8_blockwise_grouped takes at most "
                         f"{MAX_LEAVES} tensors, got {len(xs)}")
    xs = [x.contiguous()  # a misaligned start takes the scalar loads
          for x in xs]
    q, scale, first = _grouped_store(xs)
    if q.shape[0] == 0:
        return q, scale, first
    dev = q.device
    # the leaf table: pointers, sizes, first rows, copied to the card on
    # the stream from pinned memory
    table = torch.tensor([x.data_ptr() for x in xs]
                         + [x.numel() for x in xs] + first,
                         dtype=torch.int64).pin_memory().to(
                             dev, non_blocking=True)
    fn = getattr(_lib(),
                 f"quantize_int8_blockwise_grouped_{_SUFFIX[xs[0].dtype]}")
    _check_rc(fn(table.data_ptr(), len(xs), q.shape[0], q.data_ptr(),
                 scale.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
              "quantize_int8_blockwise_grouped")
    LAUNCHES["quantize_int8_blockwise"] += 1
    return q, scale, first


def dequantize_int8_blockwise(q: torch.Tensor, scale: torch.Tensor,
                              size: int, shape: Sequence[int],
                              dtype=torch.float32) -> torch.Tensor:
    """Inverse of `quantize_int8_blockwise`: the first `size` values of
    ``q * scale``, reshaped to `shape` and cast to `dtype`."""
    if q.device.type == "cpu":
        return _dequantize_plain(q, scale, size, shape, dtype)
    _require_cuda(q, "dequantize_int8_blockwise")
    rows = q.shape[0]
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != BLOCK \
            or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous int8 (rows, {BLOCK}) "
                         f"tensor, got {q.dtype} {tuple(q.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != rows \
            or scale.device != q.device or not scale.is_contiguous():
        raise ValueError("scale must be a contiguous float32 (rows, 1) "
                         "tensor on q's device")
    shape = tuple(int(d) for d in shape)
    if math.prod(shape) != size or not 0 <= size <= rows * BLOCK:
        raise ValueError(f"size {size} does not fit shape {shape} "
                         f"and {rows} rows")
    if dtype not in _SUFFIX:
        raise ValueError(f"dequantize_int8_blockwise writes float32 or "
                         f"bfloat16, got {dtype}")
    out = torch.empty(shape, dtype=dtype, device=q.device)
    if size == 0:
        return out
    q = align16(q)  # the kernel reads q in 16-byte loads
    fn = getattr(_lib(), f"dequantize_int8_blockwise_{_SUFFIX[dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _check_rc(fn(q.data_ptr(), scale.data_ptr(), size, out.data_ptr(),
                 stream), "dequantize_int8_blockwise")
    LAUNCHES["dequantize_int8_blockwise"] += 1
    return out


# ------------------------------------------------------------------- fp8


E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

_FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}


def fp8_quantize(x: torch.Tensor, dtype=E4M3,
                 scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor scaling into fp8; returns (fp8 x, f32 scale)."""
    if scale is None:
        amax = x.abs().amax().float()
        scale = torch.where(amax > 0, _FP8_MAX[dtype] / amax,
                            torch.ones_like(amax))
    q = (x.float() * scale).to(dtype)
    return q, scale


def fp8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    return (q.float() / scale).to(dtype)
