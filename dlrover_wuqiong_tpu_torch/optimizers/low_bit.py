"""Low-bit optimizer states: block-wise int8 Adam moments.

Parity: dlrover_wuqiong_tpu/optimizers/low_bit.py — `QTensor` (:26),
`quantize_blockwise` (:44), `dequantize_blockwise` (:63),
`scale_by_adam8bit` (:75) and `adamw8bit` (:111), optax's
``chain(scale_by_adam8bit, add_decayed_weights, scale_by_learning_rate)``.

The map is the quadratic one, ``code = sign(x) clip(round(127
sqrt(|x| / absmax)), 0, 127)`` over blocks of 256 elements of the
flattened leaf (the tail block zero-padded), with a float32 scale per
block (1 for an all-zero block).  It is not the linear ``absmax / 127``
map of ops/quantization.py (the serving store and its CUDA kernel).
The moments are quantized again after every update, as JAX does.

This is the port of plain ``jnp`` code: the JAX package runs no Pallas
kernel here, and neither does the port (plain torch elementwise ops).
Each leaf is updated in chunks of whole blocks (`agd.CHUNK` elements),
so the float32 transients stay a few copies of one chunk.  Divisions
are by tensors (a 0-d device tensor), never by a Python scalar, which
torch turns into a multiply by the reciprocal on CUDA; roots are
correctly rounded (`agd.sqrt_`); ``torch.round`` rounds half to even,
as ``jnp.round`` does.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .agd import (
    AGD,
    CHUNK,
    LearningRate,
    chunks,
    device_scalars,
    lr_at,
    scalar,
    sqrt_,
)
from .leaf import LeafOptimizer

BLOCK = 256


class QTensor(NamedTuple):
    """Blockwise-int8 tensor: int8 codes (blocks, 256) and a float32
    scale per block; `size` and `shape` are the original tensor's.  Its
    checkpoint children are JAX's: ``0`` the codes, ``1`` the scales."""
    q: torch.Tensor
    scale: torch.Tensor
    size: int
    shape: Tuple[int, ...]


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def quantize_into(x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> None:
    """The codes and scales of `x` (float32, flat) into `q` (rows, 256)
    and `scale` (rows,)."""
    blk = _blocks(x)
    absmax = blk.abs().amax(dim=1, keepdim=True)
    s = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    norm = sqrt_(blk.abs().div_(s))
    code = norm.mul_(127.0).round_().clamp_(0, 127)
    q.copy_(code.mul_(torch.sign(blk)))
    scale.copy_(s[:, 0])


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    size: int) -> torch.Tensor:
    """The first `size` float32 values of codes `q` (rows, 256)."""
    c = q.float().div_(scalar(127.0, q.device))
    flat = torch.sign(c).mul_(c).mul_(c).mul_(scale[:, None])
    return flat.reshape(-1)[:size]


def quantize_blockwise(x: torch.Tensor) -> QTensor:
    """`x` (any shape) -> its `QTensor`."""
    n = x.numel()
    rows = -(-n // BLOCK)
    q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    flat = x.detach().float().reshape(-1)
    for a, b in chunks(n):
        quantize_into(flat[a:b], q[a // BLOCK:-(-b // BLOCK)],
                      scale[a // BLOCK:-(-b // BLOCK)])
    return QTensor(q, scale, n, tuple(x.shape))


def dequantize_blockwise(qv: QTensor) -> torch.Tensor:
    return dequantize_rows(qv.q, qv.scale, qv.size).reshape(qv.shape)


def _zero_state(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """quantize_blockwise(zeros): zero codes and unit scales."""
    rows = -(-p.numel() // BLOCK)
    return (torch.zeros((rows, BLOCK), dtype=torch.int8, device=p.device),
            torch.ones((rows,), dtype=torch.float32, device=p.device))


class Adam8bit(LeafOptimizer):
    """`adamw8bit(...)`'s optimizer: per parameter the codes and scales
    of mu and nu (``mu_q``, ``mu_scale``, ``nu_q``, ``nu_scale``), one
    count for the optimizer; `lr` a float or a schedule of the count of
    updates taken (the host's `schedule_count`)."""

    def __init__(self, params, lr: LearningRate = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=(b1, b2), eps=eps,
                                      weight_decay=weight_decay))
        self.count = torch.zeros((), dtype=torch.int32)
        self.schedule_count = torch.zeros((), dtype=torch.int32)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["mu_q"], st["mu_scale"] = _zero_state(p)
                    st["nu_q"], st["nu_scale"] = _zero_state(p)

    def begin_step(self, grads=None) -> Dict:
        t = int(self.count) + 1
        b1, b2 = self.param_groups[0]["betas"]
        f = np.float32
        return {"t": t, "dev": {},
                "host": {"bc1": f(1) - f(b1) ** f(t),
                         "bc2": f(1) - f(b2) ** f(t)}}

    @torch.no_grad()
    def update_leaf(self, p, group, ctx, grad=None) -> None:
        g_all = (p.grad if grad is None else grad).reshape(-1)
        st = self.state[p]
        s = device_scalars(ctx, p.device)
        b1, b2 = group["betas"]
        eps, wd = group["eps"], group["weight_decay"]
        lr = lr_at(group["lr"], int(self.schedule_count))
        pf = p.reshape(-1)
        for a, b in chunks(pf.numel(), CHUNK):
            ra, rb = a // BLOCK, -(-b // BLOCK)
            rows = {k: st[k][ra:rb] for k in st}
            g = g_all[a:b].float()
            m = dequantize_rows(rows["mu_q"], rows["mu_scale"], b - a)
            m.mul_(b1).add_(g.mul(1 - b1))
            v = dequantize_rows(rows["nu_q"], rows["nu_scale"], b - a)
            v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
            del g
            den = sqrt_(v.div(s["bc2"])).add_(eps)
            u = m.div(s["bc1"]).div_(den)
            del den
            quantize_into(m, rows["mu_q"], rows["mu_scale"])
            quantize_into(v, rows["nu_q"], rows["nu_scale"])
            del m, v
            AGD.apply_update(pf[a:b], u, lr, wd)

    def end_step(self, ctx) -> None:
        self.count.fill_(ctx["t"])
        self.schedule_count += 1

    def qtensors(self, p) -> Tuple[QTensor, QTensor]:
        st = self.state[p]
        return (QTensor(st["mu_q"], st["mu_scale"], p.numel(),
                        tuple(p.shape)),
                QTensor(st["nu_q"], st["nu_scale"], p.numel(),
                        tuple(p.shape)))

    def optax_tree(self, names: Dict[int, str]):
        """``(ScaleByAdam8bitState, EmptyState, schedule state)``: count,
        and mu and nu as trees of (codes, scales) pairs, JAX's `QTensor`
        children ``0`` and ``1``."""
        from ..trainer.train_step import nest

        ps = [p for g in self.param_groups for p in g["params"]]
        node = OrderedDict(count=self.count)
        for k in ("mu", "nu"):
            node[k] = nest({names[id(p)]: (self.state[p][k + "_q"],
                                           self.state[p][k + "_scale"])
                            for p in ps})
        sched = (OrderedDict(count=self.schedule_count)
                 if callable(self.param_groups[0]["lr"]) else ())
        return (node, (), sched), None


def adamw8bit(learning_rate: LearningRate = 1e-3, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0):
    """AdamW with int8 blockwise moments (~2 bytes a parameter of state
    instead of 8), as a factory ``params -> Adam8bit``."""
    def make(params):
        return Adam8bit(params, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay)
    return make
