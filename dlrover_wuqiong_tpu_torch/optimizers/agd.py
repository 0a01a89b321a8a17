"""AGD optimizer (NeurIPS'23) as a torch optimizer.

Parity: dlrover_wuqiong_tpu/optimizers/agd.py — `scale_by_agd` (:33-83)
and `agd` (:86-92), optax's ``chain(scale_by_agd, add_decayed_weights,
scale_by_learning_rate)``.  Per step t, for each leaf:

    m_t   = b1 m_{t-1} + (1-b1) g_t
    d_t   = m_t / (1-b1^t) - m_{t-1} / (1-b1^{t-1})     (d_1 = m_1/(1-b1))
    v_t   = b2 v_{t-1} + (1-b2) d_t^2
    den   = max(sqrt(v_t), delta * sqrt(1-b2^t))        (amsgrad: running max)
    u_t   = clip(m_t / den) * sqrt(1-b2^t) / (1-b1^t)
    w_t   = w_{t-1} - lr (u_t + wd w_{t-1})

The moments are float32 whatever the parameter's dtype, with one count
for the optimizer (optax's ``ScaleByAgdState``).  The step's scalars
(bias corrections, the floor) are float32 computed on the host, as jnp
computes them from the float32 count, and reach the device as 0-d
tensors: a tensor divisor, because torch divides a CUDA tensor by a
Python scalar as a multiply by its reciprocal.  Every product is its own
rounded operation (no fused multiply-add) and every root is correctly
rounded (`sqrt_`), so the card and the CPU give the same bits.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .leaf import LeafOptimizer

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]

#: elements of one leaf updated at a time: bounds the float32 transients
#: of a large leaf (a multiple of the int8 block, 256)
CHUNK = 1 << 26


def chunks(n: int, size: int = CHUNK):
    """[(start, stop)] over n elements in pieces of `size`."""
    return [(i, min(i + size, n)) for i in range(0, max(n, 1), size)]


def scalar(value, device) -> torch.Tensor:
    """A float32 0-d tensor on `device` holding `value` (a fill: no copy
    from the host's memory, nothing waits)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def sqrt_(t: torch.Tensor) -> torch.Tensor:
    """`t`'s square root in place, correctly rounded as jnp's and CUDA's
    are.  torch's vectorized CPU root is not always (0.5077966 gives one
    ulp below); the CPU takes it in float64, whose root rounds to the
    correctly rounded float32 one."""
    if t.device.type == "cpu":
        return t.copy_(t.double().sqrt_())
    return t.sqrt_()


def device_scalars(ctx: Dict, device) -> Dict[str, torch.Tensor]:
    """A step context's host scalars (``ctx["host"]``) as 0-d tensors on
    `device`, made once a step and device."""
    dev = ctx["dev"].get(device)
    if dev is None:
        dev = {k: scalar(v, device) for k, v in ctx["host"].items()}
        ctx["dev"][device] = dev
    return dev


def lr_at(lr: LearningRate, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


class AGD(LeafOptimizer):
    """`agd(...)`'s optimizer; `lr` a float or a schedule of the count of
    updates taken so far (optax's ``scale_by_schedule``), kept on the
    host as `schedule_count`."""

    def __init__(self, params, lr: LearningRate = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 delta: float = 1e-5, weight_decay: float = 0.0,
                 amsgrad: bool = False, clip: Optional[float] = None):
        super().__init__(params, dict(lr=lr, betas=betas, delta=delta,
                                      weight_decay=weight_decay,
                                      amsgrad=amsgrad, clip=clip))
        self.count = torch.zeros((), dtype=torch.int32)
        self.schedule_count = torch.zeros((), dtype=torch.int32)
        for group in self.param_groups:
            for p in group["params"]:
                self._init_leaf(p, group)

    def _init_leaf(self, p, group):
        st = self.state[p]
        if st:
            return
        zeros = lambda: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                    device=p.device)
        st["mu"] = zeros()
        st["nu"] = zeros()
        if group["amsgrad"]:
            st["max_nu"] = zeros()

    def begin_step(self, grads=None) -> Dict:
        t = int(self.count) + 1
        out = {"t": t, "dev": {}}
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        f = np.float32
        tf = f(t)
        bc1 = f(1) - f(b1) ** tf
        bc1_old = f(1) - f(b1) ** (tf - f(1)) if t > 1 else f(1)
        bc2 = f(1) - f(b2) ** tf
        sq = np.sqrt(bc2, dtype=f)
        out["host"] = {"bc1": bc1, "bc1_old": bc1_old, "sqrt_bc2": sq,
                       "floor": f(group["delta"]) * sq}
        return out

    @torch.no_grad()
    def update_leaf(self, p, group, ctx, grad=None) -> None:
        g_all = p.grad if grad is None else grad
        st = self.state[p]
        s = device_scalars(ctx, p.device)
        b1, b2 = group["betas"]
        lr = lr_at(group["lr"], int(self.schedule_count))
        wd, clip = group["weight_decay"], group["clip"]
        flat = lambda x: x.reshape(-1)  # noqa: E731
        pf, gf = flat(p), flat(g_all)
        mu, nu = flat(st["mu"]), flat(st["nu"])
        mx = flat(st["max_nu"]) if group["amsgrad"] else None
        for a, b in chunks(pf.numel()):
            g = gf[a:b].float()
            m_old = mu[a:b]
            m = m_old.mul(b1).add_(g.mul(1 - b1))
            d = m / s["bc1"]
            if ctx["t"] > 1:
                d.sub_(m_old / s["bc1_old"])
            m_old.copy_(m)
            v = nu[a:b]
            v.mul_(b2).add_(d.mul(1 - b2).mul_(d))
            del d
            if mx is not None:
                torch.maximum(mx[a:b], v, out=mx[a:b])
                den = sqrt_(mx[a:b].clone())
            else:
                den = sqrt_(v.clone())
            u = m.div_(torch.maximum(den, s["floor"]))
            del den
            if clip is not None:
                u.clamp_(-clip, clip)
            u.mul_(s["sqrt_bc2"]).div_(s["bc1"])
            self.apply_update(pf[a:b], u, lr, wd)

    @staticmethod
    def apply_update(p: torch.Tensor, u: torch.Tensor, lr: float,
                     wd: float) -> None:
        """optax's ``add_decayed_weights``, ``scale_by_learning_rate`` and
        ``apply_updates``: p + (-lr) (u + wd p), in float32, written back
        in p's dtype."""
        if wd:
            u.add_(p.float().mul(wd))
        u.mul_(-lr)
        if p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_(p.float().add_(u))

    def end_step(self, ctx) -> None:
        self.count.fill_(ctx["t"])
        self.schedule_count += 1

    def optax_tree(self, names: Dict[int, str]):
        """``(ScaleByAgdState, add_decayed_weights' EmptyState,
        scale_by_learning_rate's state)``: count, mu, nu (and max_nu),
        and the schedule's count where the lr is a schedule."""
        from ..trainer.train_step import nest

        ps = [p for g in self.param_groups for p in g["params"]]
        node = OrderedDict(count=self.count)
        for k in ("mu", "nu", "max_nu"):
            if k in self.state[ps[0]]:
                node[k] = nest({names[id(p)]: self.state[p][k] for p in ps})
        sched = (OrderedDict(count=self.schedule_count)
                 if callable(self.param_groups[0]["lr"]) else ())
        return (node, (), sched), None


def agd(learning_rate: LearningRate = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999), delta: float = 1e-5,
        weight_decay: float = 0.0, amsgrad: bool = False,
        clip: Optional[float] = None):
    """AGD with decoupled weight decay, as a factory ``params -> AGD``."""
    def make(params):
        return AGD(params, lr=learning_rate, betas=betas, delta=delta,
                   weight_decay=weight_decay, amsgrad=amsgrad, clip=clip)
    return make
