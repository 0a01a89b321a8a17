"""`auto_accelerate` on one device: model + optimizer -> a ready train step.

Parity: dlrover_wuqiong_tpu/auto/accelerate.py — `auto_accelerate` (:446)
and `AccelerateResult` (:289), the one-device slice: no strategy, no mesh,
no compile cache.  It materializes the model's parameters on the device
(seeded flax-layout init), builds the optimizer over them (default
``adamw(3e-4)``, the JAX default ``optax.adamw(3e-4)``), and returns the
train step of `trainer.train_step.make_train_step`::

    res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4))
    res.state, m = res.train_step(res.state, res.place_batch(
        {"input_ids": ids, "labels": labels}))

The model is any port model with ``init_params(seed, device)`` that maps
(B, T) token ids to logits: ``models.gpt.GPT`` or ``models.llama.Llama``.

Sharding strategies and more than one device raise: they come with the
port of ``parallel/`` (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..trainer.train_step import (
    OptimizerFactory,
    TrainState,
    adamw,
    make_lm_loss,
    make_train_step,
)


@dataclasses.dataclass
class AccelerateResult:
    train_step: Callable
    state: TrainState
    loss_fn: Callable
    model: Any
    device: torch.device
    accum_steps: int = 1
    fused_steps: int = 1
    _fused_cache: Dict[int, Callable] = dataclasses.field(
        default_factory=dict)

    def fused_train_step(self, fused_steps: int) -> Callable:
        """The K-step fused driver ``step(state, batches)`` (K = 1: the
        plain step); batch leaves carry a leading axis of size K."""
        k = max(int(fused_steps), 1)
        if k == self.fused_steps:
            return self.train_step
        fn = self._fused_cache.get(k)
        if fn is None:
            fn = make_train_step(self.loss_fn, self.accum_steps, k)
            self._fused_cache[k] = fn
        return fn

    def place_batch(self, batch: Dict) -> Dict:
        """Host batch (numpy arrays or tensors) -> int64 tensors on the
        device.  Leading microbatch (and fused) axes pass through."""
        def put(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            return torch.as_tensor(x).to(self.device, torch.int64,
                                         non_blocking=True)

        return {k: put(v) for k, v in batch.items()}

    def place_fused_batch(self, batch: Dict) -> Dict:
        """`place_batch` for a fused batch (leading axis of size K)."""
        return self.place_batch(batch)


def auto_accelerate(model, optimizer: Optional[OptimizerFactory] = None,
                    loss_fn: Optional[Callable] = None,
                    accum_steps: Optional[int] = None, fused_steps: int = 1,
                    device=None, seed: int = 0,
                    strategy: Optional[Sequence] = None,
                    devices: Optional[Sequence] = None) -> AccelerateResult:
    """Initialize `model` on `device` (default ``cuda``) from `seed`, build
    the optimizer and the train step.

    `optimizer` is a factory ``params -> torch.optim.Optimizer`` (None:
    ``adamw(3e-4)``); `loss_fn(params, batch)` defaults to the LM loss
    over {input_ids, labels}.  ``fused_steps=K > 1`` makes `train_step`
    the fused K-step driver; any K is also available through
    `AccelerateResult.fused_train_step`.
    """
    if strategy:
        raise ValueError(
            f"strategy {list(strategy)!r}: sharding strategies are not "
            "ported yet (ROADMAP queue 1 item 8); the port trains on one "
            "device")
    if devices is not None and len(devices) > 1:
        raise ValueError(
            f"{len(devices)} devices: multi-device training is not ported "
            "yet (ROADMAP queue 1 item 8)")
    device = resolve_device(device)
    model.init_params(seed, device)
    loss = loss_fn or make_lm_loss()
    accum = accum_steps or 1
    state = TrainState.create(model, optimizer or adamw(3e-4))
    step = make_train_step(loss, accum, fused_steps)
    return AccelerateResult(train_step=step, state=state, loss_fn=loss,
                            model=model, device=device, accum_steps=accum,
                            fused_steps=max(fused_steps, 1))
