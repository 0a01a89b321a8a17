"""`auto_accelerate` on one device: model + optimizer -> a ready train step.

Parity: dlrover_wuqiong_tpu/auto/accelerate.py — `auto_accelerate` (:446),
`AccelerateResult` (:289), and the strategy registry (`register_strategy`
:56, `StrategyContext` :63, `resolve_strategy` :258), the one-device
slice: no mesh, no compile cache.  It materializes the model's
parameters on the device (seeded flax-layout init), builds the
optimizer over them (default
``adamw(3e-4)``, the JAX default ``optax.adamw(3e-4)``), and returns the
train step of `trainer.train_step.make_train_step`::

    res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4))
    res.state, m = res.train_step(res.state, res.place_batch(
        {"input_ids": ids, "labels": labels}))

The model is any port model with ``init_params(seed, device)`` that maps
(B, T) token ids to logits: ``models.gpt.GPT`` or ``models.llama.Llama``.

The one-device strategies rebuild the model with
``dataclasses.replace(cfg, **overrides)`` before its init (JAX's
`model_overrides`, the config fields the model has):

    ("amp" | "amp_native" | "half", {"enabled", "fp8", "filter"})
        bf16 compute (float32 with enabled=False); fp8 projections
    ("checkpoint", {"enabled", "policy", "names"})
        remat, its policy (checked at once) and the *_names anchors
    ("module_replace", {"enabled"})   the flash route on or off
    ("grad_accum", {"steps"})         microbatches a step

and the optimizer strategies (JAX :235-248, :598-604, :684-694):

    ("stable_bf16" | "bf16_optimizer", {"master"})
        bf16 parameters (cast after the seeded float32 init), the
        optimizer wrapped in `optimizers.bf16_stable.StableBF16`
        (Kahan compensation, or float32 masters with master=True)
    ("optimizer_offload", {"enabled"})
        the optimizer state in pinned host memory between steps; the
        update moves it to the device and back leaf by leaf
        (`optimizers.leaf.offload_state`)

With optimizer_offload or an offload_* remat policy, the host link is
probed once at resolve time (`common.util.measure_h2d_gbps`) and a slow
one warns with its rate (JAX `_warn_slow_offload_link` :402-443).

The JAX package's other strategy names raise with the ROADMAP item that
ports them: the mesh strategies (item 8a; "sequence_parallel" 8b;
"pipeline_parallel", "local_sgd" and "hsdp" 8c).  So does more than one
device (item 8a).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..common.log import get_logger
from ..trainer.train_step import (
    OptimizerFactory,
    TrainState,
    adamw,
    ensure_state,
    make_lm_loss,
    make_train_step,
)

logger = get_logger("accelerate")

# strategy registry: name -> handler(ctx, cfg)
_STRATEGY_REGISTRY: Dict[str, Callable] = {}


def register_strategy(name: str):
    def deco(fn):
        _STRATEGY_REGISTRY[name] = fn
        return fn
    return deco


@dataclasses.dataclass
class StrategyContext:
    accum_steps: int = 1
    # tri-state: None = keep the model's own config; True/False = override
    amp: Optional[bool] = None  # bf16 compute
    remat: Optional[bool] = None
    flash_attention: Optional[bool] = None
    extra: Dict = dataclasses.field(default_factory=dict)

    def model_overrides(self, model) -> Dict[str, Any]:
        """The flags as the model config's field values (only fields the
        config has, and only those that change)."""
        cfg = getattr(model, "config", None)
        if cfg is None or not dataclasses.is_dataclass(cfg):
            return {}
        fields = {f.name for f in dataclasses.fields(cfg)}
        out: Dict[str, Any] = {}
        if self.amp is not None and "dtype" in fields:
            out["dtype"] = torch.bfloat16 if self.amp else torch.float32
        if self.remat is not None and "remat" in fields:
            out["remat"] = self.remat
        if self.extra.get("remat_policy") and "remat_policy" in fields:
            out["remat_policy"] = self.extra["remat_policy"]
        if self.extra.get("remat_names") and "remat_names" in fields:
            out["remat_names"] = self.extra["remat_names"]
        if self.flash_attention is not None and \
                "use_flash_attention" in fields:
            out["use_flash_attention"] = self.flash_attention
        if self.extra.get("fp8") and "fp8" in fields:
            out["fp8"] = True
            if self.extra.get("fp8_filter") and "fp8_filter" in fields:
                out["fp8_filter"] = self.extra["fp8_filter"]
        return {k: v for k, v in out.items() if getattr(cfg, k) != v}


#: JAX strategy names whose port is still to come -> the ROADMAP item
_NOT_PORTED = {
    **dict.fromkeys(("fsdp", "zero2", "zero3", "data_parallel", "ddp",
                     "tensor_parallel", "expert_parallel", "multi_slice"),
                    "8a"),
    "sequence_parallel": "8b",
    **dict.fromkeys(("pipeline_parallel", "local_sgd", "hsdp"), "8c"),
}


def _not_ported(name: str, item: str) -> Callable:
    def handler(ctx: StrategyContext, cfg: Dict):
        raise ValueError(f"strategy {name!r} is not ported yet (ROADMAP "
                         f"queue 1 item {item}); the port trains on one "
                         "device with amp, checkpoint, module_replace, "
                         "grad_accum, stable_bf16 and optimizer_offload")
    return handler


for _name, _item in _NOT_PORTED.items():
    register_strategy(_name)(_not_ported(_name, _item))


@register_strategy("amp")
@register_strategy("amp_native")
@register_strategy("half")
def _s_amp(ctx: StrategyContext, cfg: Dict):
    """bf16 compute; with {"fp8": True} the name-filtered projections
    also become `Fp8Dense` (`filter` replaces the config's filter)."""
    ctx.amp = cfg.get("enabled", True)
    if cfg.get("fp8"):
        ctx.extra["fp8"] = True
        if cfg.get("filter"):
            ctx.extra["fp8_filter"] = tuple(cfg["filter"])


@register_strategy("checkpoint")
def _s_ckpt(ctx: StrategyContext, cfg: Dict):
    """cfg: enabled, policy (`ops.remat.POLICIES`; an unknown one raises
    here), names (the *_names policies' anchors)."""
    ctx.remat = cfg.get("enabled", True)
    if cfg.get("policy") is not None:
        from ..ops.remat import resolve_remat_policy

        resolve_remat_policy(cfg["policy"])
        ctx.extra["remat_policy"] = cfg["policy"]
    if cfg.get("names"):
        ctx.extra["remat_names"] = tuple(cfg["names"])


@register_strategy("module_replace")
def _s_module_replace(ctx: StrategyContext, cfg: Dict):
    ctx.flash_attention = cfg.get("enabled", True)


@register_strategy("grad_accum")
def _s_accum(ctx: StrategyContext, cfg: Dict):
    ctx.accum_steps = cfg.get("steps", 1)


@register_strategy("stable_bf16")
@register_strategy("bf16_optimizer")
def _s_stable_bf16(ctx: StrategyContext, cfg: Dict):
    """bf16 parameters trained stably: Kahan compensation (default) or
    float32 master weights ({"master": True})."""
    ctx.extra["stable_bf16"] = {"master": bool(cfg.get("master", False))}


@register_strategy("optimizer_offload")
def _s_opt_offload(ctx: StrategyContext, cfg: Dict):
    """The optimizer state in pinned host memory between steps."""
    ctx.extra["optimizer_offload"] = cfg.get("enabled", True)


def _warn_slow_offload_link(ctx: StrategyContext, device,
                            num_params: int) -> None:
    """Resolve-time host-to-device probe for the offload strategies.

    optimizer_offload and the offload_* remat policies move state or
    activations across the host link every step.  On a slow link they
    deliver a step-time regression of several times; measure once, log
    the rate, and warn with the estimated per-step cost when the traffic
    cannot be hidden.  ``DWT_H2D_GBPS`` pins or overrides the probe."""
    offload_opt = bool(ctx.extra.get("optimizer_offload"))
    offload_acts = str(ctx.extra.get("remat_policy", "")).startswith(
        "offload")
    if not (offload_opt or offload_acts):
        return
    try:
        from ..common.util import measure_h2d_gbps

        gbps = measure_h2d_gbps(device)
    except Exception:  # noqa: BLE001: a failed probe must not break
        logger.debug("h2d probe failed", exc_info=True)
        return
    what = " + ".join(filter(None, [
        "optimizer_offload" if offload_opt else "",
        f"remat {ctx.extra.get('remat_policy')}" if offload_acts else ""]))
    est = None
    if offload_opt and num_params:
        # adam moments f32 both ways, on one device
        est = 2 * 8 * num_params / (gbps * 1e9)
    if gbps < 1.0 or (est is not None and est > 1.0):
        logger.warning(
            "%s selected on a slow host link: measured H2D %.3f GB/s%s — "
            "expect the offload traffic to DOMINATE step time.  Set "
            "DWT_H2D_GBPS to override the probe.", what, gbps,
            f", est. {est:.1f}s/step moment traffic per device"
            if est is not None else "")
    else:
        logger.info("%s: measured H2D %.1f GB/s%s", what, gbps,
                    f", est. {est * 1e3:.0f}ms/step moment traffic"
                    if est is not None else "")


def resolve_strategy(strategy: Optional[Sequence]) -> StrategyContext:
    """Each (name, cfg) item (or a bare name) through its handler, in
    order; no strategy leaves every flag at None."""
    ctx = StrategyContext()
    for item in strategy or ():
        name, cfg = item if isinstance(item, (tuple, list)) else (item, {})
        handler = _STRATEGY_REGISTRY.get(name)
        if handler is None:
            raise ValueError(f"unknown optimization strategy: {name!r}; "
                             f"known: {sorted(_STRATEGY_REGISTRY)}")
        handler(ctx, cfg or {})
    return ctx


@dataclasses.dataclass
class AccelerateResult:
    train_step: Callable
    state: TrainState
    loss_fn: Callable
    model: Any  # the (strategy-rebuilt) model, trained in place
    device: torch.device
    strategy: StrategyContext = dataclasses.field(
        default_factory=StrategyContext)
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
    """Resolve `strategy`, rebuild `model` with its overrides, initialize
    it on `device` (default ``cuda``) from `seed`, and build the
    optimizer and the train step.

    `optimizer` is a factory ``params -> torch.optim.Optimizer`` (None:
    ``adamw(3e-4)``); `loss_fn(params, batch)` defaults to the LM loss
    over {input_ids, labels}.  `accum_steps` replaces the strategy's.
    ``fused_steps=K > 1`` makes `train_step` the fused K-step driver; any
    K is also available through `AccelerateResult.fused_train_step`.
    """
    if devices is not None and len(devices) > 1:
        raise ValueError(
            f"{len(devices)} devices: multi-device training is not ported "
            "yet (ROADMAP queue 1 item 8a)")
    ctx = resolve_strategy(strategy)
    if accum_steps:
        ctx.accum_steps = accum_steps
    overrides = ctx.model_overrides(model)
    if overrides:
        model = type(model)(dataclasses.replace(model.config, **overrides))
    device = resolve_device(device)
    model.init_params(seed, device)
    optimizer = optimizer or adamw(3e-4)
    sb = ctx.extra.get("stable_bf16")
    offload = bool(ctx.extra.get("optimizer_offload"))
    if sb is not None:
        if offload:
            raise ValueError("stable_bf16 with optimizer_offload is not "
                             "ported: offload an optimizer over float32 "
                             "parameters, or keep the bf16 state on the "
                             "device")
        from ..optimizers.bf16_stable import stable_bf16

        # bf16 parameters, not just bf16 compute; stable_bf16 keeps the
        # updates from vanishing below the bf16 ulp
        with torch.no_grad():
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(torch.bfloat16)
        optimizer = stable_bf16(optimizer, master=sb["master"])
    _warn_slow_offload_link(ctx, device,
                            sum(p.numel() for p in model.parameters()))
    loss = loss_fn or make_lm_loss()
    state = TrainState.create(model, optimizer)
    if offload:
        from ..optimizers.leaf import offload_state

        offload_state(state.opt_state, ensure_state)
    step = make_train_step(loss, ctx.accum_steps, fused_steps)
    return AccelerateResult(train_step=step, state=state, loss_fn=loss,
                            model=model, device=device, strategy=ctx,
                            accum_steps=ctx.accum_steps,
                            fused_steps=max(fused_steps, 1))
