"""`auto_accelerate`: model + optimizer -> a ready train step, on one
device or over a ``torch.distributed`` world.

Parity: dlrover_wuqiong_tpu/auto/accelerate.py — `auto_accelerate` (:446),
`AccelerateResult` (:289), and the strategy registry (`register_strategy`
:56, `StrategyContext` :63, the mesh strategies :99-156,
`resolve_strategy` :258), without the compile cache.  It materializes
the model's parameters on the device (seeded flax-layout init), builds
the optimizer over them (default ``adamw(3e-4)``, the JAX default
``optax.adamw(3e-4)``), and returns the train step of
`trainer.train_step.make_train_step`::

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
        (`optimizers.leaf.offload_state`); with stable_bf16 the whole
        `StableBF16` state (inner moments, and compensation or masters),
        as JAX offloads the whole ``opt_state``

With optimizer_offload or an offload_* remat policy, the host link is
probed once at resolve time (`common.util.measure_h2d_gbps`) and a slow
one warns with its rate (JAX `_warn_slow_offload_link` :402-443).

and the mesh strategies (JAX :99-156), which size the dims of a
`parallel.mesh.MeshPlan` (an unset data dim takes the devices left):

    ("fsdp" | "zero3" | "zero2", {"size"})   fsdp; zero2 keeps each
        block's gathered parameters from its forward to its backward
    ("data_parallel" | "ddp", {"size"})      dp
    ("tensor_parallel", {"size"})            tp, the DTensor route (also
        at size 1)
    ("multi_slice", {"slices", "devices_per_slice", "tp", "sp"})
        dp over slices, fsdp (and tp) inside a slice
    ("expert_parallel", {"size"})     ep: the expert stacks over ep
        (`parallel.sharding.MOE_RULES`), tokens replicated over it
    ("sequence_parallel", {"size", "impl"})
        sp: each rank a chunk of the sequence, attention across them by
        `parallel.long_context` ("ulysses", the default, "ring", or
        "gspmd": keys and values gathered); the model config's
        ``attn_impl`` is rewritten (JAX :523-541, which leaves "gspmd"
        to XLA; the port names the route).  Under every mesh strategy
        the config's ``mesh`` is the mesh

The devices are the ranks of the default process group (`devices`, if
given, must count them; a single device given is this rank alone);
without a group, the world is one device and no mesh is built, as
before.  With a mesh strategy named, or more than one
device, the model is built on ``meta`` and sharded by construction
(`parallel.fsdp`): each rank materializes its own pieces of each leaf
from the seeded init, the optimizer state takes the parameters'
placements, and `AccelerateResult.place_batch` gives the rank its slice
of the global batch.  ``materialize=False`` stops before any allocation:
the state is meta DTensors with their placements and local shapes (the
port of JAX's AOT scale proof).

and DiLoCo two-level training (JAX :191-196, :600-662):

    ("local_sgd" | "hsdp", {"sync_every", "outer_lr", "outer_momentum",
                            "nesterov", "reduce", "gta_threshold"})
        the dp dim holds replica groups that train apart, fsdp inside
        each group, and sync every `sync_every` steps through an outer
        Nesterov step (`parallel.local_sgd`); needs ("data_parallel",
        {"size": R >= 2}).  `AccelerateResult.state` is then a
        `parallel.local_sgd.DiLoCoState`.  It composes with grad_accum
        (accumulation inside the group), stable_bf16 (the outer sync
        re-anchors the compensation or masters) and optimizer_offload
        (the inner optimizer state in pinned host memory between steps,
        the outer trees on the device); it refuses fused_steps > 1,
        materialize=False, and tp, sp or ep above 1.

and pipeline parallelism (JAX :158-188, :547-595):

    ("pipeline_parallel", {"size", "microbatches", "schedule",
                           "virtual_stages", "head_loss"})
        pp stages over the mesh's ``pp`` dim (`parallel.pipeline`): each
        rank builds its stage's blocks (layers divisible by pp) and the
        embedding and head leaves, in ``microbatches`` microbatches
        (default `default_pp_microbatches`: max(grad_accum, 2 pp)).
        ``schedule`` "gpipe" (the default) or "interleaved" (with
        ``virtual_stages`` >= 2 chunks a stage, microbatches divisible
        by pp) train through a whole-batch `loss_fn` and the fill-drain
        backward; "1f1b" trains through its own step and refuses a
        `loss_fn` (``head_loss(head_params, h, labels)``, a loss a
        microbatch, replaces the cross-entropy; only there, and only at
        size >= 2).  `AccelerateResult.model` is the rank's
        `PipelinedLM` stage and `value_and_grad_fn` its step.  The
        stage is sharded over fsdp, dp, tp, sp and ep inside its pp
        coordinate; `local_sgd` with it is refused before any init.

With sp or ep of size 1 the build is the one without them (the attention
falls through to flash, as in JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..common.log import get_logger
from ..parallel.mesh import (
    MeshPlan,
    auto_plan,
    build_mesh,
    detect_hbm_per_device,
    hybrid_slice_plan,
)
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
    plan: MeshPlan = dataclasses.field(default_factory=MeshPlan)
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


#: the strategies that shard the state over a mesh
MESH_STRATEGIES = ("fsdp", "zero2", "zero3", "data_parallel", "ddp",
                   "tensor_parallel", "multi_slice", "expert_parallel",
                   "sequence_parallel", "local_sgd", "hsdp",
                   "pipeline_parallel")

#: sequence_parallel's impls (`parallel.long_context.SP_ATTENTION`)
SP_IMPLS = ("ulysses", "ring", "gspmd")


@register_strategy("fsdp")
@register_strategy("zero3")
def _s_fsdp(ctx: StrategyContext, cfg: Dict, num_devices: int):
    ctx.plan.fsdp = cfg.get("size", 0) or 0  # 0 -> fill remaining
    ctx.extra["mesh"] = True


@register_strategy("zero2")
def _s_zero2(ctx: StrategyContext, cfg: Dict, num_devices: int):
    """zero3's sharding; each block keeps its gathered parameters from
    its forward to its backward (the same numbers, more memory)."""
    _s_fsdp(ctx, cfg, num_devices)
    ctx.extra["reshard_after_forward"] = False


@register_strategy("data_parallel")
@register_strategy("ddp")
def _s_dp(ctx: StrategyContext, cfg: Dict, num_devices: int):
    ctx.plan.dp = cfg.get("size", 0) or 0
    ctx.extra["mesh"] = True


@register_strategy("tensor_parallel")
def _s_tp(ctx: StrategyContext, cfg: Dict, num_devices: int):
    """cfg: size (default 1).  Every size, 1 included, makes the
    parameters DTensors over the mesh's ``tp`` dim: at size 1 the numbers
    are those of the build without it, and the step pays DTensor's host
    dispatch (GPT-2 124M, B = 24, T = 1024 on one NVIDIA H100 80GB HBM3
    at 700 W: 248-270 ms a step against 141-143 ms under fsdp alone,
    chip_smoke.py phase 14.1).  Leave it out where tp would be 1."""
    ctx.plan.tp = cfg.get("size", 1)
    ctx.extra["mesh"] = True
    ctx.extra["tensor_parallel"] = True


@register_strategy("sequence_parallel")
def _s_sp(ctx: StrategyContext, cfg: Dict, num_devices: int):
    """cfg: size (default 1), impl: "ulysses" (all-to-all head scatter,
    the default) | "ring" (KV rotation, O(S/sp) memory) | "gspmd" (KV
    all-gathered)."""
    impl = cfg.get("impl", "ulysses")
    if impl not in SP_IMPLS:
        raise ValueError(f"sequence_parallel impl {impl!r}: one of "
                         f"{SP_IMPLS}")
    ctx.plan.sp = cfg.get("size", 1)
    ctx.extra["sp_impl"] = impl
    ctx.extra["mesh"] = True


@register_strategy("expert_parallel")
def _s_ep(ctx: StrategyContext, cfg: Dict, num_devices: int):
    ctx.plan.ep = cfg.get("size", 1)
    ctx.extra["mesh"] = True


@register_strategy("multi_slice")
def _s_multi_slice(ctx: StrategyContext, cfg: Dict, num_devices: int):
    """dp spans the slices, fsdp/tp/sp stay inside a slice, so only the
    dp gradient reduction crosses the slow links.  dp is the outermost
    mesh dim: rank order is slice-major (slice 0's ranks first).  cfg:
    slices (required), devices_per_slice (default: evenly divided), tp,
    sp."""
    slices = int(cfg.get("slices", 2))
    if slices < 2:
        raise ValueError("multi_slice needs slices >= 2")
    per = int(cfg.get("devices_per_slice") or num_devices // slices)
    if slices * per != num_devices:
        raise ValueError(
            f"multi_slice: {slices} slices x {per} devices/slice != "
            f"{num_devices} devices")
    tp, sp = int(cfg.get("tp", 1)), int(cfg.get("sp", 1))
    if per % (tp * sp):
        raise ValueError(
            f"multi_slice: tp={tp} x sp={sp} must divide the "
            f"{per} devices of a slice (fsdp fills the quotient)")
    ctx.plan = hybrid_slice_plan(slices, per, tp=tp, sp=sp)
    ctx.extra["mesh"] = True
    if tp > 1:
        ctx.extra["tensor_parallel"] = True


@register_strategy("pipeline_parallel")
def _s_pp(ctx: StrategyContext, cfg: Dict, num_devices: int):
    """cfg: size, microbatches, schedule ("gpipe" | "interleaved" | "1f1b"),
    virtual_stages (interleaved chunk count per device), head_loss (1f1b
    only: per-microbatch (head_params, h, labels) -> scalar loss)."""
    from ..parallel.pipeline import check_schedule

    ctx.plan.pp = cfg.get("size", 1)
    ctx.extra["mesh"] = True
    ctx.extra["pp_microbatches"] = cfg.get("microbatches")
    schedule = cfg.get("schedule", "gpipe")
    check_schedule(schedule)
    virtual = cfg.get("virtual_stages", 2 if schedule == "interleaved" else 1)
    if schedule == "interleaved" and virtual < 2:
        raise ValueError("interleaved schedule needs virtual_stages >= 2 — "
                         "with 1 chunk per device it degenerates to gpipe")
    if schedule != "interleaved" and virtual > 1:
        raise ValueError(f"virtual_stages={virtual} only applies to "
                         "schedule='interleaved'")
    ctx.extra["pp_schedule"] = schedule
    ctx.extra["pp_virtual_stages"] = virtual
    if cfg.get("head_loss") is not None:
        if schedule != "1f1b":
            raise ValueError(
                "head_loss only applies to schedule='1f1b' (gpipe/"
                "interleaved take a whole-batch loss_fn instead)")
        if ctx.plan.pp <= 1:
            raise ValueError(
                "head_loss needs ('pipeline_parallel', {'size': >= 2, "
                "...}) — with pp=1 no pipeline is built and the custom "
                "objective would silently fall back to cross-entropy")
        ctx.extra["pp_head_loss"] = cfg["head_loss"]


@register_strategy("local_sgd")
@register_strategy("hsdp")
def _s_local_sgd(ctx: StrategyContext, cfg: Dict, num_devices: int):
    """DiLoCo two-level training over the dp dim (parallel/local_sgd.py).
    cfg: `parallel.local_sgd.LocalSGDConfig`'s fields."""
    ctx.extra["local_sgd"] = dict(cfg)
    ctx.extra["mesh"] = True


@register_strategy("amp")
@register_strategy("amp_native")
@register_strategy("half")
def _s_amp(ctx: StrategyContext, cfg: Dict, num_devices: int):
    """bf16 compute; with {"fp8": True} the name-filtered projections
    also become `Fp8Dense` (`filter` replaces the config's filter)."""
    ctx.amp = cfg.get("enabled", True)
    if cfg.get("fp8"):
        ctx.extra["fp8"] = True
        if cfg.get("filter"):
            ctx.extra["fp8_filter"] = tuple(cfg["filter"])


@register_strategy("checkpoint")
def _s_ckpt(ctx: StrategyContext, cfg: Dict, num_devices: int):
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
def _s_module_replace(ctx: StrategyContext, cfg: Dict, num_devices: int):
    ctx.flash_attention = cfg.get("enabled", True)


@register_strategy("grad_accum")
def _s_accum(ctx: StrategyContext, cfg: Dict, num_devices: int):
    ctx.accum_steps = cfg.get("steps", 1)


@register_strategy("stable_bf16")
@register_strategy("bf16_optimizer")
def _s_stable_bf16(ctx: StrategyContext, cfg: Dict, num_devices: int):
    """bf16 parameters trained stably: Kahan compensation (default) or
    float32 master weights ({"master": True})."""
    ctx.extra["stable_bf16"] = {"master": bool(cfg.get("master", False))}


@register_strategy("optimizer_offload")
def _s_opt_offload(ctx: StrategyContext, cfg: Dict, num_devices: int):
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


def resolve_strategy(strategy: Optional[Sequence], num_devices: int = 1,
                     num_params: Optional[int] = None,
                     seq_len: int = 0,
                     hbm_per_device: Optional[int] = None) -> StrategyContext:
    """Each (name, cfg) item (or a bare name) through its handler, in
    order, then the unset data dim filled with the devices left (JAX
    :256-290); no strategy takes `parallel.mesh.auto_plan`'s plan."""
    ctx = StrategyContext()
    if not strategy:
        ctx.plan = auto_plan(
            num_devices, num_params, seq_len=seq_len,
            hbm_per_device=hbm_per_device or detect_hbm_per_device())
        return ctx
    for item in strategy:
        name, cfg = item if isinstance(item, (tuple, list)) else (item, {})
        handler = _STRATEGY_REGISTRY.get(name)
        if handler is None:
            raise ValueError(f"unknown optimization strategy: {name!r}; "
                             f"known: {sorted(_STRATEGY_REGISTRY)}")
        handler(ctx, cfg or {}, num_devices)
    # fill the unset data dim with remaining devices (domination rule)
    fixed = (ctx.plan.tp * ctx.plan.sp * ctx.plan.pp * ctx.plan.ep)
    remaining = num_devices // fixed
    if ctx.plan.fsdp == 0 and ctx.plan.dp == 0:
        ctx.plan.fsdp, ctx.plan.dp = remaining, 1
    elif ctx.plan.fsdp == 0:
        ctx.plan.fsdp = max(1, remaining // max(1, ctx.plan.dp))
    elif ctx.plan.dp == 0:
        ctx.plan.dp = max(1, remaining // max(1, ctx.plan.fsdp))
    ctx.plan.validate(num_devices)
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
    # the sharded build's mesh side (parallel.fsdp.MeshState), or None
    mesh_state: Any = None
    # the pipeline's step (make_train_step's value_and_grad_fn), or None
    value_and_grad_fn: Optional[Callable] = None
    _fused_cache: Dict[int, Callable] = dataclasses.field(
        default_factory=dict)

    def fused_train_step(self, fused_steps: int) -> Callable:
        """The K-step fused driver ``step(state, batches)`` (K = 1: the
        plain step); batch leaves carry a leading axis of size K."""
        k = max(int(fused_steps), 1)
        if k == self.fused_steps:
            return self.train_step
        if self.strategy.extra.get("local_sgd") is not None:
            raise ValueError(_NO_FUSED_LOCAL_SGD)
        fn = self._fused_cache.get(k)
        if fn is None:
            fn = make_train_step(self.loss_fn, self.accum_steps, k,
                                 self.value_and_grad_fn)
            self._fused_cache[k] = fn
        return fn

    def place_batch(self, batch: Dict, seq_axis: Optional[int] = None,
                    batch_axis: Optional[int] = None) -> Dict:
        """Host batch (numpy arrays or tensors) -> int64 tensors on the
        device.  Leading microbatch (and fused) axes pass through.  On a
        mesh the batch is the global one and the rank keeps its slice
        of the batch dim over (dp, fsdp) and, under sequence parallel, of
        `seq_axis` (default: the dim after the batch dim) over sp."""
        if self.mesh_state is not None:
            if batch_axis is None:
                batch_axis = 1 if self.accum_steps > 1 else 0
            if seq_axis is None:
                seq_axis = batch_axis + 1
            micro = getattr(self.model, "num_microbatches", 1) \
                if self.strategy.plan.pp > 1 else 1
            batch = self.mesh_state.planner.place_batch(batch, batch_axis,
                                                        seq_axis, micro)

        def put(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            return torch.as_tensor(x).to(self.device, torch.int64,
                                         non_blocking=True)

        return {k: put(v) for k, v in batch.items()}

    def place_fused_batch(self, batch: Dict) -> Dict:
        """`place_batch` for a fused batch (leading axis of size K)."""
        return self.place_batch(batch, batch_axis=1 + (
            1 if self.accum_steps > 1 else 0))


_NO_FUSED_LOCAL_SGD = (
    "fused_steps > 1 does not compose with local_sgd — the DiLoCo step's "
    "outer sync counts dispatches, and a K-step fusion would scan across "
    "sync boundaries; run unfused (fused_steps=1)")


def _check_local_sgd(ctx: StrategyContext, fused_steps: int,
                     materialize: bool) -> None:
    """JAX's refusals of a local_sgd build (:501-505, :607-612,
    :638-645), before any parameter is made, and the port's own: no tp,
    sp or ep inside a group."""
    if fused_steps > 1:
        raise ValueError(_NO_FUSED_LOCAL_SGD)
    if not materialize:
        raise ValueError("materialize=False (AOT scale-proof) does not "
                         "support local_sgd — its outer and inner trees "
                         "are copies of materialized params")
    if ctx.plan.dp < 2:
        raise ValueError(
            "local_sgd needs ('data_parallel', {'size': R>=2}) — the dp "
            "axis carries the locally-training replica groups")
    inside = {a: getattr(ctx.plan, a) for a in ("tp", "sp", "ep")
              if getattr(ctx.plan, a) > 1}
    if inside:
        raise NotImplementedError(
            f"local_sgd with {inside} is not ported: a replica group is "
            "fsdp over its ranks (dp x fsdp)")


def _world(devices: Optional[Sequence]) -> int:
    """The number of devices: one for a single device given (this rank
    alone, whatever the world), else the default process group's world
    (which `devices`, if given, must count), or one without a group."""
    import torch.distributed as dist

    if devices is not None and len(devices) == 1:
        return 1
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if devices is not None and len(devices) != world:
            raise ValueError(f"{len(devices)} devices given in a "
                             f"torch.distributed world of {world}: each "
                             "rank holds one device")
        return world
    if devices is not None and len(devices) > 1:
        raise ValueError(
            f"{len(devices)} devices: initialize a torch.distributed "
            f"world of {len(devices)} (one rank a device) first")
    return 1


def auto_accelerate(model, optimizer: Optional[OptimizerFactory] = None,
                    loss_fn: Optional[Callable] = None,
                    accum_steps: Optional[int] = None, fused_steps: int = 1,
                    device=None, seed: int = 0,
                    strategy: Optional[Sequence] = None,
                    devices: Optional[Sequence] = None,
                    materialize: bool = True,
                    seq_len: int = 0) -> AccelerateResult:
    """Resolve `strategy`, rebuild `model` with its overrides, initialize
    it on `device` (default ``cuda``) from `seed`, and build the
    optimizer and the train step.

    `optimizer` is a factory ``params -> torch.optim.Optimizer`` (None:
    ``adamw(3e-4)``); `loss_fn(params, batch)` defaults to the LM loss
    over {input_ids, labels}.  `accum_steps` replaces the strategy's.
    ``fused_steps=K > 1`` makes `train_step` the fused K-step driver; any
    K is also available through `AccelerateResult.fused_train_step`.
    `devices` and `materialize` as in the module docstring; `seq_len`
    feeds `parallel.mesh.auto_plan` when no strategy is given.
    """
    import torch.distributed as dist

    num_devices = _world(devices)
    names = {(i[0] if isinstance(i, (tuple, list)) else i)
             for i in strategy or ()}
    sharded = num_devices > 1 or bool(names & set(MESH_STRATEGIES))
    if sharded and not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"strategy {sorted(names & set(MESH_STRATEGIES))} shards over "
            "a torch.distributed world: initialize the default process "
            "group first (a world of one is fine)")
    device = resolve_device(device)
    num_params = None
    if sharded and hasattr(getattr(model, "config", None), "num_params"):
        num_params = model.config.num_params()
    ctx = resolve_strategy(strategy, num_devices, num_params, seq_len,
                           hbm_per_device=detect_hbm_per_device(device))
    if accum_steps:
        ctx.accum_steps = accum_steps
    local_sgd = ctx.extra.get("local_sgd")
    if local_sgd is not None:
        _check_local_sgd(ctx, fused_steps, materialize)
    if ctx.plan.pp > 1:
        _check_pipeline(ctx, model, loss_fn)
    overrides = ctx.model_overrides(model)
    if overrides:
        model = type(model)(dataclasses.replace(model.config, **overrides))
    optimizer = optimizer or adamw(3e-4)
    sb = ctx.extra.get("stable_bf16")
    offload = bool(ctx.extra.get("optimizer_offload"))
    mesh_state = None
    if sharded:
        model, mesh_state = _shard(model, ctx, device, seed, materialize,
                                   sb is not None)
    elif materialize:
        model.init_params(seed, device)
    if sb is not None:
        from ..optimizers.bf16_stable import stable_bf16

        if not sharded:
            # bf16 parameters, not just bf16 compute; stable_bf16 keeps
            # the updates from vanishing below the bf16 ulp
            with torch.no_grad():
                for p in model.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(torch.bfloat16)
        optimizer = stable_bf16(optimizer, master=sb["master"])
    num_local = sum((p.to_local() if hasattr(p, "to_local") else p).numel()
                    for p in model.parameters())
    if materialize:
        _warn_slow_offload_link(ctx, device, num_local)
    loss = loss_fn or make_lm_loss()
    if mesh_state is not None:
        from ..optimizers.leaf import over_local_shards

        optimizer = over_local_shards(optimizer, force=offload)
    state = TrainState.create(model, optimizer, mesh_state)
    if offload:
        from ..optimizers.leaf import offload_state

        offload_state(state.opt_state, ensure_state)
    elif mesh_state is not None:
        ensure_state(state.opt_state)  # the moments' placements, now
    vg = None
    if ctx.plan.pp > 1:
        from ..parallel.pipeline import pipeline_step

        def vg(model, batch):
            return pipeline_step(model, loss, batch)
    if local_sgd is not None:
        state, step = _diloco(state, loss, ctx, local_sgd, sb)
    else:
        step = make_train_step(loss, ctx.accum_steps, fused_steps, vg)
    return AccelerateResult(train_step=step, state=state, loss_fn=loss,
                            model=model, device=device, strategy=ctx,
                            accum_steps=ctx.accum_steps,
                            fused_steps=max(fused_steps, 1),
                            mesh_state=mesh_state, value_and_grad_fn=vg)


def _shard(model, ctx: StrategyContext, device, seed: int,
           materialize: bool, bf16: bool):
    """Build the mesh, rebuild `model` (still on ``meta``) on it
    (`_on_mesh`), shard it over the mesh and, with `materialize`, fill
    each rank's pieces from the seeded init (JAX :676-711); `bf16` casts
    the parameters first (stable_bf16).  Returns (model, its
    MeshState)."""
    from ..parallel.fsdp import materialize as fill, shard_model
    from ..parallel.sharding import ShardingPlanner

    mesh = build_mesh(ctx.plan, device.type)
    planner = ShardingPlanner(mesh)
    if ctx.plan.ep > 1:
        planner.with_moe()
    model = _on_mesh(model, ctx, mesh)
    if ctx.plan.pp > 1:
        from ..parallel.pipeline import PipelinedLM

        model = PipelinedLM(model, ctx.extra["pp_microbatches"],
                            schedule=ctx.extra["pp_schedule"],
                            virtual_stages=ctx.extra["pp_virtual_stages"],
                            mesh=mesh,
                            head_loss_fn=ctx.extra.get("pp_head_loss"))
        if ctx.extra.get("tensor_parallel") or ctx.plan.tp > 1:
            model.activation_mesh = mesh["tp"]
        logger.info("pipeline parallel: %d stages x %d layers, %d "
                    "microbatches, schedule=%s%s", ctx.plan.pp,
                    model._n_layer // ctx.plan.pp, model.num_microbatches,
                    model.schedule,
                    f" v={model.virtual_stages}"
                    if model.virtual_stages > 1 else "")
    if bf16:
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    mesh_state = shard_model(
        model, mesh, ctx.plan, planner,
        tensor_parallel=bool(ctx.extra.get("tensor_parallel")),
        reshard_after_forward=ctx.extra.get("reshard_after_forward", True),
        replica_dim="dp" if "local_sgd" in ctx.extra else None)
    if materialize:
        fill(model, seed, device)
    logger.info("auto_accelerate: mesh=%s over %s", ctx.plan.describe(),
                device.type)
    return model, mesh_state


def _check_pipeline(ctx: StrategyContext, model, loss_fn) -> None:
    """JAX's refusals of a pipelined build (:557-586), before any
    parameter is made, and the microbatch count it settles
    (`default_pp_microbatches` unless given)."""
    from ..parallel.pipeline import check_layers, default_pp_microbatches

    cfg = getattr(model, "config", None)
    check_layers(getattr(cfg, "n_layer", getattr(cfg, "num_layers", None)),
                 ctx.plan.pp)
    ctx.extra["pp_microbatches"] = ctx.extra.get("pp_microbatches") or \
        default_pp_microbatches(ctx.accum_steps, ctx.plan.pp)
    if ctx.extra.get("pp_schedule") == "1f1b" and loss_fn is not None:
        raise ValueError(
            "pipeline schedule '1f1b' cannot honor a whole-batch "
            "(params, batch) loss_fn — its backward seeds PER-"
            "MICROBATCH head vjps in-schedule.  Pass a per-microbatch "
            "head loss instead: ('pipeline_parallel', {'head_loss': "
            "fn(head_params, h, labels) -> scalar}), or use "
            "schedule='gpipe'/'interleaved'")
    if ctx.extra.get("local_sgd") is not None:
        raise ValueError(
            "local_sgd does not compose with pipeline_parallel — a DiLoCo "
            "replica group would hold one pipeline stage of the model, "
            "and its outer sync averages whole replicas")


def _diloco(state: TrainState, loss: Callable, ctx: StrategyContext,
            cfg: Dict, sb: Optional[Dict]):
    """(the `DiLoCoState` over the group's `state`, its train step), JAX
    :614-662; with stable_bf16 the outer sync re-anchors the
    compensation or masters (`reset_compensation`)."""
    from ..parallel.local_sgd import (
        LocalSGDConfig,
        init_diloco_state,
        make_diloco_train_step,
    )

    ls_cfg = LocalSGDConfig(**cfg)
    reset = None
    if sb is not None:
        from ..optimizers.bf16_stable import reset_compensation

        def reset(opt):
            return reset_compensation(getattr(opt, "inner", opt))
    step = make_diloco_train_step(loss, ls_cfg, ctx.accum_steps, reset)
    logger.info("local_sgd (DiLoCo): dp=%d groups, sync every %d steps, "
                "reduce=%s%s%s", ctx.plan.dp, ls_cfg.sync_every,
                ls_cfg.reduce, ", stable_bf16" if sb is not None else "",
                ", optimizer_offload" if ctx.extra.get("optimizer_offload")
                else "")
    return init_diloco_state(state, ls_cfg), step


def _on_mesh(model, ctx: StrategyContext, mesh):
    """`model` rebuilt with ``mesh`` the mesh, which the models read for
    their positions, attention and experts, and under sequence parallel
    over sp > 1 with ``attn_impl`` the strategy's impl (JAX :523-541);
    Ulysses needs the heads to divide sp (JAX's message).  A model whose
    config has no ``mesh`` is returned as it is."""
    sp_impl = ctx.extra.get("sp_impl", "ulysses")  # auto_plan's sp too
    cfg = getattr(model, "config", None)
    if not dataclasses.is_dataclass(cfg) or \
            not {"attn_impl", "mesh"} <= {f.name for f in
                                          dataclasses.fields(cfg)}:
        return model
    if ctx.plan.sp == 1:
        # size 1 falls through to flash, as in JAX
        return type(model)(dataclasses.replace(cfg, mesh=mesh))
    heads = getattr(cfg, "n_head", getattr(cfg, "num_heads", None))
    if sp_impl == "ulysses" and heads and heads % ctx.plan.sp:
        raise ValueError(
            f"ulysses sequence parallel needs heads ({heads}) divisible "
            f"by sp={ctx.plan.sp}; use impl='ring' or adjust sp")
    logger.info("sequence parallel: %s attention over sp=%d", sp_impl,
                ctx.plan.sp)
    return type(model)(dataclasses.replace(cfg, attn_impl=sp_impl,
                                           mesh=mesh))
