"""Port parity: `auto_accelerate`'s one-device strategies against JAX's.

- Each one-device strategy list gives the overrides JAX's
  ``StrategyContext.model_overrides`` gives for the same list and the
  same model family (dtypes mapped jnp -> torch), the same accumulation
  steps, and a rebuilt model that carries them.
- The last strategy the port took (pipeline_parallel, ROADMAP item 8c)
  resolves as JAX's, and no strategy raises as unported any more; the
  mesh strategies of item 8a (expert_parallel too) and 8b
  (sequence_parallel) size the plan as JAX's do, and without a process group
  auto_accelerate asks for one; the optimizer strategies resolve as
  JAX's do and build bf16 parameters or an offloaded state; an unknown
  name raises JAX's message word for word; a bad remat policy raises
  when the strategy is resolved.
- ``[("amp", {"fp8": True}), ("checkpoint", {"policy": "dots"})]`` trains
  a nano GPT on the CPU with falling loss, its projections `Fp8Dense`.
"""

import ast
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.auto import accelerate as jacc
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import llama as jllama
from dlrover_wuqiong_tpu_torch.auto import accelerate as tacc
from dlrover_wuqiong_tpu_torch.models import fp8 as tfp8
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.models import llama as tllama
from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
FAMILIES = {"gpt": (jgpt.GPT, jgpt.GPTConfig, tgpt.GPT, tgpt.GPTConfig),
            "llama": (jllama.Llama, jllama.LlamaConfig, tllama.Llama,
                      tllama.LlamaConfig)}

STRATEGIES = {
    "none": [],
    "amp": [("amp", {})],
    "amp_off": [("amp_native", {"enabled": False})],
    "half_fp8": [("half", {"fp8": True})],
    "fp8_filter": [("amp", {"fp8": True, "filter": ["c_fc", "up_proj"]})],
    "checkpoint": ["checkpoint"],
    "checkpoint_off": [("checkpoint", {"enabled": False})],
    "dots": [("checkpoint", {"policy": "dots"})],
    "offload_names": [("checkpoint", {"policy": "offload_names",
                                      "names": ["attn_out"]})],
    "module_replace_off": [("module_replace", {"enabled": False})],
    "grad_accum": [("grad_accum", {"steps": 4})],
    "all": [("amp", {"fp8": True}), ("checkpoint", {"policy": "save_names"}),
            ("module_replace", {}), ("grad_accum", {"steps": 2})],
}


def _jax_value(v):
    return DTYPES.get(v, v)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
@pytest.mark.parametrize("case", sorted(STRATEGIES))
def test_overrides_match_jax(fam, case):
    jm, jc, tm, tc = FAMILIES[fam]
    strategy = STRATEGIES[case]
    jctx = jacc.resolve_strategy(strategy, 1)
    tctx = tacc.resolve_strategy(strategy)
    jcfg = dataclasses.replace(jc.nano(), dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(tc.nano(), dtype=torch.float32, remat=False)
    want = {k: _jax_value(v)
            for k, v in jctx.model_overrides(jm(jcfg)).items()}
    got = tctx.model_overrides(tm(tcfg))
    assert got == want
    assert tctx.accum_steps == jctx.accum_steps
    assert (tctx.amp, tctx.remat, tctx.flash_attention) == \
        (jctx.amp, jctx.remat, jctx.flash_attention)


def test_auto_accelerate_rebuilds_the_model_with_the_overrides():
    strategy = [("amp", {"fp8": True, "filter": ["c_fc"]}),
                ("checkpoint", {"policy": "offload_dots"}),
                ("grad_accum", {"steps": 2})]
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                              remat=False)
    res = tacc.auto_accelerate(tgpt.GPT(cfg), device="cpu",
                               strategy=strategy)
    got = res.model.config
    assert (got.dtype, got.fp8, got.fp8_filter, got.remat,
            got.remat_policy) == (torch.bfloat16, True, ("c_fc",), True,
                                  "offload_dots")
    assert res.accum_steps == res.strategy.accum_steps == 2
    assert isinstance(res.model.h_0.mlp.c_fc, tfp8.Fp8Dense)
    assert type(res.model.h_0.attn.c_attn) is tfp8.Dense
    assert res.state.params is res.model
    # an explicit accum_steps wins over the strategy's
    res = tacc.auto_accelerate(tgpt.GPT(cfg), device="cpu",
                               strategy=strategy, accum_steps=3)
    assert res.accum_steps == 3


#: the strategies that raised as unported, with their ROADMAP item
ONCE_UNPORTED = {"pipeline_parallel": "8c"}
#: the mesh strategies of items 8a and 8b (a world of 8)
MESH = {"fsdp": [("fsdp", {})], "zero2": [("zero2", {"size": 16})],
        "zero3": [("zero3", {})], "data_parallel": [("data_parallel", {})],
        "ddp": [("ddp", {"size": 8})],
        "tp_only": [("tensor_parallel", {"size": 2})],
        "tensor_parallel": [("tensor_parallel", {"size": 2}), ("fsdp", {})],
        "tp_dp": [("tensor_parallel", {"size": 2}), ("data_parallel", {})],
        "multi_slice": [("multi_slice", {"slices": 2, "tp": 2})],
        "multi_slice_4": [("multi_slice", {"slices": 4})],
        # the last two mesh dims (items 8a part 2 and 8b)
        "expert_parallel": [("expert_parallel", {"size": 4}),
                            ("fsdp", {})],
        "sequence_parallel": [("sequence_parallel", {"size": 4,
                                                     "impl": "ring"}),
                              ("fsdp", {})]}
#: the optimizer strategies (ROADMAP item 9) and the context each sets
OPTIMIZER_STRATEGIES = {
    "stable_bf16": ("stable_bf16", {"master": False}),
    "bf16_optimizer": ("stable_bf16", {"master": False}),
    "optimizer_offload": ("optimizer_offload", True)}


@pytest.mark.parametrize("name", sorted(ONCE_UNPORTED))
def test_unported_strategies_raise_with_their_item(name):
    """Item 8c ported pipeline_parallel: it resolves to JAX's plan and
    schedule over 8 devices, is a mesh strategy, and without a process
    group auto_accelerate asks for one (it no longer names the item)."""
    strategy = [(name, {"size": 2, "schedule": "1f1b"}), ("fsdp", {})]
    t, j = tacc.resolve_strategy(strategy, 8), jacc.resolve_strategy(
        strategy, 8)
    assert t.plan.sizes() == j.plan.sizes()
    assert t.extra["pp_schedule"] == j.extra["pp_schedule"] == "1f1b"
    assert name in tacc.MESH_STRATEGIES
    with pytest.raises(ValueError, match="process group") as err:
        tacc.auto_accelerate(tgpt.GPT(tgpt.GPTConfig.nano()), device="cpu",
                             strategy=[("amp", {}), (name, {})])
    assert ONCE_UNPORTED[name] not in str(err.value)


def test_unported_message_names_every_ported_strategy():
    """No strategy is refused as unported: the unknown-name refusal
    lists every strategy of the registry, which is JAX's, the mesh
    strategies (pipeline, expert and sequence parallel, local_sgd and
    hsdp among them) and the one-device ones."""
    with pytest.raises(ValueError) as err:
        tacc.resolve_strategy([("warp_drive", {})])
    listed = set(ast.literal_eval(str(err.value).split("known: ")[1]))
    assert listed == set(jacc._STRATEGY_REGISTRY)
    assert set(tacc.MESH_STRATEGIES) <= listed
    assert {"amp", "checkpoint", "grad_accum", "stable_bf16",
            "optimizer_offload", "pipeline_parallel"} <= listed
    assert not hasattr(tacc, "_NOT_PORTED")


@pytest.mark.parametrize("case", sorted(MESH))
def test_mesh_strategies_plan_as_jax(case):
    """Each part-1 mesh strategy resolves to JAX's plan over 8 devices;
    without a process group auto_accelerate asks for one."""
    def plan(acc):
        try:
            ctx = acc.resolve_strategy(MESH[case], 8)
        except ValueError as e:  # a plan that needs another device count
            return str(e)
        return ctx.plan.sizes()

    assert plan(tacc) == plan(jacc)
    ctx = tacc.StrategyContext()
    for name, cfg in MESH[case]:
        tacc._STRATEGY_REGISTRY[name](ctx, cfg, 8)
    assert ctx.extra["mesh"] is True
    with pytest.raises(ValueError, match="process group"):
        tacc.auto_accelerate(tgpt.GPT(tgpt.GPTConfig.nano()), device="cpu",
                             strategy=MESH[case])


def test_resolve_strategy_auto_plan_is_jax():
    for n, params in ((1, None), (8, 124_000_000), (64, 70_000_000_000)):
        t = tacc.resolve_strategy([], n, params, hbm_per_device=95 << 30)
        j = jacc.resolve_strategy([], n, params, hbm_per_device=95 << 30)
        assert t.plan.sizes() == j.plan.sizes()


@pytest.mark.parametrize("name", sorted(OPTIMIZER_STRATEGIES))
def test_optimizer_strategies_resolve_as_jax(name):
    """The three names no longer raise; each sets JAX's context entry."""
    key, want = OPTIMIZER_STRATEGIES[name]
    t = tacc.resolve_strategy([(name, {})])
    j = jacc.resolve_strategy([(name, {})], 1)
    assert t.extra[key] == j.extra[key] == want
    res = tacc.auto_accelerate(tgpt.GPT(dataclasses.replace(
        tgpt.GPTConfig.nano(), n_layer=1)), device="cpu",
        strategy=[("amp", {}), (name, {})])
    p = next(res.model.parameters())
    assert p.dtype == (torch.float32 if key == "optimizer_offload"
                       else torch.bfloat16)
    assert (getattr(res.state.opt_state, "offload_hops", None) is not None
            ) == (key == "optimizer_offload")


def test_registries_agree_and_unknown_names_raise_the_jax_message():
    assert sorted(tacc._STRATEGY_REGISTRY) == sorted(jacc._STRATEGY_REGISTRY)
    with pytest.raises(ValueError) as jerr:
        jacc.resolve_strategy([("warp_drive", {})], 1)
    with pytest.raises(ValueError) as terr:
        tacc.resolve_strategy([("warp_drive", {})])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unknown remat policy"):
        tacc.resolve_strategy([("checkpoint", {"policy": "most"})])


def test_fp8_and_dots_strategy_trains_nano_on_cpu():
    res = tacc.auto_accelerate(
        tgpt.GPT(tgpt.GPTConfig.nano()), optimizer=adamw(1e-3), device="cpu",
        strategy=[("amp", {"fp8": True}), ("checkpoint", {"policy": "dots"})])
    assert res.model.config.fp8 and res.model.config.remat_policy == "dots"
    assert isinstance(res.model.h_1.attn.c_proj, tfp8.Fp8Dense)
    ids = np.random.default_rng(2).integers(0, 512, (2, 33))
    b = res.place_batch({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    losses = []
    for _ in range(4):
        res.state, m = res.train_step(res.state, b)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
