"""Port parity: pipeline parallelism (`parallel/pipeline.py`, the
``pipeline_parallel`` strategy) at pp 4 against the JAX package's
`PipelinedLM` on the CPU.

- The pure parts against JAX's: `schedule_ticks`, `circular_layer_order`,
  `default_pp_microbatches`, the layer split / stack / unstack, and the
  strategy's refusals (tests/test_pipeline.py:137-152, :659-711,
  :778-804).
- In a gloo world of 4 (`torch_world.run_world`), GPT and Llama nano at
  pp 4 under gpipe, interleaved (v 2) and 1F1B, and GPT with 4 experts
  under each (the MoE aux through the schedule), from JAX's initial
  pipelined tree (`convert.load_pipelined`), against JAX's
  `auto_accelerate` with the same strategy on 4 host devices: the
  logits of one forward, the loss and every leaf's gradient of one step's
  `value_and_grad`, then 2 steps of adamw(1e-2): losses, grad norms and
  every final leaf.  Each rank's state names and index ranges are held
  against JAX's `PipelineShardingPlanner.param_specs` on the same mesh.
- `EmulatedPipeline` (the card's path: the pp stages in one process
  through the same schedule bodies) against JAX's, on the same weights;
  and a model given through the adapter hooks against the built-in
  adapters.

Tolerances, measured here (float32).  Logits ``OUT_ATOL`` = 1e-5
(measured <= 3e-6); losses ``RTOL`` = 1e-5 (measured <= 1e-6); each
leaf's gradient ``GRAD_RTOL`` = 1e-4 in relative L2 (measured <= 1e-5);
the later grad norms ``NORM_RTOL`` = 1e-4, as
tests/test_torch_parallel_training.py holds them.  The final leaves are
held entry by entry: at most ``OFF_SHARE`` = 1% of a leaf's entries
(measured: none) more than half an lr step from JAX's
(`torch_world.off_share`).  Not in relative L2: Adam's first updates are
sign-like at lr 1e-2, and a LayerNorm bias that starts at 0 ends near
0, where entries 5e-7 apart already read 3.5e-3 relative.
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_pipeline_world as tpw
import torch_world as tw
from dlrover_wuqiong_tpu.auto.accelerate import (
    auto_accelerate as jax_auto_accelerate,
)
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import llama as jllama
from dlrover_wuqiong_tpu.parallel import pipeline as jpipe
from dlrover_wuqiong_tpu_torch.auto import accelerate as tacc
from dlrover_wuqiong_tpu_torch.convert import load_params
from dlrover_wuqiong_tpu_torch.parallel import pipeline as tpipe
from dlrover_wuqiong_tpu_torch.trainer.train_step import make_lm_loss
from torch_threads import one_torch_thread  # noqa: F401

OUT_ATOL = 1e-5
RTOL = 1e-5
GRAD_RTOL = 1e-4
NORM_RTOL = 1e-4
OFF_SHARE = 0.01
LR = 1e-2

MOE = {"moe_experts": 4, "moe_capacity_factor": 1.0}
SCHEDULES = {"gpipe": ({}, 4), "interleaved": ({"virtual_stages": 2}, 8),
             "1f1b": ({}, 4)}


def _cases(pp=4):
    out = []
    for sched, (extra, L) in SCHEDULES.items():
        strat = [("pipeline_parallel", dict(size=pp, schedule=sched,
                                            **extra))]
        out.append((f"gpt_{sched}", "gpt", {"n_layer": L}, strat, 2, 1))
        out.append((f"llama_{sched}", "llama", {"num_layers": L}, strat, 0,
                    1))
        out.append((f"moe_{sched}", "gpt", dict(MOE, n_layer=L), strat, 0,
                    1))
    return out


CASES = _cases()


# ------------------------------------------------------------ JAX side


def jax_model(family, overrides):
    if family == "gpt":
        return jgpt.GPT(dataclasses.replace(jgpt.GPTConfig.nano(),
                                            **overrides))
    return jllama.Llama(dataclasses.replace(jllama.LlamaConfig.nano(),
                                            **overrides))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float32)
    return out


def _index(sl, shape):
    return [[s.start or 0, shape[d] if s.stop is None else s.stop]
            for d, s in enumerate(sl)]


def jax_layout(params, devices):
    """[{pipelined path: (global shape, index)} for each device]."""
    from dlrover_wuqiong_tpu.checkpoint.shm_handler import flatten_state_dict

    flat = flatten_state_dict(params)
    out = []
    for d in devices:
        out.append({k: (list(v.shape), _index(
            v.sharding.devices_indices_map(v.shape)[d], v.shape))
            for k, v in flat.items()})
    return out


def jax_build(family, overrides, strategy, loss_fn=None, devices=4):
    """JAX's `auto_accelerate` of a case and its initial pipelined tree."""
    res = jax_auto_accelerate(
        jax_model(family, overrides), optimizer=optax.adamw(1e-2),
        devices=jax.devices()[:devices], loss_fn=loss_fn,
        strategy=list(strategy) + [("half", {"enabled": False})])
    return res, jax.tree.map(np.asarray, dict(res.state.params))


def jax_measure(res, strategy, steps, accum, devices=4):
    """JAX's run of a built case (torch_pipeline_world's docstring):
    `steps` train steps (0: none)."""
    params = res.state.params
    b = tw.host_batches(1)[0]
    logits = np.asarray(jax.jit(lambda p, x: res.model.apply(
        {"params": p}, x))(params, jnp.asarray(b["input_ids"])))
    sched = dict(strategy[0][1]).get("schedule", "gpipe")
    vg = jax.jit(res.model.value_and_grad if sched == "1f1b"
                 else jax.value_and_grad(res.loss_fn))
    placed = res.place_batch(tpw.batches(1, accum)[0])
    if accum == 1:
        loss, grads = vg(params, placed)
    else:
        parts = [vg(params, {k: v[i] for k, v in placed.items()})
                 for i in range(accum)]
        loss = sum(p[0] for p in parts) / accum
        grads = jax.tree.map(lambda *g: sum(g) / accum,
                             *[p[1] for p in parts])
    grads = _flat(res.model.to_flat_params(dict(grads)))
    state, metrics = res.state, []
    for bt in tpw.batches(steps, accum):
        state, m = res.train_step(state, res.place_batch(bt))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    final = _flat(res.model.to_flat_params(dict(state.params)))
    return {"logits": logits, "loss": float(loss), "grads": grads,
            "metrics": metrics, "params": final,
            "layout": jax_layout(params, jax.devices()[:devices]),
            "plan": res.strategy.plan.describe()}


def run_both(cases, refusals=None, world_cases=None, strategy=None,
             same_init=None):
    """JAX's runs of `cases` in this process while the port's world runs
    `world_cases` (default `cases`) beside it, from JAX's initial trees:
    (jax runs, world).  The world starts first and waits for the trees
    (`torch_pipeline_world.write_inits`) while JAX builds the cases.
    `strategy` maps a case's strategy to JAX's; `same_init` {world key:
    case key} gives a world-only case another case's tree."""
    import tempfile

    strategy = strategy or (lambda s: s)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        path = os.path.join(tmp, "inits.pkl")
        world = pool.submit(tw.run_world, 4, tpw.pipeline_cases,
                            world_cases or cases, path, refusals)
        built = {key: jax_build(f, o, strategy(s))
                 for key, f, o, s, _, _ in cases}
        inits = {k: init for k, (_, init) in built.items()}
        tpw.write_inits(path, dict(inits, **{
            k: inits[v] for k, v in (same_init or {}).items()}))
        runs = {key: dict(jax_measure(built[key][0], strategy(s), n, a),
                          init=inits[key])
                for key, _, _, s, n, a in cases}
        return runs, world.result()


# ------------------------------------------------------------ checks


def merge_ranks(world, key):
    """{name: global value} of every rank's leaves (each rank holds its
    stage's blocks and the shared leaves)."""
    grads, params = {}, {}
    for r in world:
        grads.update(r[key]["grads"])
        params.update(r[key]["params"])
    return grads, params


def check_case(key, want, world):
    """A world's case against JAX's run (module docstring)."""
    for r in world:
        got = r[key]
        assert got["plan"] == want["plan"], key
        assert got["export_equal"], key  # export_pipelined gives its rows
        rows, cols = got["rows"], got["cols"]
        np.testing.assert_allclose(got["logits"], want["logits"][rows, cols],
                                   atol=OUT_ATOL, err_msg=f"{key} logits")
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL,
                                   err_msg=f"{key} loss")
        if not want["metrics"]:
            continue
        m, w = np.asarray(got["metrics"]), np.asarray(want["metrics"])
        np.testing.assert_allclose(m[:, 0], w[:, 0], rtol=RTOL,
                                   err_msg=f"{key} losses")
        np.testing.assert_allclose(m[0, 1], w[0, 1], rtol=RTOL,
                                   err_msg=f"{key} first grad norm")
        np.testing.assert_allclose(m[:, 1], w[:, 1], rtol=NORM_RTOL,
                                   err_msg=f"{key} grad norms")
    grads, params = merge_ranks(world, key)
    assert sorted(grads) == sorted(want["grads"]), key
    for n, g in grads.items():
        ref = want["grads"][n]
        err = np.linalg.norm(g - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= GRAD_RTOL, (key, n, err)
    if want["metrics"]:
        share = tw.off_share(params, want["params"], LR)
        assert share[0] <= OFF_SHARE, (key, share)


def check_layout(key, want, world):
    """Each rank's state names and index ranges are JAX's for the device
    at the same mesh position."""
    for rank, r in enumerate(world):
        got = r[key]["layout"]
        ref = want["layout"][rank]
        assert sorted(got) == sorted(ref), key
        for n in ref:
            assert list(got[n][0]) == ref[n][0], (key, n)
            assert [list(x) for x in got[n][1]] == ref[n][1], (key, rank, n)


# ------------------------------------------------------------ fixtures

REFUSALS = {
    "indivisible": ("gpt", {}, [("pipeline_parallel", {"size": 4}),
                                ("fsdp", {})], {}),
    "loss_fn_1f1b": ("gpt", {"n_layer": 4},
                     [("pipeline_parallel", {"size": 4, "schedule": "1f1b"})],
                     {"loss_fn": tpw.zero_loss}),
    "local_sgd": ("gpt", {"n_layer": 4},
                  [("pipeline_parallel", {"size": 2}), ("local_sgd", {}),
                   ("data_parallel", {"size": 2})], {}),
    "interleaved_m": ("gpt", {"n_layer": 8},
                      [("pipeline_parallel", {"size": 4, "microbatches": 6,
                                              "schedule": "interleaved"})],
                      {}),
}


@pytest.fixture(scope="module")
def runs():
    return run_both(CASES, REFUSALS)


@pytest.mark.parametrize("key", [c[0] for c in CASES])
def test_pp4_matches_jax(key, runs):
    jax_runs, world = runs
    check_case(key, jax_runs[key], world)


@pytest.mark.parametrize("key", ["gpt_gpipe", "llama_interleaved",
                                 "moe_1f1b"])
def test_state_names_and_rows_are_jax(key, runs):
    jax_runs, world = runs
    check_layout(key, jax_runs[key], world)


@pytest.mark.parametrize("key,match", [
    ("indivisible", "divisible"), ("loss_fn_1f1b", "head_loss"),
    ("local_sgd", "does not compose with pipeline_parallel"),
    ("interleaved_m", "divisible by pp")])
def test_pipeline_refusals(key, match, runs):
    msg = runs[1][0]["refusals"][key]
    assert msg is not None and match in msg, msg


# ------------------------------------------------------------ pure parts


@pytest.mark.parametrize("args", [("gpipe", 8, 4), ("1f1b", 8, 4),
                                  ("interleaved", 8, 4, 2),
                                  ("interleaved", 12, 4, 3),
                                  ("gpipe", 3, 2)])
def test_schedule_ticks_are_jax(args):
    assert tpipe.schedule_ticks(*args) == jpipe.schedule_ticks(*args)


@pytest.mark.parametrize("args", [(8, 4, 2), (12, 4, 3), (12, 2, 2),
                                  (4, 2, 1)])
def test_circular_layer_order_is_jax(args):
    assert tpipe.circular_layer_order(*args) == \
        jpipe.circular_layer_order(*args)


def test_circular_layer_order_refuses_as_jax():
    with pytest.raises(ValueError, match="must divide by pp"):
        tpipe.circular_layer_order(6, 4, 2)


@pytest.mark.parametrize("accum,pp", [(1, 2), (1, 4), (16, 4), (3, 1)])
def test_default_microbatches_are_jax(accum, pp):
    assert tpipe.default_pp_microbatches(accum, pp) == \
        jpipe.default_pp_microbatches(accum, pp)


def test_layer_split_stack_unstack_are_jax():
    rng = np.random.default_rng(0)
    f32 = np.float32
    tree = {"wte": {"embedding": rng.normal(size=(4, 3)).astype(f32)},
            **{f"h_{i}": {"w": rng.normal(size=(2, 2)).astype(f32)}
               for i in range(3)}}
    non, layers, prefix = tpipe.split_layer_params(tree)
    jnon, jlayers, jprefix = jpipe.split_layer_params(tree)
    assert prefix == jprefix == "h" and sorted(non) == sorted(jnon)
    stacked = tpipe.stack_layer_params(layers)
    np.testing.assert_array_equal(
        stacked["w"], np.asarray(jpipe.stack_layer_params(jlayers)["w"]))
    back = tpipe.unstack_layer_params(stacked, 3)
    for a, b in zip(back, layers):
        np.testing.assert_array_equal(a["w"], b["w"])
    with pytest.raises(ValueError, match="no h_<i>/layers_<i> blocks"):
        tpipe.split_layer_params({"wte": {}})


@pytest.mark.parametrize("cfg,match", [
    ({"schedule": "zigzag"}, "unknown pipeline schedule"),
    ({"schedule": "interleaved", "virtual_stages": 1}, "virtual_stages >= 2"),
    ({"virtual_stages": 2}, "only applies to"),
    ({"size": 2, "head_loss": lambda *a: 0.0}, "1f1b"),
    ({"schedule": "1f1b", "head_loss": lambda *a: 0.0}, "size")])
def test_strategy_refusals_are_jax(cfg, match):
    """The handler's refusals, word for word JAX's."""
    msgs = []
    for acc in (tacc, __import__("dlrover_wuqiong_tpu.auto.accelerate",
                                 fromlist=["x"])):
        with pytest.raises(ValueError, match=match) as err:
            acc.resolve_strategy([("pipeline_parallel", cfg)], 4 if
                                 cfg.get("size") else 1)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_strategy_resolves_as_jax():
    from dlrover_wuqiong_tpu.auto import accelerate as jacc

    strat = [("pipeline_parallel", {"size": 2, "schedule": "interleaved",
                                    "virtual_stages": 3}), ("fsdp", {})]
    t, j = tacc.resolve_strategy(strat, 8), jacc.resolve_strategy(strat, 8)
    assert t.plan.sizes() == j.plan.sizes()
    for k in ("pp_schedule", "pp_virtual_stages", "pp_microbatches"):
        assert t.extra[k] == j.extra[k], k


def test_stage_refusals_are_jax():
    """PipelinedLM's own refusals (JAX :546-560, :622-626)."""
    from dlrover_wuqiong_tpu_torch.models import gpt as tgpt

    cfg = tgpt.GPTConfig.nano()
    with pytest.raises(ValueError, match="only applies to schedule='1f1b'"):
        tpipe.PipelinedLM(tgpt.GPT(cfg), 2, "gpipe",
                          head_loss_fn=lambda *a: 0.0)
    moe = tgpt.GPT(dataclasses.replace(cfg, moe_experts=4))
    with pytest.raises(ValueError, match="block_returns_aux=True"):
        tpipe.PipelinedLM(moe, 2, block_builder=lambda *a: [])
    with pytest.raises(ValueError, match="supplied together"):
        tpipe.PipelinedLM(tgpt.GPT(cfg), 2, embed_keys=("wte",))


# ------------------------------------------------------------ one process


@pytest.mark.parametrize("key", ["gpt_gpipe", "llama_interleaved",
                                 "moe_1f1b"])
def test_emulated_pipeline_matches_jax(key, runs):
    """The pp 4 stages in one process (`EmulatedPipeline`, the chip
    check's route) from JAX's weights: the logits, the loss and every
    leaf's gradient of one step, and the ticks it ran."""
    (_, family, overrides, strategy, _, _), = [c for c in CASES
                                                if c[0] == key]
    want = runs[0][key]
    cfg = dict(strategy[0][1])
    v = cfg.get("virtual_stages", 1)
    model = tw.port_model(family, **overrides)
    pipe = tpipe.EmulatedPipeline(model, 4, 8, cfg["schedule"], v)
    stage = pipe.stages[0]
    L = len(stage._order)
    if cfg["schedule"] == "interleaved":
        assert stage._order == jpipe.circular_layer_order(L, 4, v)
    load_params(model, stage.to_flat_params(want["init"]), "cpu")
    b = tw.host_batches(1)[0]
    with torch.no_grad():
        logits = pipe(torch.from_numpy(b["input_ids"]).long()).numpy()
    np.testing.assert_allclose(logits, want["logits"], atol=OUT_ATOL)
    batch = {k: torch.from_numpy(x).long() for k, x in b.items()}
    loss = tpipe.pipeline_step(pipe, make_lm_loss(), batch)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=RTOL)
    for n, p in model.named_parameters():
        ref = want["grads"][n]
        err = np.linalg.norm(p.grad.numpy() - ref) / np.linalg.norm(ref)
        assert err <= GRAD_RTOL, (n, err)
    ticks = tpipe.schedule_ticks(cfg["schedule"], 8, 4, v)[0]
    step = 8 + 2 * 3 if cfg["schedule"] == "1f1b" else 2 * ticks
    assert pipe.ticks == ticks + step  # the forward, then the step


def _hooks():
    """GPT's built-in adapters written as the hooks a custom model gives."""
    def embed(st, idx):
        return st.wte(idx) + st.wpe.embedding[:idx.shape[1]][None]

    def blocks(st, idx, deterministic):
        return [lambda h, b=b: b(h, None) for b in st.blocks()]

    def head(st, h):
        return st.ln_f(h) @ st.wte.embedding.t()

    return dict(embed_fn=embed, block_builder=blocks, head_fn=head,
                embed_keys=("wte", "wpe"), head_keys=("ln_f", "wte"),
                block_returns_aux=False)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_adapter_hooks_run_the_schedules(schedule):
    """A model given through the adapter hooks (JAX :526-560) trains as
    the built-in adapters do: the same loss, bitwise the same gradients
    (remat off, float32, one process)."""
    batch = {k: torch.from_numpy(x).long()
             for k, x in tw.host_batches(1)[0].items()}
    grads = []
    for kw in ({}, _hooks()):
        model = tw.port_model("gpt", n_layer=4, remat=False)
        model.init_params(0, "cpu")
        pipe = tpipe.EmulatedPipeline(model, 2, 4, schedule, **kw)
        loss = tpipe.pipeline_step(pipe, make_lm_loss(), batch)
        grads.append((float(loss), [p.grad.clone()
                                    for p in model.parameters()]))
    assert grads[0][0] == grads[1][0]
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
