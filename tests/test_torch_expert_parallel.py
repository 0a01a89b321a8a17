"""Port parity: GPT nano with 4 experts over a mesh (``models/moe.py``'s
mesh path, the ``expert_parallel`` strategy) against the JAX package.

JAX runs the MoE layer under GSPMD on the global token axis: the
capacity comes from the global token count, each expert's queue is
counted in the global (B, T) order, and the Switch aux loss is a product
of global means.  The port's ranks hold their own tokens, so they gather
the router's probabilities and gate over every token.  Each case loads
JAX's initial state (`TrainState.load_tree`) and takes 4 steps of
``adamw(1e-4)`` in float32, at a capacity factor of 1, at which experts
overflow and drop tokens:

- (a) ``fsdp`` 4: the tokens split over 4 ranks, against JAX's fsdp on
  ``jax.devices()[:4]``: losses, grad norms and the first forward's aux
  loss to ``RTOL`` = 1e-5, every leaf to 1e-5 in relative L2 (as
  tests/test_torch_parallel_small_lr.py).  A rank that gated its own
  tokens alone drops others and misses the bounds.
- (b) ``expert_parallel`` 4 + ``fsdp`` (JAX's
  tests/test_moe.py:84-108 strategy) and ``expert_parallel`` 2 +
  ``fsdp`` (ep 2 x fsdp 2: both at once), at the same bounds.
- (c) each rank holds its own quarter of the experts, as JAX's
  ``shard_index_set`` shows 4 distinct expert slices.
- (d) the ep 4 state's checkpoint pieces are JAX's ``#shardN`` names,
  shapes and indices, and a fresh build resumes from them bitwise.
- A rank's gating keeps only the slots its own tokens fill
  (`_global_gating` with ``compact``): each expert's columns of the
  global (n, E, C) combine that this rank uses, in queue order, bitwise,
  and no more columns than the most any expert gives this rank.

One world runs every port case of the module (`torch_world.run_world`);
the JAX side runs once, in a module-scoped fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_world as tw
from dlrover_wuqiong_tpu.auto.accelerate import (
    auto_accelerate as jax_auto_accelerate,
)
from dlrover_wuqiong_tpu.checkpoint import shm_handler as jshm
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import moe as jmoe
from version_gates import shard_index_set
from torch_threads import one_torch_thread  # noqa: F401

RTOL, SMALL_LR = 1e-5, 1e-4

#: key -> strategy (each case GPT nano with `torch_world.MOE`)
CASES = {
    "fsdp": [("fsdp", {})],
    "ep4_fsdp": [("expert_parallel", {"size": 4}), ("fsdp", {})],
    "ep2_fsdp": [("expert_parallel", {"size": 2}), ("fsdp", {})],
}
PLANS = {"fsdp": "fsdp4", "ep4_fsdp": "ep4", "ep2_fsdp": "fsdp2xep2"}


def _jax_cfg():
    return dataclasses.replace(jgpt.GPTConfig.nano(), **tw.MOE)


def _jax_build(strategy):
    return jax_auto_accelerate(
        jgpt.GPT(_jax_cfg()), optimizer=optax.adamw(SMALL_LR),
        devices=jax.devices()[:4],
        strategy=list(strategy) + [("half", {"enabled": False})])


def _jax_case(strategy):
    res = _jax_build(strategy)
    init = {k: np.asarray(v) for k, v in jshm.flatten_state_dict(
        res.state).items()}
    # the first forward's aux loss, on the whole batch: global semantics
    model = jgpt.GPT(dataclasses.replace(_jax_cfg(), dtype=jnp.float32))
    _, inter = model.apply({"params": res.state.params},
                           jnp.asarray(tw.host_batches()[0]["input_ids"]),
                           mutable=["intermediates"])
    aux = float(jmoe.collect_moe_aux_loss(inter["intermediates"]))
    # read before the steps: the train step donates the state
    slices = {t[0] for t in shard_index_set(
        res.state.params["h_0"]["moe_mlp"]["experts_w_in"])}
    state, metrics = res.state, []
    for b in tw.host_batches():
        state, m = res.train_step(state, res.place_batch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    params = {k.replace("/", "."): np.asarray(v, dtype=np.float32)
              for k, v in jshm.flatten_state_dict(state.params).items()}
    return {"init": init, "metrics": metrics, "params": params, "aux": aux,
            "expert_slices": slices}


def _refs(state):
    return {(e, tuple(g), tuple(tuple(i) for i in idx))
            for name, leaf in jshm.flatten_state_dict(state).items()
            for e, _, g, idx in jshm._leaf_refs(name, leaf)}


@pytest.fixture(scope="module")
def jax_runs():
    runs = {k: _jax_case(s) for k, s in CASES.items()}
    runs["ckpt_refs"] = _refs(_jax_build(tw.EP_CKPT[0]).state)
    return runs


@pytest.fixture(scope="module")
def world(jax_runs, tmp_path_factory):
    cases = [(k, s, tw.MOE, SMALL_LR) for k, s in CASES.items()]
    inits = {k: jax_runs[k]["init"] for k in CASES}
    ckdir = str(tmp_path_factory.mktemp("ep_ckpt"))
    return tw.run_world(4, tw.expert_cases, cases, inits, ckdir,
                        f"dwt-ep-{id(ckdir)}")


@pytest.mark.parametrize("key", sorted(CASES))
def test_moe_over_a_mesh_matches_jax(key, jax_runs, world):
    got, want = world[0][key], jax_runs[key]
    assert got["plan"] == PLANS[key]
    for r in world[1:]:
        assert r[key]["metrics"] == got["metrics"]
        assert r[key]["aux"] == got["aux"]
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=RTOL,
                               err_msg=key)
    np.testing.assert_allclose(np.asarray(got["metrics"]),
                               np.asarray(want["metrics"]), rtol=RTOL,
                               err_msg=key)
    spread = tw.leaf_spread(got["params"], want["params"])
    assert spread[0] <= RTOL, (key, spread)
    (_, gk), (_, wk) = (tw.split_key_bias(got["params"]),
                        tw.split_key_bias(want["params"]))
    for n in wk:
        assert np.abs(gk[n] - wk[n]).max() <= 2 * SMALL_LR * tw.STEPS, (
            key, n)


def test_expert_stacks_split_over_ep(jax_runs, world):
    """ep 4: each rank's expert stacks hold a quarter of the experts, all
    four distinct, as JAX's shards of the same leaf."""
    for name in world[0]["ep4_fsdp"]["layout"]:
        slices = {tuple(r["ep4_fsdp"]["layout"][name][0]) for r in world}
        assert slices == {(0, 1), (1, 2), (2, 3), (3, 4)}, (name, slices)
    want = {s[:2] for s in jax_runs["ep4_fsdp"]["expert_slices"]}
    assert want == {(0, 1), (1, 2), (2, 3), (3, 4)}


def test_expert_parallel_checkpoint_is_jax_layout(jax_runs, world):
    refs = [x for r in world for x in r["ckpt"]["refs"]]
    assert len(refs) == len(set(refs))
    assert set(refs) == jax_runs["ckpt_refs"]
    assert any("experts_w_in#shard3" in e for e, _, _ in refs)


def test_expert_parallel_checkpoint_resumes_bitwise(world):
    for r in world:
        got = r["ckpt"]
        assert got["tier"] == "storage" and got["step"] == 4
        assert got["resumed"] == got["after"]
        assert got["bitwise"]


@pytest.mark.parametrize("layout", ["batch", "sequence"])
def test_compact_slots_are_the_ranks_own_columns(layout):
    """Rank r of 4 over 64 tokens (B 4, T 16): its rows a batch block
    (fsdp) or a sequence chunk of every row (sp).  Top-2 of 4 experts at
    capacity factor 1 drops tokens."""
    from dlrover_wuqiong_tpu_torch.models import moe as tmoe

    gen = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn((64, 4), generator=gen), -1)
    capacity = int(1.0 * 64 * 2 / 4)
    ids = torch.arange(64).reshape(4, 16)
    for r in range(4):
        rows = (ids[r] if layout == "batch"
                else ids[:, 4 * r:4 * r + 4]).reshape(-1)
        mine = probs[rows]
        full_c, full_d = tmoe._global_gating(mine, probs, rows, 2, capacity)
        comp_c, comp_d = tmoe._global_gating(mine, probs, rows, 2, capacity,
                                             compact=True)
        used = full_d.any(0)                                   # (E, C)
        assert comp_c.shape[-1] == max(1, int(used.sum(1).max()))
        assert comp_c.shape[-1] < capacity
        for e in range(4):
            cols = used[e].nonzero()[:, 0]
            m = len(cols)
            assert torch.equal(comp_c[:, e, :m], full_c[:, e, cols])
            assert torch.equal(comp_d[:, e, :m], full_d[:, e, cols])
            assert not comp_d[:, e, m:].any()
            assert not comp_c[:, e, m:].any()
