"""Port parity at a small lr: the mesh strategies in a gloo world of 4
CPU processes against JAX's `auto_accelerate` on 4 host devices.

The strategies of tests/test_torch_parallel_training.py, from JAX's
initial state loaded through `TrainState.load_tree`, 4 steps of
``adamw(1e-4)`` in float32 (``("half", {"enabled": False})``).  One
world runs every port case (`torch_world.run_world`); the JAX side runs
once, in a module-scoped fixture, on ``jax.devices()[:4]``.

At lr 1e-2 an entry that Adam moves by sign noise moves a full lr, so
that file holds each leaf to 1e-3.  At lr 1e-4 such an entry moves by
1e-4, and every leaf holds ``RTOL`` = 1e-5 in relative L2 (measured <=
8.5e-6), GPT's key bias apart (`torch_world.split_key_bias`, within 2 lr
a step), against JAX and against the port's unsharded build; the losses
and grad norms hold it at every step.  A sharding fault (a piece updated
with the wrong gradient, or not at all) moves a leaf by far more.
"""

import jax
import numpy as np
import optax
import pytest

import torch_world as tw
from dlrover_wuqiong_tpu.auto.accelerate import (
    auto_accelerate as jax_auto_accelerate,
)
from dlrover_wuqiong_tpu.checkpoint.shm_handler import (
    flatten_state_dict as jax_flatten,
)
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import llama as jllama
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
SMALL_LR = 1e-4

STRATEGIES = {
    "fsdp": ("gpt", [("fsdp", {})]),
    "zero2": ("gpt", [("zero2", {})]),
    "tp_fsdp": ("gpt", [("tensor_parallel", {"size": 2}), ("fsdp", {})]),
    "tp_dp": ("gpt", [("tensor_parallel", {"size": 2}),
                      ("data_parallel", {})]),
    "multi_slice": ("gpt", [("multi_slice", {"slices": 2})]),
    "ddp": ("gpt", [("ddp", {})]),
    "llama_tp_fsdp": ("llama", [("tensor_parallel", {"size": 2}),
                                ("fsdp", {})]),
}


def _jax_case(family, strategy):
    model = (jgpt.GPT(jgpt.GPTConfig.nano()) if family == "gpt"
             else jllama.Llama(jllama.LlamaConfig.nano()))
    res = jax_auto_accelerate(
        model, optimizer=optax.adamw(SMALL_LR), devices=jax.devices()[:4],
        strategy=list(strategy) + [("half", {"enabled": False})])
    init = {k: np.asarray(v) for k, v in jax_flatten(res.state).items()}
    state, metrics = res.state, []
    for b in tw.host_batches():
        state, m = res.train_step(state, res.place_batch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    params = {k.replace("/", "."): np.asarray(v, dtype=np.float32)
              for k, v in jax_flatten(state.params).items()}
    return {"init": init, "metrics": metrics, "params": params}


@pytest.fixture(scope="module")
def jax_runs():
    return {k: _jax_case(f, s) for k, (f, s) in STRATEGIES.items()}


@pytest.fixture(scope="module")
def world(jax_runs):
    cases = [(k, f, s, "adamw", SMALL_LR)
             for k, (f, s) in STRATEGIES.items()]
    inits = {k: r["init"] for k, r in jax_runs.items()}
    return tw.run_world(4, tw.parity_cases, cases, inits)


def _held(got, want, what):
    """Losses and grad norms at every step, and every leaf, to RTOL."""
    g, w = np.asarray(got["metrics"]), np.asarray(want["metrics"])
    np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=what)
    spread = tw.leaf_spread(got["params"], want["params"])
    assert spread[0] <= RTOL, (what, spread)
    (_, gk), (_, wk) = (tw.split_key_bias(got["params"]),
                        tw.split_key_bias(want["params"]))
    for n in wk:
        assert np.abs(gk[n] - wk[n]).max() <= 2 * SMALL_LR * tw.STEPS, (
            what, n)


@pytest.mark.parametrize("key", sorted(STRATEGIES))
def test_strategy_matches_jax_at_a_small_lr(key, jax_runs, world):
    got = world[0][key]
    for r in world[1:]:
        assert r[key]["metrics"] == got["metrics"]
    _held(got, jax_runs[key], f"{key} vs JAX")
    family = STRATEGIES[key][0]
    res, metrics = tw.train(family, [], init=jax_runs[key]["init"],
                            lr=SMALL_LR)
    _held(got, {"metrics": metrics, "params": tw.full_params(res.model)},
          f"{key} vs unsharded")
