"""Port parity: the mesh strategies in a gloo world of 4 CPU processes
against JAX's `auto_accelerate` on 4 host devices, at lr 1e-2.

One world runs every port case of the module (`torch_world.run_world`);
the JAX side runs once, in a module-scoped fixture, on
``jax.devices()[:4]``.  Each case is a nano model in float32 (``("half",
{"enabled": False})``) with ``adamw(1e-2)``, JAX's initial state loaded
through `TrainState.load_tree` (each rank keeps its slices), then 4
steps on the same global batches.

Tolerances, measured in this file.  The losses agree to ``RTOL`` =
1e-5 at every step (measured <= 1.7e-6), and the first step's grad norm
too.  The gradients agree to ~5e-7 relative (another order of the
cross-rank sums), but Adam's first updates are sign-like,
``lr * m / (sqrt(v) + eps)`` ~ ``lr * sign(g)``, so an entry whose
gradient sits within rounding of zero moves by a full lr on one side
and not the other (tests/test_torch_train_step.py says the same of the
one-device build at lr 3e-4; here lr is 1e-2).  The reference does the
same on its own: JAX's 4-device build and its 1-device build, from one
init, differ by more than ``RTOL`` in relative L2 on some leaf
(`test_the_reference_spreads_so_on_its_own`).  So the later grad norms
are held to ``NORM_RTOL`` = 1e-4 (measured <= 1.1e-5) and each final
parameter leaf to ``PARAM_RTOL`` = 1e-3 in relative L2 norm (measured
<= 2.7e-4), not elementwise.  GPT's key bias is held apart
(`torch_world.split_key_bias`, within 2 lr a step).  Every build is held
so against JAX and against the port's own unsharded build.  At lr 1e-4
the same builds hold ``RTOL`` per leaf
(tests/test_torch_parallel_optimizers.py), where a sharding fault would
show.

Besides: the state is sharded by construction (after
tests/test_parallel_training.py:308-366), and ``materialize=False``
allocates nothing.
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
NORM_RTOL = 1e-4
PARAM_RTOL = 1e-3

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
PLANS = {"fsdp": "fsdp4", "zero2": "fsdp4", "tp_fsdp": "fsdp2xtp2",
         "tp_dp": "dp2xtp2", "multi_slice": "dp2xfsdp2", "ddp": "dp4",
         "llama_tp_fsdp": "fsdp2xtp2"}


def _jax_model(family):
    if family == "gpt":
        return jgpt.GPT(jgpt.GPTConfig.nano())
    return jllama.Llama(jllama.LlamaConfig.nano())


def _jax_case(family, strategy, lr=1e-2, devices=4):
    res = jax_auto_accelerate(
        _jax_model(family), optimizer=optax.adamw(lr),
        devices=jax.devices()[:devices],
        strategy=list(strategy) + [("half", {"enabled": False})])
    init = {k: np.asarray(v) for k, v in jax_flatten(res.state).items()}
    state, metrics = res.state, []
    for b in tw.host_batches():
        state, m = res.train_step(state, res.place_batch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    params = {k.replace("/", "."): np.asarray(v, dtype=np.float32)
              for k, v in jax_flatten(state.params).items()}
    return {"init": init, "metrics": metrics, "params": params,
            "plan": res.strategy.plan.describe()}


@pytest.fixture(scope="module")
def jax_runs():
    return {k: _jax_case(f, s) for k, (f, s) in STRATEGIES.items()}


@pytest.fixture(scope="module")
def world(jax_runs):
    cases = [(k, f, s, "adamw", 1e-2) for k, (f, s) in STRATEGIES.items()]
    inits = {k: r["init"] for k, r in jax_runs.items()}
    return tw.run_world(4, tw.parallel_module, cases, inits)


@pytest.fixture(scope="module")
def unsharded(jax_runs):
    """The port's one-device build of each family from JAX's init."""
    out = {}
    for key, (family, _) in STRATEGIES.items():
        res, metrics = tw.train(family, [], init=jax_runs[key]["init"])
        out[key] = {"metrics": metrics, "params": tw.full_params(res.model)}
    return out


def _close(got, want, what):
    """Losses and grad norms, step for step."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL,
                               err_msg=f"{what}: losses")
    np.testing.assert_allclose(got[0, 1], want[0, 1], rtol=RTOL,
                               err_msg=f"{what}: first grad norm")
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=NORM_RTOL,
                               err_msg=f"{what}: grad norms")


def _params_close(got, want, what):
    assert sorted(got) == sorted(want), what
    worst = tw.leaf_spread(got, want)
    assert worst[0] <= PARAM_RTOL, (what, worst)
    (_, gk), (_, wk) = tw.split_key_bias(got), tw.split_key_bias(want)
    for n in wk:
        assert np.abs(gk[n] - wk[n]).max() <= 2 * 1e-2 * tw.STEPS, (what, n)


@pytest.mark.parametrize("key", sorted(STRATEGIES))
def test_strategy_matches_jax_and_the_unsharded_build(key, jax_runs, world,
                                                      unsharded):
    got = world[0]["parity"][key]
    assert got["plan"] == jax_runs[key]["plan"] == PLANS[key]
    # every rank reports the same global metrics
    for r in world[1:]:
        assert r["parity"][key]["metrics"] == got["metrics"]
    _close(got["metrics"], jax_runs[key]["metrics"], f"{key} vs JAX")
    _close(got["metrics"], unsharded[key]["metrics"], f"{key} vs unsharded")
    _params_close(got["params"], jax_runs[key]["params"], f"{key} vs JAX")
    _params_close(got["params"], unsharded[key]["params"],
                  f"{key} vs unsharded")


def test_state_is_sharded_by_construction(world):
    """Under fsdp 4 a rank holds < 0.3 of the state's bytes, the AdamW
    moments carry the parameters' placements, and the rank's initial
    pieces are bitwise the unsharded seeded init's slices."""
    for rank, r in enumerate(world):
        c = r["construction"]
        assert c["bitwise_init"], rank
        assert c["placements_kept"] and c["n_sharded"] == 10, rank
        assert c["fraction"] < 0.3, (rank, c["fraction"])


def test_materialize_false_allocates_nothing(world):
    """materialize=False: every parameter and moment piece is on meta,
    with the local shapes (and bytes) of the materialized build."""
    for r in world:
        c = r["construction"]
        assert c["lazy_meta"]
        assert c["lazy_shapes"] == c["shapes"]
        assert c["lazy_bytes"] == c["bytes"]


@pytest.fixture(scope="module")
def jax_one_device():
    """JAX's 1-device build of each family, from the same seeded init as
    its 4-device builds."""
    return {f: _jax_case(f, [], devices=1) for f in ("gpt", "llama")}


def test_the_reference_spreads_so_on_its_own(jax_runs, jax_one_device):
    """At lr 1e-2, JAX's 4-device build and its 1-device build (the same
    init, bitwise) differ by more than RTOL in relative L2 on some leaf,
    in each family: Adam's sign-like steps on near-zero gradients, the
    sums taken in another order.  The port's 4-rank builds are held to
    PARAM_RTOL against JAX's for that reason."""
    for key, family in (("fsdp", "gpt"), ("llama_tp_fsdp", "llama")):
        four, one = jax_runs[key], jax_one_device[family]
        assert all(np.array_equal(four["init"][n], one["init"][n])
                   for n in one["init"])
        _close(four["metrics"], one["metrics"], f"JAX {key} vs 1 device")
        spread = tw.leaf_spread(four["params"], one["params"])
        assert RTOL < spread[0] <= 2 * PARAM_RTOL, (key, spread)
