"""Port parity: the train step, accumulation, fusion and `auto_accelerate`.

The port's `make_train_step` with `adamw(3e-4)` (torch AdamW with optax's
defaults) against the JAX `auto_accelerate` step with `optax.adamw(3e-4)`,
GPT nano in float32, from the same parameters and on the same batches
(numpy, fixed seed).

Tolerance on the losses: relative 1e-4 over 5 steps.  The forward and
backward agree to ~1e-6 (tests/test_torch_gpt.py), but Adam's first
updates are sign-like: ``lr * m / (sqrt(v) + eps)`` is ~``lr * sign(g)``
for every gradient entry well above eps, so an entry whose gradient sits
within rounding of zero can move by a full ``lr`` = 3e-4 on one side and
not the other.  Such entries carry almost no gradient, so the loss moves
by far less than that, but the error no longer stays at rounding size:
1e-4 relative is the bound that holds it.  Grad norms: relative 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_wuqiong_tpu.auto.accelerate import (
    auto_accelerate as jax_auto_accelerate,
)
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
from dlrover_wuqiong_tpu_torch.convert import load_params
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.trainer.train_step import (
    TrainState,
    adamw,
    auto_fused_steps,
    make_lm_loss,
    make_train_step,
)

VOCAB, SEQ, BATCH = 512, 32, 4
RTOL = 1e-4


def _host_batch(step, accum=0):
    rng = np.random.default_rng(step)
    shape = (accum, BATCH, SEQ + 1) if accum else (BATCH, SEQ + 1)
    x = rng.integers(0, VOCAB, shape).astype(np.int32)
    return {"input_ids": x[..., :-1], "labels": x[..., 1:]}


def _jax_run(steps, accum=0):
    cfg = dataclasses.replace(jgpt.GPTConfig.nano(), dtype=jnp.float32,
                              remat=False)
    res = jax_auto_accelerate(jgpt.GPT(cfg), optimizer=optax.adamw(3e-4),
                              devices=jax.devices()[:1],
                              accum_steps=accum or None)
    params = jax.tree_util.tree_map(np.asarray, res.state.params)
    state = res.state
    losses, norms = [], []
    for i in range(steps):
        state, m = res.train_step(state, res.place_batch(
            _host_batch(i, accum)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, np.array(losses), np.array(norms)


def _torch_state(params):
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                              remat=False)
    model = load_params(tgpt.GPT(cfg), params, device="cpu")
    return TrainState.create(model, adamw(3e-4))


def _torch_batch(hb):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in hb.items()}


def _torch_run(params, steps, accum=0):
    state = _torch_state(params)
    step = make_train_step(make_lm_loss(), accum_steps=accum or 1)
    losses, norms = [], []
    for i in range(steps):
        state, m = step(state, _torch_batch(_host_batch(i, accum)))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    assert int(state.step) == steps
    return np.array(losses), np.array(norms)


@pytest.mark.parametrize("accum", [0, 2])
def test_adamw_trajectory_matches_jax(accum):
    params, jl, jn = _jax_run(5 if not accum else 3, accum)
    tl, tn = _torch_run(params, len(jl), accum)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    np.testing.assert_allclose(tn, jn, rtol=RTOL)


def test_adamw_is_optax_defaults():
    opt = adamw(3e-4)([torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert group["lr"] == 3e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 1e-4


def _snapshot(state):
    return ([p.detach().clone() for p in state.params.parameters()],
            [t.clone() for s in state.opt_state.state.values()
             for t in s.values()])


def test_fused_steps_equal_single_steps_bitwise():
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32)
    params = tgpt.init_params(cfg, seed=3, device="cpu")
    hbs = [_torch_batch(_host_batch(10 + i)) for i in range(4)]
    single = TrainState.create(load_params(tgpt.GPT(cfg), params, "cpu"),
                               adamw(3e-4))
    step = make_train_step(make_lm_loss())
    l1 = []
    for hb in hbs:
        single, m = step(single, hb)
        l1.append(m["loss"])
    fused = TrainState.create(load_params(tgpt.GPT(cfg), params, "cpu"),
                              adamw(3e-4))
    fused, m4 = make_train_step(make_lm_loss(), fused_steps=4)(
        fused, {k: torch.stack([hb[k] for hb in hbs]) for k in hbs[0]})
    assert m4["losses"].shape == (4,) and m4["grad_norms"].shape == (4,)
    assert torch.equal(m4["losses"], torch.stack(l1))
    assert torch.equal(m4["loss"], l1[-1])
    assert int(single.step) == int(fused.step) == 4
    for a, b in zip(*(_snapshot(s) for s in (single, fused))):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_auto_accelerate_trains_on_cpu():
    cfg = tgpt.GPTConfig.nano()  # bf16 compute, remat "full", flash
    res = auto_accelerate(tgpt.GPT(cfg), device="cpu", seed=0)
    hb = _host_batch(0)
    b = res.place_batch(hb)
    assert b["input_ids"].dtype == torch.int64
    first = None
    for _ in range(3):
        res.state, m = res.train_step(res.state, b)
        first = m["loss"].item() if first is None else first
    assert np.isfinite(m["grad_norm"].item())
    assert m["loss"].item() < first
    fb = res.place_fused_batch({k: np.stack([v, v]) for k, v in hb.items()})
    res.state, m2 = res.fused_train_step(2)(res.state, fb)
    assert m2["losses"].shape == (2,) and int(res.state.step) == 5
    assert res.fused_train_step(1) is res.train_step


def test_auto_accelerate_rejects_strategies_and_devices():
    with pytest.raises(ValueError, match="queue 1 item 8"):
        auto_accelerate(tgpt.GPT(tgpt.GPTConfig.nano()), device="cpu",
                        strategy=[("fsdp", {})])
    with pytest.raises(ValueError, match="queue 1 item 8"):
        auto_accelerate(tgpt.GPT(tgpt.GPTConfig.nano()), device="cpu",
                        devices=["cuda:0", "cuda:1"])


@pytest.mark.parametrize("step_s,overhead_s,cadence,want", [
    (0.1, 0.006, 0, 3), (0.0, 0.006, 0, 64), (0.01, 0.006, 10, 10),
    (0.01, 0.006, 12, 12), (0.001, 0.006, 100, 50)])
def test_auto_fused_steps_is_the_jax_formula(step_s, overhead_s, cadence,
                                             want):
    from dlrover_wuqiong_tpu.trainer.train_step import (
        auto_fused_steps as jax_auto_fused_steps,
    )

    got = auto_fused_steps(step_s, overhead_s, cadence=cadence)
    assert got == jax_auto_fused_steps(step_s, overhead_s,
                                       cadence=cadence) == want
