"""Port parity: stable bf16 training, the optimizer offload and the slow
host link guard.

- `StableBF16` in both modes against JAX's ``stable_bf16`` over
  ``adamw`` and over ``adamw8bit``, on the same bf16 leaves and
  gradients, 6 steps on the CPU.  Over adamw8bit both sides run the
  same float32 operations (optimizers/low_bit.py): parameters,
  compensation or masters, and the inner codes are bitwise JAX's.  Over
  adamw the inner rule is torch's AdamW over the float32 gradient,
  while optax's adam squares the bf16 gradient in bf16 (2^-9 relative
  on each term of nu) before adding it to its float32 nu; each update
  then differs by up to ~2^-10 of its lr-sized step, so the precise
  value p + e (Kahan) or the master stays within ``PRECISE_ATOL`` =
  steps * lr * 2^-8 of JAX's, and every parameter within ``BF16_ULPS``
  bf16 ulp of JAX's (a value beside a rounding boundary may land on the
  other side), or within ``PRECISE_ATOL`` near zero, where a bf16 ulp
  is finer than that.
- `reset_compensation` as JAX's after the parameters were rewritten.
- The strategy: ``("stable_bf16", {...})`` makes GPT nano's parameters
  bf16 and trains it; its losses stay within ``STABLE_LOSS_RTOL`` of
  the float32 adamw run's, step for step (the bound chip_smoke.py holds
  GPT-2 124M's stable_bf16 builds to).
- ``("optimizer_offload", {})``: the state lives in host tensors between
  steps (pinned where the parameters are on CUDA; here the CPU) and a
  step is bitwise the on-device step's, for adamw, adamw8bit and AGD,
  and with stable_bf16 (the whole `StableBF16` state offloaded, as JAX
  offloads the whole ``opt_state``), whose losses also stay within
  ``STABLE_LOSS_RTOL`` of JAX's on the same combination.
- The slow-link guard warns at 0.05 GB/s and stays silent at 50 GB/s
  (after tests/test_bf16_stable.py:119-151).
"""

import dataclasses
import logging
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import dlrover_wuqiong_tpu.optimizers.bf16_stable  # noqa: F401
import dlrover_wuqiong_tpu.optimizers.low_bit  # noqa: F401
from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.optimizers import (
    StableBF16,
    adamw8bit,
    agd,
    reset_compensation,
)
from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw
from torch_threads import one_torch_thread  # noqa: F401

jbf = sys.modules["dlrover_wuqiong_tpu.optimizers.bf16_stable"]
jlow = sys.modules["dlrover_wuqiong_tpu.optimizers.low_bit"]

BF16_ULPS = 1
STEPS = 6
LR = 1e-2
PRECISE_ATOL = STEPS * LR * 2.0 ** -8
STABLE_LOSS_RTOL = 2e-2
SHAPES = [(5,), (3, 300), (7, 11, 4)]


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _leaves(seed, steps):
    rng = np.random.default_rng(seed)
    w0 = [_bf16(rng.standard_normal(s)) for s in SHAPES]
    grads = [[_bf16(rng.standard_normal(s) * (0.1 + t)) for s in SHAPES]
             for t in range(steps)]
    return w0, grads


INNER = {
    "adamw": (lambda: optax.adamw(LR, weight_decay=0.1),
              lambda: adamw(LR, weight_decay=0.1)),
    "adamw8bit": (lambda: jlow.adamw8bit(LR, weight_decay=0.1),
                  lambda: adamw8bit(LR, weight_decay=0.1)),
}


def _to_torch(x):
    return torch.from_numpy(np.asarray(x).astype(np.float32)).to(
        torch.bfloat16)


def _run(inner, master, steps=STEPS):
    jinner, tinner = INNER[inner]
    w0, grads = _leaves(3, steps)
    tx = jbf.stable_bf16(jinner(), master=master)
    params = {f"p{i}": jnp.asarray(w) for i, w in enumerate(w0)}
    state = tx.init(params)
    for gs in grads:
        g = {f"p{i}": jnp.asarray(x) for i, x in enumerate(gs)}
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
    ps = [torch.nn.Parameter(_to_torch(w)) for w in w0]
    opt = StableBF16(ps, tinner(), master=master)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = _to_torch(g)
        opt.step()
    return params, state, ps, opt


def _bits(x):
    return np.asarray(x).view(np.uint16).astype(np.int64)


@pytest.mark.parametrize("inner", sorted(INNER))
@pytest.mark.parametrize("master", [False, True], ids=["kahan", "master"])
def test_stable_bf16_matches_jax(inner, master):
    params, state, ps, opt = _run(inner, master)
    for i, p in enumerate(ps):
        assert p.dtype == torch.bfloat16
        want = np.asarray(params[f"p{i}"])
        got = p.detach().float().numpy().astype(ml_dtypes.bfloat16)
        comp_w = np.asarray(state.comp[f"p{i}"])
        comp_g = opt.comp[i]
        if inner == "adamw8bit":
            assert np.array_equal(_bits(got), _bits(want)), i
            cg = (comp_g.float().numpy().astype(ml_dtypes.bfloat16)
                  if not master else comp_g.numpy())
            assert np.array_equal(np.asarray(cg).view(
                np.uint16 if not master else np.uint32),
                comp_w.view(np.uint16 if not master else np.uint32)), i
            mq, nq = opt.inner.qtensors(opt.views[i])
            jmu = state.inner[0].mu[f"p{i}"]
            assert np.array_equal(mq.q.numpy(), np.asarray(jmu.q))
            assert np.array_equal(mq.scale.numpy(), np.asarray(jmu.scale))
            continue
        # one bf16 ulp of JAX's value, or the precise values' bound where
        # a bf16 ulp is finer (values near zero)
        w32, g32 = want.astype(np.float32), got.astype(np.float32)
        ulp = np.spacing(np.abs(w32).astype(ml_dtypes.bfloat16)).astype(
            np.float32)
        assert (np.abs(g32 - w32) <= np.maximum(BF16_ULPS * ulp,
                                                PRECISE_ATOL)).all(), i
        if master:
            pw, pg = comp_w, comp_g.numpy()
        else:
            pw = want.astype(np.float32) + comp_w.astype(np.float32)
            pg = (p.detach().float() + comp_g.float()).numpy()
        np.testing.assert_allclose(pg, pw, rtol=0, atol=PRECISE_ATOL)


@pytest.mark.parametrize("master", [False, True], ids=["kahan", "master"])
def test_reset_compensation_matches_jax(master):
    params, state, ps, opt = _run("adamw8bit", master, steps=3)
    rng = np.random.default_rng(9)
    new = [_bf16(rng.standard_normal(s)) for s in SHAPES]
    jnew = {f"p{i}": jnp.asarray(w) for i, w in enumerate(new)}
    jstate = jbf.reset_compensation(state, jnew, master)
    with torch.no_grad():
        for p, w in zip(ps, new):
            p.copy_(_to_torch(w))
    assert reset_compensation(opt) is opt
    for i, c in enumerate(opt.comp):
        want = np.asarray(jstate.comp[f"p{i}"]).astype(np.float32)
        assert np.array_equal(c.float().numpy(), want), i
    # the inner state is kept
    assert int(opt.inner.count) == int(jstate.inner[0].count) == 3


def _gpt(strategy=(), optimizer=None, steps=5):
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                              remat=False)
    res = auto_accelerate(tgpt.GPT(cfg), optimizer=optimizer or adamw(3e-3),
                          device="cpu", seed=0, strategy=list(strategy))
    ids = np.random.default_rng(2).integers(0, 512, (4, 33))
    b = res.place_batch({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    losses = []
    for _ in range(steps):
        res.state, m = res.train_step(res.state, b)
        losses.append(m["loss"].item())
    return res, np.asarray(losses)


@pytest.mark.parametrize("master", [False, True], ids=["kahan", "master"])
def test_strategy_trains_bf16_parameters(master):
    _, ref = _gpt()
    res, losses = _gpt([("stable_bf16", {"master": master})])
    assert all(p.dtype == torch.bfloat16 for p in res.model.parameters())
    assert isinstance(res.state.opt_state, StableBF16)
    assert res.state.opt_state.master is master
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    rel = np.abs(losses - ref) / np.abs(ref)
    assert rel.max() <= STABLE_LOSS_RTOL, (losses, ref)


OFFLOADED = {"adamw": lambda: adamw(3e-3),
             "adamw8bit": lambda: adamw8bit(3e-3, weight_decay=0.1),
             "agd": lambda: agd(1e-3, amsgrad=True)}


@pytest.mark.parametrize("name", sorted(OFFLOADED))
def test_optimizer_offload_step_is_the_on_device_step(name):
    dev, l_dev = _gpt(optimizer=OFFLOADED[name](), steps=3)
    off, l_off = _gpt([("optimizer_offload", {})],
                      optimizer=OFFLOADED[name](), steps=3)
    opt = off.state.opt_state
    assert opt.offload_hops is not None
    assert np.array_equal(l_dev, l_off)
    for a, b in zip(dev.model.parameters(), off.model.parameters()):
        assert torch.equal(a, b)
    # between steps every state leaf is a host tensor of its own (the
    # host copy offload_state made), and no device copy is left behind
    for p in off.model.parameters():
        st = opt.state[p]
        tensors = {k: v for k, v in st.items() if torch.is_tensor(v)}
        assert tensors and all(v.device.type == "cpu"
                               for v in tensors.values())
    assert not opt.offload_hops._device
    ta, tb = dev.state.tree(), off.state.tree()
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        flatten_state_dict,
    )

    fa, fb = flatten_state_dict(ta), flatten_state_dict(tb)
    assert list(fa) == list(fb)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_stable_bf16_with_offload_raises():
    """The combination no longer raises (it did until the whole
    `StableBF16` state learned to offload): with optimizer_offload the
    inner moments and the compensation or masters live in host tensors
    between steps, and each step is bitwise the on-device stable_bf16
    step, in both modes."""
    for master in (False, True):
        sb = ("stable_bf16", {"master": master})
        dev, l_dev = _gpt([sb], steps=3)
        off, l_off = _gpt([sb, ("optimizer_offload", {})], steps=3)
        opt = off.state.opt_state
        assert isinstance(opt, StableBF16) and opt.offload_hops is not None
        assert np.array_equal(l_dev, l_off), master
        for a, b in zip(dev.model.parameters(), off.model.parameters()):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert all(c.device.type == "cpu" for c in opt.comp)
        for view in opt.views:
            st = opt.inner.state[view]
            assert all(v.device.type == "cpu" for k, v in st.items()
                       if torch.is_tensor(v) and k != "step")
        assert not opt.offload_hops._device
        from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
            flatten_state_dict,
        )

        fa = flatten_state_dict(dev.state.tree())
        fb = flatten_state_dict(off.state.tree())
        assert list(fa) == list(fb)
        assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_stable_bf16_offload_losses_match_jax():
    """GPT nano under [("stable_bf16", {}), ("optimizer_offload", {})] from
    JAX's initial bf16 parameters: the port's losses stay within
    ``STABLE_LOSS_RTOL`` of JAX's, step for step (the first step's, from
    the same parameters, within 1e-5)."""
    from dlrover_wuqiong_tpu.auto.accelerate import (
        auto_accelerate as jax_auto_accelerate,
    )
    from dlrover_wuqiong_tpu.models import gpt as jgpt

    strategy = [("stable_bf16", {}), ("optimizer_offload", {})]
    jcfg = dataclasses.replace(jgpt.GPTConfig.nano(), dtype=jnp.float32,
                               remat=False)
    jres = jax_auto_accelerate(jgpt.GPT(jcfg), optimizer=optax.adamw(3e-3),
                               devices=jax.devices()[:1], strategy=strategy)
    params = jax.tree_util.tree_map(np.asarray, jres.state.params)
    ids = np.random.default_rng(2).integers(0, 512, (4, 33))
    hb = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    state, want = jres.state, []
    for _ in range(5):
        state, m = jres.train_step(state, jres.place_batch(hb))
        want.append(float(m["loss"]))
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                              remat=False)
    res = auto_accelerate(tgpt.GPT(cfg), optimizer=adamw(3e-3),
                          device="cpu", seed=0, strategy=strategy)
    flat = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat[".".join(str(p.key) for p in path)] = v
    with torch.no_grad():
        for n, p in res.model.named_parameters():
            p.copy_(_to_torch(flat[n]))
    b = res.place_batch(hb)
    got = []
    for _ in range(5):
        res.state, m = res.train_step(res.state, b)
        got.append(m["loss"].item())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=STABLE_LOSS_RTOL)


class TestSlowOffloadLinkGuard:
    """Offload strategies on a slow host link warn at resolve time with
    the measured rate (JAX's rule and message)."""

    def _accelerate(self, caplog, monkeypatch, gbps, strategy):
        monkeypatch.setenv("DWT_H2D_GBPS", str(gbps))
        # the package logger does not propagate to root (common/log.py);
        # caplog's handler sits on root
        monkeypatch.setattr(logging.getLogger("dwt"), "propagate", True)
        cfg = dataclasses.replace(tgpt.GPTConfig.nano(), n_layer=1,
                                  dtype=torch.float32, remat=False)
        with caplog.at_level(logging.WARNING, logger="dwt.accelerate"):
            auto_accelerate(tgpt.GPT(cfg), device="cpu", strategy=strategy)
        return caplog.text

    @pytest.mark.parametrize("strategy", [
        [("optimizer_offload", {})],
        [("checkpoint", {"policy": "offload_dots"})]],
        ids=["optimizer_offload", "offload_dots"])
    def test_slow_link_warns(self, caplog, monkeypatch, strategy):
        text = self._accelerate(caplog, monkeypatch, 0.05, strategy)
        assert "slow host link" in text and "0.050 GB/s" in text

    def test_fast_link_silent(self, caplog, monkeypatch):
        text = self._accelerate(caplog, monkeypatch, 50.0,
                                [("optimizer_offload", {})])
        assert "slow host link" not in text

    def test_no_offload_no_probe(self, caplog, monkeypatch):
        text = self._accelerate(caplog, monkeypatch, 0.05, [])
        assert "slow host link" not in text


def test_jax_guard_text_is_the_ports(caplog, monkeypatch):
    """The warning's opening words are JAX's."""
    import inspect

    from dlrover_wuqiong_tpu.auto import accelerate as jacc
    from dlrover_wuqiong_tpu_torch.auto import accelerate as tacc

    for src in (inspect.getsource(jacc._warn_slow_offload_link),
                inspect.getsource(tacc._warn_slow_offload_link)):
        assert '"%s selected on a slow host link: measured H2D %.3f GB/s' \
            in src
    assert jax  # the JAX package runs on the CPU here
