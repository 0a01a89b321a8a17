"""Port parity: sequence parallelism (`parallel/long_context.py`, the
``sequence_parallel`` strategy) against the JAX package on the CPU.

- `_merge_partials` and `_attention_with_lse` against JAX's, ``-inf``
  partials included.
- Ring, Ulysses and gathered ("gspmd") attention, causal and full, in a
  gloo world of 4 against JAX's `ring_attention` / `ulysses_attention`
  on 4 host devices (gathered against JAX's `_attention_reference`, which
  GSPMD computes for that impl), outputs and the gradients of the global
  sum of squares, at JAX's own bounds (2e-5 and 5e-4,
  tests/test_long_context.py:59-115).  The same local bodies driven in
  one process (`long_context.emulated`, the chip check's transport)
  hold the same bounds.
- sp 1 falls through to flash attention; Ulysses refuses heads that do
  not divide sp with JAX's messages.
- ``sequence_parallel`` 4 (ring, Ulysses, gathered) + fsdp trains GPT
  (4 heads, JAX's test config) and Llama nano in the world of 4 against
  JAX's same strategy (tests/test_long_context.py:130-150) from JAX's
  initial state, 4 steps of adamw(1e-4) in float32: the losses and grad
  norms at every step, and every leaf, to ``RTOL`` = 1e-5 as in
  tests/test_torch_parallel_small_lr.py.  Each rank's chunk starts at
  position r * T / 4, so a rank that read positions from 0 (GPT's wpe,
  Llama's RoPE) would miss the bound.

One world runs every port case of the module (`torch_world.run_world`);
the JAX side runs once, in the module-scoped fixture that waits on it.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

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
from dlrover_wuqiong_tpu.checkpoint.shm_handler import (
    flatten_state_dict as jax_flatten,
)
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import llama as jllama
from dlrover_wuqiong_tpu.ops.flash_attention import _attention_reference
from dlrover_wuqiong_tpu.parallel import long_context as jlc
from dlrover_wuqiong_tpu.parallel.mesh import MeshPlan as JMeshPlan
from dlrover_wuqiong_tpu.parallel.mesh import build_mesh as jbuild_mesh
from dlrover_wuqiong_tpu_torch.auto import accelerate as tacc
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.ops.flash_attention import flash_attention
from dlrover_wuqiong_tpu_torch.parallel import long_context as tlc
from dlrover_wuqiong_tpu_torch.parallel.mesh import MeshPlan
from torch_threads import one_torch_thread  # noqa: F401

OUT_ATOL, GRAD_ATOL = 2e-5, 5e-4  # JAX's own bounds
RTOL, SMALL_LR = 1e-5, 1e-4
SP = 4
IMPLS = ("ring", "ulysses", "gspmd")
#: JAX's sequence-parallel training config (tests/test_long_context.py)
GPT4 = {"n_head": 4, "n_embd": 64}

#: key -> (family, impl, port config overrides)
TRAINING = {
    "gpt_ring": ("gpt", "ring", GPT4),
    "gpt_ulysses": ("gpt", "ulysses", GPT4),
    "gpt_gspmd": ("gpt", "gspmd", GPT4),
    "llama_ring": ("llama", "ring", {}),
    "llama_ulysses": ("llama", "ulysses", {}),
}


def _strategy(impl):
    return [("sequence_parallel", {"size": SP, "impl": impl}), ("fsdp", {})]


def _qkv(seed, b=2, h=4, s=128, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32)
                 for _ in range(3))


def _jax_attention(impl, q, k, v, causal, mesh):
    """JAX's output and its gradients of the sum of squares."""
    scale = 1.0 / np.sqrt(q.shape[-1])

    def f(q, k, v):
        if impl == "ring":
            o = jlc.ring_attention(q, k, v, mesh, causal=causal)
        elif impl == "ulysses":
            o = jlc.ulysses_attention(q, k, v, mesh, causal=causal)
        else:
            o = _attention_reference(q, k, v, causal, scale)
        return (o ** 2).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(*(jnp.asarray(x)
                                              for x in (q, k, v)))
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


def _jax_build(family, impl):
    if family == "gpt":
        model = jgpt.GPT(dataclasses.replace(jgpt.GPTConfig.nano(), **GPT4))
    else:
        model = jllama.Llama(jllama.LlamaConfig.nano())
    return jax_auto_accelerate(
        model, optimizer=optax.adamw(SMALL_LR), devices=jax.devices()[:SP],
        strategy=_strategy(impl) + [("half", {"enabled": False})])


def _jax_steps(res):
    state, metrics = res.state, []
    for b in tw.host_batches():
        state, m = res.train_step(state, res.place_batch(b, seq_axis=1))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    params = {k.replace("/", "."): np.asarray(v, dtype=np.float32)
              for k, v in jax_flatten(state.params).items()}
    return {"metrics": metrics, "params": params}


@pytest.fixture(scope="module")
def runs():
    """JAX's side and the port's world of `SP` ranks.  The world starts
    once JAX's initial states exist and runs beside JAX's attention and
    steps (a thread waits on it)."""
    builds = {key: _jax_build(family, impl)
              for key, (family, impl, _) in TRAINING.items()}
    inits = {key: {k: np.asarray(v) for k, v in
                   jax_flatten(res.state).items()}
             for key, res in builds.items()}
    q, k, v = _qkv(2)
    cases = [(key, family, _strategy(impl), "adamw", SMALL_LR)
             for key, (family, impl, _) in TRAINING.items()]
    overrides = {key: o for key, (_, _, o) in TRAINING.items()}
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(tw.run_world, SP, tw.long_context_world, q, k, v,
                            IMPLS, cases, inits, overrides)
        mesh = jbuild_mesh(JMeshPlan(sp=SP), devices=jax.devices()[:SP])
        attention = {(impl, causal): _jax_attention(impl, q, k, v, causal,
                                                    mesh)
                     for impl in IMPLS for causal in (True, False)}
        training = {key: _jax_steps(res) for key, res in builds.items()}
        return {"qkv": (q, k, v), "attention": attention,
                "training": training, "world": world.result()}


# ------------------------------------------------------------ lse math


def test_merge_partials_matches_jax():
    """Two halves of the keys merge to the whole; an empty (-inf)
    partial on either side, or on both for some rows, weighs 0."""
    q, k, v = _qkv(0, s=64)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    halves = [(t[1][:, :, :32], t[2][:, :, :32]),
              (t[1][:, :, 32:], t[2][:, :, 32:])]
    (o1, l1), (o2, l2) = (tlc._attention_with_lse(t[0], kk, vv, False, None)
                          for kk, vv in halves)
    empty_l = torch.full_like(l1, -np.inf)
    mixed_l = l2.clone()
    mixed_l[:, :, :8] = -np.inf
    both = l1.clone()
    both[:, :, :4] = -np.inf
    whole, _ = tlc._attention_with_lse(*t, False, None)
    cases = {"halves": (o1, l1, o2, l2),
             "empty_right": (o1, l1, torch.zeros_like(o2), empty_l),
             "empty_left": (torch.zeros_like(o1), empty_l, o2, l2),
             "mixed": (o1, l1, o2, mixed_l),
             "both_empty_rows": (o1, both, o2, torch.where(
                 torch.isfinite(both), l2, -np.inf))}
    for name, args in cases.items():
        o, lse = tlc._merge_partials(*args)
        jo, jl = jlc._merge_partials(*(jnp.asarray(a.numpy()) for a in args))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-6,
                                   err_msg=name)
        assert np.array_equal(np.isinf(lse.numpy()), np.isinf(np.asarray(jl)))
    o, _ = tlc._merge_partials(o1, l1, o2, l2)
    np.testing.assert_allclose(o.numpy(), whole.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_with_lse_matches_jax(causal):
    q, k, v = _qkv(1, s=32)
    o, lse = tlc._attention_with_lse(*(torch.from_numpy(x) for x in
                                       (q, k[:, :, :24], v[:, :, :24])),
                                     causal, None)
    jo, jl = jlc._attention_with_lse(*(jnp.asarray(x) for x in
                                       (q, k[:, :, :24], v[:, :, :24])),
                                     causal, None)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-6)


def test_batch_dims_are_jax_qkv_spec():
    for plan, batch in ((MeshPlan(dp=2, fsdp=2, sp=2), 8),
                        (MeshPlan(dp=2, fsdp=4), 2),
                        (MeshPlan(fsdp=4, sp=2), 6),
                        (MeshPlan(sp=8), 4)):
        jmesh = jbuild_mesh(JMeshPlan(**plan.sizes()))
        want = jlc._qkv_spec(jmesh, "sp", batch)[0]
        want = (() if want is None else (want,) if isinstance(want, str)
                else tuple(want))
        assert tlc._batch_dims(plan, batch) == want, (plan, batch)


# ------------------------------------------------------------ attention


def _held(got, want, what):
    np.testing.assert_allclose(got[0], want[0], atol=OUT_ATOL, err_msg=what)
    for g, w, name in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL,
                                   err_msg=f"{what} d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("impl", IMPLS)
def test_sp_attention_matches_jax_in_a_world(impl, causal, runs):
    """Each rank's chunk of the output and of dq, dk, dv, concatenated
    along the sequence."""
    got = [np.concatenate([r["attention"][impl, causal][i]
                           for r in runs["world"]], axis=2)
           for i in range(4)]
    _held(got, runs["attention"][impl, causal], f"{impl} causal={causal}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("impl", IMPLS)
def test_emulated_bodies_match_jax(impl, causal, runs):
    """The same local bodies with the one-process transport."""
    chunks = [[torch.from_numpy(c).clone().requires_grad_()
               for c in np.split(x, SP, axis=2)] for x in runs["qkv"]]
    out = tlc.emulated(impl, *chunks, causal=causal)
    sum(o.pow(2).sum() for o in out).backward()
    got = [torch.cat(out, 2).detach().numpy()] + [
        torch.cat([c.grad for c in cs], 2).numpy() for cs in chunks]
    _held(got, runs["attention"][impl, causal],
          f"emulated {impl} causal={causal}")


@pytest.mark.parametrize("impl", IMPLS)
def test_sp1_falls_through_to_flash(impl):
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, s=64))
    got = tlc.SP_ATTENTION[impl](q, k, v, MeshPlan(fsdp=8), causal=True)
    assert torch.equal(got, flash_attention(q, k, v, True))
    ctx = tacc.resolve_strategy([("sequence_parallel", {"size": 1,
                                                        "impl": impl})], 1)
    model = tgpt.GPT(tgpt.GPTConfig.nano())
    mesh = MeshPlan(fsdp=8)  # any mesh: the rebuild only stores it
    rebuilt = tacc._on_mesh(model, ctx, mesh)
    assert rebuilt.config.mesh is mesh
    assert rebuilt.config.attn_impl == model.config.attn_impl == "flash"


def test_ulysses_heads_must_divide_sp():
    q, k, v = _qkv(4, h=3)
    with pytest.raises(ValueError, match="divisible") as want:
        jlc.ulysses_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              jbuild_mesh(JMeshPlan(sp=4, fsdp=2)))
    with pytest.raises(ValueError, match="divisible") as got:
        tlc.ulysses_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              MeshPlan(sp=4, fsdp=2))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="divisible") as want:
        jax_auto_accelerate(jgpt.GPT(jgpt.GPTConfig.nano()),
                            devices=jax.devices()[:4],
                            strategy=_strategy("ulysses"))
    ctx = tacc.resolve_strategy(_strategy("ulysses"), 4)
    with pytest.raises(ValueError, match="divisible") as got:
        tacc._on_mesh(tgpt.GPT(tgpt.GPTConfig.nano()), ctx, None)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ training


@pytest.mark.parametrize("key", sorted(TRAINING))
def test_sequence_parallel_training_matches_jax(key, runs):
    world = runs["world"]
    got, want = world[0]["training"][key], runs["training"][key]
    assert got["plan"] == "sp4"
    for r in world[1:]:
        assert r["training"][key]["metrics"] == got["metrics"]
    np.testing.assert_allclose(np.asarray(got["metrics"]),
                               np.asarray(want["metrics"]), rtol=RTOL,
                               err_msg=key)
    spread = tw.leaf_spread(got["params"], want["params"])
    assert spread[0] <= RTOL, (key, spread)
    # GPT's key bias: zero gradient in exact arithmetic, rounding noise
    # moves it by up to lr a step (torch_world.split_key_bias)
    (_, gk), (_, wk) = (tw.split_key_bias(got["params"]),
                        tw.split_key_bias(want["params"]))
    for n in wk:
        assert np.abs(gk[n] - wk[n]).max() <= 2 * SMALL_LR * tw.STEPS, (
            key, n)
