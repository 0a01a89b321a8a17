"""Port parity: the Mixture-of-Experts MLP against the JAX package's.

- `top_k_gating` on the same numpy logits (top-1, top-2, and a capacity
  small enough to drop overflow tokens): dispatch bitwise JAX's; combine
  within 4 float32 ulps (2.4e-7 relative) of JAX's, because the two
  libraries' ``exp`` differ by an ulp on some inputs (~8% of normal
  draws), so the router softmax does; bitwise on logits whose softmax
  both compute exactly (rows of equal logits: ties, all going to the
  lowest index first).
- The tie order of the top-k pick: `_top_k` is ``lax.top_k`` on ties
  (the lower index first), where ``torch.topk`` is not.
- `grouped_moe` against JAX's and against the explicit expert loop of
  tests/test_moe.py (1e-6 absolute here, as float32 sums in another
  order; the JAX test holds its loop to 1e-4), nothing dropped under
  imbalance, and the grouped impl against the capacity impl where the
  capacity holds every token.
- GPT nano with ``moe_experts=4``, float32: logits, the loss with the aux
  loss and every gradient (router and experts too) against JAX's, with
  remat on and off, at test_torch_gpt.py's tolerances (1e-4; gradients
  1e-4 absolute plus 1e-3 relative); the aux loss alone within 1e-6.
- A few `auto_accelerate` steps of an MoE nano on the CPU: the loss falls.
- The MoE leaves at flax's paths round-trip through `convert`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import moe as jmoe
from dlrover_wuqiong_tpu.trainer.train_step import make_lm_loss as jloss_fn
from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
from dlrover_wuqiong_tpu_torch.convert import export_params, load_params
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.models import moe as tmoe
from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw, make_lm_loss
from torch_threads import one_torch_thread  # noqa: F401

B, T, E = 2, 32, 4


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("k,capacity", [(1, 16), (2, 24), (2, 5)])
def test_top_k_gating_matches_jax(k, capacity):
    logits = np.random.default_rng(k * 100 + capacity).standard_normal(
        (32, E)).astype(np.float32)
    logits[3] = 0.0   # a tie over all experts
    logits[7] = logits[7, 0]
    jc, jd = jmoe.top_k_gating(jnp.asarray(logits), k, capacity)
    tc, td = tmoe.top_k_gating(torch.from_numpy(logits), k, capacity)
    assert tc.dtype == torch.float32 and td.dtype == torch.bool
    assert np.array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2.4e-7,
                               atol=0)
    for row in (3, 7):
        assert np.array_equal(np.asarray(jc)[row], tc.numpy()[row])
    kept = td.numpy().reshape(32, -1).sum(1)
    if capacity * E < 32 * k:   # overflow: some token lost an expert
        assert kept.min() < k
    else:
        assert (kept == k).all()


def test_top_k_tie_order_is_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.3, 0.2, 0.2], [0.1, 0.2, 0.3, 0.4]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tmoe._top_k(torch.from_numpy(probs), 2)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert ti.tolist() == [[0, 1], [1, 2], [0, 1], [3, 2]]


def _moe_inputs(seed=0, t=16, d=8, f=16, e=E):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    return rng.standard_normal((t, d)).astype(np.float32), probs, ws


def test_grouped_moe_matches_jax_and_the_expert_loop():
    tokens, probs, (w_gate, w_in, w_down) = _moe_inputs()
    k = 2
    want = np.asarray(jmoe.grouped_moe(
        jnp.asarray(tokens), jnp.asarray(probs), jnp.asarray(w_gate),
        jnp.asarray(w_in), jnp.asarray(w_down), k))
    got = tmoe.grouped_moe(*(torch.from_numpy(np.array(a)) for a in (
        tokens, probs, w_gate, w_in, w_down)), k).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # tests/test_moe.py:125's explicit loop
    gates, experts = jax.lax.top_k(jnp.asarray(probs), k)
    gates = np.asarray(gates / gates.sum(-1, keepdims=True))
    loop = np.zeros_like(tokens)
    for t in range(tokens.shape[0]):
        for j in range(k):
            e = int(experts[t, j])
            x = tokens[t]
            a = x @ w_gate[e]
            h = a / (1 + np.exp(-a)) * (x @ w_in[e])
            loop[t] += gates[t, j] * (h @ w_down[e])
    np.testing.assert_allclose(got, loop, atol=1e-5)


def test_grouped_moe_drops_nothing_under_imbalance():
    t, d, f = 32, 4, 8
    tokens = torch.ones((t, d))
    probs = torch.zeros((t, E))
    probs[:, 0] = 0.9
    probs[:, 1] = 0.1
    w = [torch.full(s, 0.1) for s in ((E, d, f), (E, d, f), (E, f, d))]
    out = tmoe.grouped_moe(tokens, probs, *w, top_k=1)
    assert torch.all(out != 0) and torch.allclose(out, out[0].expand_as(out))
    jout = jmoe.grouped_moe(jnp.ones((t, d)), jnp.asarray(probs.numpy()),
                            *(jnp.asarray(x.numpy()) for x in w), 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)


def test_grouped_and_capacity_impls_agree_when_nothing_drops():
    torch.manual_seed(0)
    cfg = tmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=float(E),
                         dtype=torch.float32)
    mlp = tmoe.MoEMLP(8, 16, cfg)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
    x = torch.randn(2, 16, 8)
    cap, aux_c = mlp(x)
    mlp.moe = dataclasses.replace(cfg, impl="grouped")
    grp, aux_g = mlp(x)
    torch.testing.assert_close(grp, cap, atol=1e-5, rtol=1e-5)
    assert torch.equal(aux_c, aux_g)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (B, T + 1))
    labels = ids[:, 1:].copy()
    labels[1, -3:] = -1
    return ids[:, :-1], labels


@pytest.fixture(scope="module")
def jparams():
    cfg = dataclasses.replace(jgpt.GPTConfig.nano(), dtype=jnp.float32,
                              moe_experts=E)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jgpt.GPT(cfg).init_params)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_moe(jparams, batch):
    """JAX's logits, loss (with the aux loss, through its make_lm_loss),
    aux loss and grads, remat off."""
    cfg = dataclasses.replace(jgpt.GPTConfig.nano(), dtype=jnp.float32,
                              moe_experts=E, remat=False)
    model = jgpt.GPT(cfg)
    ids, labels = (jnp.asarray(x) for x in batch)
    loss_fn = jloss_fn(model.apply)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jparams, {"input_ids": ids, "labels": labels})
    logits, inter = model.apply({"params": jparams}, ids,
                                mutable=["intermediates"])
    aux = jmoe.collect_moe_aux_loss(inter["intermediates"])
    return (np.asarray(logits), float(loss), float(aux),
            {k: np.asarray(v) for k, v in _paths(grads).items()})


@pytest.mark.parametrize("remat", [False, True])
def test_moe_gpt_matches_jax(jparams, batch, jax_moe, remat):
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                              moe_experts=E, remat=remat)
    model = load_params(tgpt.GPT(cfg), jparams, device="cpu")
    ids, labels = (torch.from_numpy(x) for x in batch)
    loss = make_lm_loss()(model, {"input_ids": ids, "labels": labels})
    logits = model(ids)
    aux = tmoe.collect_moe_aux_loss(model.intermediates)
    loss.backward()
    jl, jloss, jaux, jg = jax_moe
    assert sorted(_paths(model.intermediates)) == [
        f"h_{i}.moe_mlp.moe_aux_loss" for i in range(cfg.n_layer)]
    np.testing.assert_allclose(logits.detach().numpy(), jl, atol=1e-4,
                               rtol=1e-4)
    assert abs(aux.item() - jaux) <= 1e-6 and aux.item() > 0
    assert abs(loss.item() - jloss) <= 1e-4
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(jg)
    assert "h_0.moe_mlp.router.kernel" in grads
    assert np.abs(grads["h_0.moe_mlp.router.kernel"]).max() > 0
    for name in jg:
        np.testing.assert_allclose(grads[name], jg[name], atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_moe_leaves_round_trip_and_init_layout(jparams):
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                              moe_experts=E)
    model = load_params(tgpt.GPT(cfg), jparams, device="cpu")
    exported = _paths(export_params(model))
    assert sorted(exported) == sorted(_paths(jparams))
    for name, value in _paths(jparams).items():
        assert np.array_equal(exported[name].numpy(), value), name
    init = _paths(tgpt.init_params(cfg, seed=0, device="cpu"))
    assert {n: tuple(v.shape) for n, v in init.items()} == \
        {n: v.shape for n, v in _paths(jparams).items()}
    w = init["h_0.moe_mlp.experts_w_in"]
    assert w.dtype == torch.float32 and 0.015 < w.std().item() < 0.025


def test_moe_auto_accelerate_trains_on_cpu():
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), moe_experts=E)
    res = auto_accelerate(tgpt.GPT(cfg), optimizer=adamw(1e-3),
                          device="cpu", seed=0)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 512, (B, T + 1))
    b = res.place_batch({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    losses = []
    for _ in range(4):
        res.state, m = res.train_step(res.state, b)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
