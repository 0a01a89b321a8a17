"""Port parity: the Llama family against the JAX model.

Both sides run `LlamaConfig.nano()` (4 heads over 2 kv heads, head dim
32) on the same weights (the JAX model's init, loaded into the port's
`Llama` by path with `load_params`) and the same tokens from numpy.
Compared: logits, `cross_entropy_loss` with some labels at -1 (ignored)
and the gradient of every parameter, with the port's remat on and off and
with both attention branches (flash and einsum); RoPE, RMSNorm and a GQA
attention layer on their own; the seeded init's layout; three adamw steps
through `auto_accelerate`; the export round trip.

Tolerances:
- float32: logits and loss within 1e-4, gradients within 1e-4 absolute
  plus 1e-3 relative (as tests/test_torch_gpt.py: the two sides sum in
  other orders, and the flash branch runs the port's plain attention
  against JAX's CPU reference).
- bfloat16 compute over float32 masters: logits within 0.1 absolute,
  loss within 1e-2, gradients within 5% of each leaf's largest magnitude
  (bf16 rounds at 2^-8 relative, at other points on the two sides).
- RoPE table: 1e-6 absolute (cos and sin of float32 angles up to 8191
  radians; both sides compute ``inv`` in float32 and agree on it, so
  what is left is each library's cos/sin rounding, a few float32 ulps).
  Rotated values: 1e-5 times the input's largest magnitude in float32;
  in bfloat16 one bf16 ulp (2^-7 relative) of each value.
- RMSNorm: 1e-6 relative in float32 (a mean and an rsqrt); one bf16 ulp
  in bfloat16.
- Three adamw steps: 1e-4 relative on losses and grad norms, as
  tests/test_torch_train_step.py holds GPT (Adam's sign-like first
  updates move near-zero gradient entries by a whole learning rate).
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
from dlrover_wuqiong_tpu.models import llama as jllama
from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
from dlrover_wuqiong_tpu_torch.convert import (
    export_params,
    load_params,
)
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.models import llama as tllama
from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

B, T = 2, 32
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def jparams():
    cfg = dataclasses.replace(jllama.LlamaConfig.nano(), dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray,
        jax.jit(jllama.Llama(cfg).init_params)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (B, T + 1))
    labels = ids[:, 1:].copy()
    labels[0, :5] = -1
    labels[1, -3:] = -1
    return ids[:, :-1], labels


def _jax_side(jparams, batch, **cfg_kw):
    cfg = dataclasses.replace(jllama.LlamaConfig.nano(), **cfg_kw)
    model = jllama.Llama(cfg)
    ids, labels = (jnp.asarray(x) for x in batch)

    def loss_fn(p):
        logits = model.apply({"params": p}, ids)
        return jgpt.cross_entropy_loss(logits, labels), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    return (np.asarray(logits, np.float32), float(loss),
            {k: np.asarray(v) for k, v in _paths(grads).items()})


def _torch_side(jparams, batch, **cfg_kw):
    kw = dict(cfg_kw)
    if "dtype" in kw:
        kw["dtype"] = DTYPES[kw["dtype"]]
    cfg = dataclasses.replace(tllama.LlamaConfig.nano(), **kw)
    model = load_params(tllama.Llama(cfg), jparams, device="cpu")
    ids, labels = (torch.from_numpy(x) for x in batch)
    logits = model(ids)
    loss = tgpt.cross_entropy_loss(logits, labels)
    loss.backward()
    return (logits.detach().float().numpy(), loss.item(),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def jax_f32(jparams, batch):
    """JAX's logits, loss and grads per attention branch (remat off: it
    changes what JAX saves, not what it computes)."""
    return {flash: _jax_side(jparams, batch, dtype=jnp.float32, remat=False,
                             use_flash_attention=flash)
            for flash in (True, False)}


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("remat", [True, False])
def test_logits_loss_grads_match_jax_f32(jparams, batch, jax_f32, flash,
                                         remat):
    jl, jloss, jg = jax_f32[flash]
    tl, tloss, tg = _torch_side(jparams, batch, dtype=jnp.float32,
                                remat=remat, use_flash_attention=flash)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert abs(tloss - jloss) <= 1e-4
    assert sorted(tg) == sorted(jg) and len(tg) == 1 + 2 * 9 + 2
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)


BF16 = dict(dtype=jnp.bfloat16, use_flash_attention=True)


@pytest.fixture(scope="module")
def jax_bf16(jparams, batch):
    """JAX's bf16 logits, loss and grads on the flash branch (remat off)."""
    return _jax_side(jparams, batch, remat=False, **BF16)


@pytest.mark.parametrize("remat", [True, False])
def test_logits_loss_grads_match_jax_bf16(jparams, batch, jax_bf16, remat):
    jl, jloss, jg = jax_bf16
    tl, tloss, tg = _torch_side(jparams, batch, remat=remat, **BF16)
    np.testing.assert_allclose(tl, jl, atol=0.1)
    assert abs(tloss - jloss) <= 1e-2
    for name in jg:
        assert tg[name].dtype == np.float32  # float32 masters
        bound = 0.05 * max(np.abs(jg[name]).max(), 1e-6)
        assert np.abs(tg[name] - jg[name]).max() <= bound, name


def _bf16_ulps(a, b):
    """|a - b| in units of b's bf16 ulp (2^-7 of its power of two)."""
    a, b = (np.asarray(x, np.float32) for x in (a, b))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    return (np.abs(a - b) / ulp).max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rope_matches_jax(dtype):
    hd, seq, theta = 128, 8192, 500000.0
    jc, js = jllama.rope_freqs(hd, seq, theta)
    tc, ts = tllama.rope_freqs(hd, seq, theta)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (seq, hd // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 3, hd)).astype(np.float32)
    # positions up to 8191, not in order, as a decode step would pass
    pos = rng.integers(0, seq, (2, 16))
    pos[0, 0] = seq - 1
    for positions in (None, pos):
        want = jllama.apply_rope(jnp.asarray(x, dtype), jc, js,
                                 None if positions is None
                                 else jnp.asarray(positions))
        got = tllama.apply_rope(torch.from_numpy(x).to(DTYPES[dtype]), tc,
                                ts, None if positions is None
                                else torch.from_numpy(positions))
        assert got.dtype == DTYPES[dtype] and got.shape == x.shape
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        if dtype == jnp.float32:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(x).max()
        else:
            assert _bf16_ulps(got, want) <= 1.0
    # halves, not interleaved pairs: position 1 rotates x[0] with x[d/2]
    one = np.zeros((1, 2, 1, hd), np.float32)
    one[0, 1, 0, 0] = 1.0
    out = tllama.apply_rope(torch.from_numpy(one), tc, ts).numpy()
    assert out[0, 1, 0, hd // 2] == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[0, 1, 0, 1] == 0.0


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 8, 64)) * 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = jllama.RMSNorm(1e-5, dtype).apply(
        {"params": {"scale": scale}}, jnp.asarray(x, dtype))
    norm = tllama.RMSNorm(64, 1e-5, DTYPES[dtype])
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x).to(DTYPES[dtype]))
    assert got.dtype == DTYPES[dtype]
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("flash", [True, False])
def test_gqa_attention_with_distinct_kv_heads_matches_jax(jparams, flash):
    """One attention layer, 4 q heads over 2 kv heads whose projections
    differ: q heads 0-1 read kv head 0 and q heads 2-3 kv head 1
    (``.repeat`` would pair them 0, 1, 0, 1 and differ)."""
    p = jparams["layers_0"]["attention"]
    k = p["k_proj"]["kernel"].reshape(128, 2, 32)
    assert np.abs(k[:, 0] - k[:, 1]).max() > 0.1  # distinct kv heads
    jcfg = dataclasses.replace(jllama.LlamaConfig.nano(), dtype=jnp.float32,
                               use_flash_attention=flash)
    tcfg = dataclasses.replace(tllama.LlamaConfig.nano(),
                               dtype=torch.float32, use_flash_attention=flash)
    x = np.random.default_rng(3).standard_normal((2, T, 128)).astype(
        np.float32)
    jc, js = jllama.rope_freqs(32, 128, jcfg.rope_theta)
    want = jllama.LlamaAttention(jcfg).apply({"params": p}, jnp.asarray(x),
                                            jc, js)
    attn = load_params(tllama.LlamaAttention(tcfg, torch.device("meta")), p,
                       device="cpu")
    tc, ts = tllama.rope_freqs(32, 128, tcfg.rope_theta)
    with torch.no_grad():
        got = attn(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-4)


def test_init_layout_and_num_params(jparams):
    cfg = tllama.LlamaConfig.nano()
    params = tllama.init_params(cfg, seed=0, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in _paths(params).items()}
    assert shapes == {k: v.shape for k, v in _paths(jparams).items()}
    assert not any(k.endswith("bias") for k in shapes)
    assert all(v.dtype == torch.float32 for v in _paths(params).values())
    for name, v in _paths(params).items():
        if name.endswith("scale"):
            assert torch.all(v == 1.0)
        elif name.endswith("kernel"):  # lecun normal: std 1/sqrt(fan_in)
            assert abs(v.std().item() * v.shape[0] ** 0.5 - 1.0) < 0.1
    model = tllama.Llama(cfg).init_params(seed=0, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.num_params() == jllama.LlamaConfig.nano().num_params()
    assert n == sum(v.size for v in _paths(jparams).values())
    # Llama-3 8B cut to 4 layers, counted on the meta device
    big = dataclasses.replace(tllama.LlamaConfig.llama3_8b(), num_layers=4)
    n = sum(p.numel() for p in tllama.Llama(big).parameters())
    assert n == big.num_params() == dataclasses.replace(
        jllama.LlamaConfig.llama3_8b(), num_layers=4).num_params()
    assert n == 1_923_125_248
    for preset in ("nano", "llama3_8b", "llama3_70b"):
        t, j = (getattr(m.LlamaConfig, preset)() for m in (tllama, jllama))
        assert t.num_params() == j.num_params() and t.head_dim == j.head_dim


def _host_batch(step):
    rng = np.random.default_rng(step)
    x = rng.integers(0, 512, (4, T + 1)).astype(np.int32)
    return {"input_ids": x[:, :-1], "labels": x[:, 1:]}


def test_adamw_trajectory_matches_jax():
    jcfg = dataclasses.replace(jllama.LlamaConfig.nano(), dtype=jnp.float32,
                               remat=False)
    jres = jax_auto_accelerate(jllama.Llama(jcfg),
                               optimizer=optax.adamw(3e-4),
                               devices=jax.devices()[:1])
    params = _paths(jax.tree_util.tree_map(np.asarray, jres.state.params))
    tcfg = dataclasses.replace(tllama.LlamaConfig.nano(),
                               dtype=torch.float32, remat=False)
    res = auto_accelerate(tllama.Llama(tcfg), optimizer=adamw(3e-4),
                          device="cpu")
    with torch.no_grad():  # JAX's init, into the optimizer's parameters
        for name, p in res.model.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
    state = jres.state
    jl, jn, tl, tn = [], [], [], []
    for i in range(3):
        hb = _host_batch(i)
        state, m = jres.train_step(state, jres.place_batch(hb))
        jl.append(float(m["loss"]))
        jn.append(float(m["grad_norm"]))
        res.state, m = res.train_step(res.state, res.place_batch(hb))
        tl.append(m["loss"].item())
        tn.append(m["grad_norm"].item())
    assert int(res.state.step) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(tn, jn, rtol=1e-4)


def test_export_load_round_trip_is_bitwise(jparams):
    cfg = dataclasses.replace(tllama.LlamaConfig.nano(), dtype=torch.float32)
    model = load_params(tllama.Llama(cfg), jparams, device="cpu")
    exported = export_params(model)
    assert sorted(_paths(exported)) == sorted(_paths(jparams))
    again = load_params(tllama.Llama(cfg), exported, device="cpu")
    for (n, a), (m, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert n == m and torch.equal(a, b)
        assert torch.equal(a, torch.from_numpy(np.array(_paths(jparams)[n])))


def test_unported_config_values_raise():
    for kw in (dict(fp8=True), dict(remat=True, remat_policy="dots")):
        with pytest.raises((NotImplementedError, ValueError)):
            tllama.Llama(dataclasses.replace(tllama.LlamaConfig.nano(),
                                             **kw))
    cfg = dataclasses.replace(tllama.LlamaConfig.nano(), attn_impl="ring",
                              mesh=object())
    model = tllama.Llama(cfg).init_params(device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        model(torch.zeros((1, 8), dtype=torch.int64))
