"""Port parity: the GPT training module and its loss against the JAX model.

Both sides run `GPTConfig.nano()` on the same weights (the JAX model's
init, loaded into the port's `GPT` by path with `load_params`) and the
same tokens from numpy.  Compared: logits, `cross_entropy_loss` with some
labels at -1 (ignored), and the gradient of every parameter, with the
port's remat on and off and with both attention branches (flash and
einsum).

Tolerances:
- float32: logits and loss within 1e-4, gradients within 1e-4 absolute
  plus 1e-3 relative.  The two sides sum in different orders (matmul
  blocking, LayerNorm and softmax reductions), and the flash branch runs
  the port's plain attention against JAX's CPU reference.
- bfloat16 compute (float32 masters, as training runs): logits within
  0.1 (absolute; logits here are O(1), a bf16 ulp at 1 is 2^-7 and the
  rounding points differ: the port rounds each dense product then adds
  the bias in bf16, as flax does, but sums of bf16 products round in
  another order), loss within 1e-2, gradients within 5% of each leaf's
  largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu_torch.convert import (
    export_params,
    load_params,
    params_from_jax,
)
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.serving import (
    LocalServer,
    ServeSpec,
    ServingEngine,
)
from torch_threads import one_torch_thread  # noqa: F401

B, T = 2, 32


@pytest.fixture(scope="module")
def jparams():
    cfg = dataclasses.replace(jgpt.GPTConfig.nano(), dtype=jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jgpt.GPT(cfg).init_params)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (B, T + 1))
    labels = ids[:, 1:].copy()
    labels[0, :5] = -1
    labels[1, -3:] = -1
    return ids[:, :-1], labels


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _jax_side(jparams, batch, **cfg_kw):
    cfg = dataclasses.replace(jgpt.GPTConfig.nano(), **cfg_kw)
    model = jgpt.GPT(cfg)
    ids, labels = (jnp.asarray(x) for x in batch)

    def loss_fn(p):
        logits = model.apply({"params": p}, ids)
        return jgpt.cross_entropy_loss(logits, labels), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    return (np.asarray(logits, np.float32), float(loss),
            {k: np.asarray(v) for k, v in _paths(grads).items()})


def _torch_side(jparams, batch, **cfg_kw):
    torch_kw = dict(cfg_kw)
    if "dtype" in torch_kw:
        torch_kw["dtype"] = {jnp.float32: torch.float32,
                             jnp.bfloat16: torch.bfloat16}[torch_kw["dtype"]]
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), **torch_kw)
    model = load_params(tgpt.GPT(cfg), jparams, device="cpu")
    ids, labels = (torch.from_numpy(x) for x in batch)
    logits = model(ids)
    loss = tgpt.cross_entropy_loss(logits, labels)
    loss.backward()
    return (logits.detach().float().numpy(), loss.item(),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def jax_f32(jparams, batch):
    """JAX's logits, loss and grads per attention branch.  Remat changes
    what JAX saves, not what it computes, so the reference runs with remat
    off and both port variants are held against it."""
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
    assert sorted(tg) == sorted(jg) and len(tg) == 2 + 12 * 2 + 2
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], atol=1e-4, rtol=1e-3,
                                   err_msg=name)


def test_logits_loss_grads_match_jax_bf16(jparams, batch):
    kw = dict(dtype=jnp.bfloat16, remat=False, use_flash_attention=True)
    jl, jloss, jg = _jax_side(jparams, batch, **kw)
    tl, tloss, tg = _torch_side(jparams, batch, **kw)
    np.testing.assert_allclose(tl, jl, atol=0.1)
    assert abs(tloss - jloss) <= 1e-2
    for name in jg:
        assert tg[name].dtype == np.float32  # float32 masters
        bound = 0.05 * max(np.abs(jg[name]).max(), 1e-6)
        assert np.abs(tg[name] - jg[name]).max() <= bound, name


def test_loss_ignores_labels_and_matches_plain_form():
    """The chunked loss equals the plain log-softmax form; ignored rows
    get a zero gradient."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 7)).astype(
        np.float32)).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, 7, (2, 5)))
    labels[1, 2] = -1
    tgpt._CE_CHUNK_BYTES = 4 * 7 * 3  # 3 rows per chunk: a ragged last
    try:
        loss = tgpt.cross_entropy_loss(logits, labels)
        loss.backward()
    finally:
        tgpt._CE_CHUNK_BYTES = 1 << 28
    valid = labels != -1
    ref = torch.nn.functional.cross_entropy(
        logits.detach()[valid], labels[valid])
    assert abs(loss.item() - ref.item()) <= 1e-6
    assert torch.all(logits.grad[1, 2] == 0)


def test_unported_config_values_raise():
    """Every model knob of the JAX config is ported; an unknown remat
    policy still raises at build."""
    with pytest.raises(ValueError, match="unknown remat policy"):
        tgpt.GPT(dataclasses.replace(tgpt.GPTConfig.nano(), remat=True,
                                     remat_policy="dotz"))


@pytest.mark.parametrize("knob", [
    dict(dropout=0.1), dict(moe_experts=4), dict(fp8=True),
    dict(remat=True, remat_policy="dots"),
    dict(remat=True, remat_policy="offload_dots"),
    dict(remat=True, remat_policy="save_names"),
    dict(remat=True, remat_policy="offload_names",
         remat_names=("mlp_out",))], ids=lambda kw: "-".join(
             f"{k}={v}" for k, v in kw.items()))
def test_model_knobs_build_and_run(knob):
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), **knob)
    model = tgpt.GPT(cfg).init_params(device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 16)))
    logits = model(ids)
    assert logits.shape == (2, 16, 512) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    assert bool(model.intermediates) == bool(cfg.moe_experts)


def test_export_round_trip_serves_the_same_tokens(jparams):
    """load_params -> export_params -> sync_from_trainer leaves greedy
    serving unchanged."""
    cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32)
    spec = ServeSpec(max_slots=2, max_len=32, max_prompt_len=8,
                     fused_tokens=4)
    engine = ServingEngine(cfg, params_from_jax(jparams, device="cpu"),
                           spec, device="cpu")
    reqs = [dict(request_id=f"r{i}", prompt=[1 + i, 7, 13][: 1 + i],
                 max_new_tokens=8, seed=i, temperature=0.0)
            for i in range(3)]

    def serve():
        server = LocalServer(engine)
        for r in reqs:
            server.submit(**r)
        return server.drain()

    before = serve()
    model = load_params(tgpt.GPT(cfg), jparams, device="cpu")
    exported = export_params(model)
    assert sorted(_paths(exported)) == sorted(_paths(jparams))
    engine.sync_from_trainer(exported)
    assert serve() == before
    # the export is a copy: training the model further leaves it alone
    with torch.no_grad():
        model.ln_f.bias.add_(1.0)
    assert torch.all(exported["ln_f"]["bias"] == 0)
