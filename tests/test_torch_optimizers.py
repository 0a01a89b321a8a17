"""Port parity: the optimizers against the JAX package's (optax) ones.

The same numpy-seeded leaves and gradients go through the JAX transform
(``opt.update`` + ``optax.apply_updates``) and the port's optimizer
(``p.grad = g; opt.step()``), on the CPU in float32:

- AGD over 6 steps, plain, amsgrad, clip, weight decay, a schedule:
  parameters within ``AGD_RTOL`` of optax's (both compute the same
  float32 operations in the same order, one rounding each; XLA may
  reassociate or fuse, so a few ulps are allowed), and the numpy
  transcription of tests/test_optimizers_data.py:25 within its 1e-5;
- `quantize_blockwise` codes and scales bitwise JAX's, with values at
  and beside every code's rounding boundary, zero blocks, signed zeros
  and a padded tail; `dequantize_blockwise` bitwise;
- Adam8bit against ``adamw8bit`` over 10 steps: codes and scales of
  both moments bitwise, parameters within ``AGD_RTOL``;
- WSAM against ``make_wsam_train_step`` on GPT nano with ``adamw(3e-4)``
  (decoupled and coupled, adaptive and not) with dropout on the logits
  drawn from torch's generator in the port and from the same masks in
  JAX: losses and parameters within tests/test_torch_train_step.py's
  RTOL = 1e-4 (Adam's sign-like first steps, as there); and the port's
  two passes draw the same masks of GPT's own dropout;
- muP roles, mults, `mup_init` (bitwise) and the lr table against JAX on
  GPT nano and Llama nano at two widths.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import llama as jllama
from dlrover_wuqiong_tpu.optimizers import agd as jax_agd
import dlrover_wuqiong_tpu.optimizers.low_bit  # noqa: F401
import dlrover_wuqiong_tpu.optimizers.mup  # noqa: F401
from dlrover_wuqiong_tpu.optimizers.wsam import (
    make_wsam_train_step as jax_wsam_step,
)
from dlrover_wuqiong_tpu.trainer.train_step import (
    make_lm_loss as jax_lm_loss,
)
from dlrover_wuqiong_tpu_torch.convert import load_params
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.models import llama as tllama
from dlrover_wuqiong_tpu_torch.optimizers import (
    agd,
    adamw8bit,
    dequantize_blockwise,
    make_wsam_train_step,
    mup_adam,
    mup_init,
    quantize_blockwise,
    width_mults,
)
from dlrover_wuqiong_tpu_torch.optimizers import mup as tmup
from dlrover_wuqiong_tpu_torch.trainer.train_step import (
    TrainState,
    adamw,
    make_lm_loss,
)
from torch_threads import one_torch_thread  # noqa: F401

jlow = sys.modules["dlrover_wuqiong_tpu.optimizers.low_bit"]
jmup = sys.modules["dlrover_wuqiong_tpu.optimizers.mup"]

AGD_RTOL, AGD_ATOL = 2e-6, 1e-7
RTOL = 1e-4  # tests/test_torch_train_step.py's, for adamw steps
SHAPES = [(5,), (3, 300), (7, 11, 4)]


def _leaves(seed, steps):
    rng = np.random.default_rng(seed)
    w0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * (0.1 + t)
              for s in SHAPES] for t in range(steps)]
    return w0, grads


def _jax_traj(tx, w0, grads):
    params = {f"p{i}": jnp.asarray(w) for i, w in enumerate(w0)}
    state = tx.init(params)
    out = []
    for gs in grads:
        g = {f"p{i}": jnp.asarray(x) for i, x in enumerate(gs)}
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        out.append([np.asarray(params[f"p{i}"]) for i in range(len(w0))])
    return out, state


def _port_traj(factory, w0, grads):
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    opt = factory(ps)
    out = []
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        out.append([p.detach().numpy().copy() for p in ps])
    return out, opt, ps


def _sched(count):
    return 1e-2 * (1.0 - 0.1 * count)


AGD_CASES = {
    "plain": dict(learning_rate=0.1),
    "amsgrad": dict(learning_rate=0.05, amsgrad=True),
    "clip": dict(learning_rate=0.05, clip=0.5),
    "weight_decay": dict(learning_rate=0.05, weight_decay=0.3),
    "all": dict(learning_rate=0.02, amsgrad=True, clip=1.0,
                weight_decay=0.1, delta=1e-3, betas=(0.8, 0.99)),
    "schedule": dict(learning_rate=_sched),
}


@pytest.mark.parametrize("case", sorted(AGD_CASES))
def test_agd_matches_optax(case):
    kw = AGD_CASES[case]
    w0, grads = _leaves(1, 6)
    want, _ = _jax_traj(jax_agd(**kw), w0, grads)
    got, opt, _ = _port_traj(agd(**kw), w0, grads)
    for step, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=AGD_RTOL, atol=AGD_ATOL,
                                       err_msg=f"{case} step {step}")
    assert int(opt.count) == 6


def test_agd_matches_the_numpy_transcription():
    from test_optimizers_data import _agd_numpy_reference

    rng = np.random.RandomState(0)
    w0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(6)]
    for wd in (0.0, 0.5):
        got, _, _ = _port_traj(agd(learning_rate=0.1, weight_decay=wd),
                               [w0], [[g] for g in grads])
        want = _agd_numpy_reference(w0, grads, lr=0.1, wd=wd)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[0], b, atol=1e-5)


def _boundary_values():
    """Values at and one float32 ulp either side of every code's rounding
    boundary, 127 sqrt(|x| / absmax) = k + 1/2, in blocks whose absmax
    is 1; the signs alternate."""
    k = np.arange(127, dtype=np.float64)
    edge = ((k + 0.5) / 127.0) ** 2
    vals = []
    for e in edge.astype(np.float32):
        vals += [np.nextafter(e, np.float32(0)), e,
                 np.nextafter(e, np.float32(2))]
    vals = np.asarray(vals, np.float32)
    vals *= np.where(np.arange(vals.size) % 2, -1, 1).astype(np.float32)
    out = []
    for i in range(0, vals.size, 255):
        blk = np.concatenate([[np.float32(1.0)], vals[i:i + 255]])
        out.append(np.pad(blk, (0, 256 - blk.size)))
    return np.concatenate(out).astype(np.float32)


QUANT_INPUTS = {
    "boundaries": _boundary_values,
    "random": lambda: np.random.default_rng(3).standard_normal(
        (37, 29)).astype(np.float32) * 3,
    "zero_blocks": lambda: np.concatenate(
        [np.zeros(512, np.float32), np.full(256, -0.0, np.float32),
         np.random.default_rng(4).standard_normal(300).astype(
             np.float32) * 1e-30]),
    "padded_tail": lambda: np.random.default_rng(5).standard_normal(
        1000).astype(np.float32),
    "tiny": lambda: np.asarray([1e-38, -3e-39, 2.0, 0.0], np.float32),
}


@pytest.mark.parametrize("case", sorted(QUANT_INPUTS))
def test_quantize_blockwise_is_jax_bitwise(case):
    x = QUANT_INPUTS[case]()
    jq = jlow.quantize_blockwise(jnp.asarray(x))
    tq = quantize_blockwise(torch.from_numpy(x.copy()))
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert np.array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert (tq.size, tq.shape) == (jq.size, jq.shape)
    jd = np.asarray(jlow.dequantize_blockwise(jq))
    td = dequantize_blockwise(tq).numpy()
    assert np.array_equal(td.view(np.uint32), jd.view(np.uint32))


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adam8bit_matches_adamw8bit(wd):
    w0, grads = _leaves(2, 10)
    kw = dict(learning_rate=1e-2, weight_decay=wd)
    want, jstate = _jax_traj(jlow.adamw8bit(**kw), w0, grads)
    got, opt, ps = _port_traj(adamw8bit(**kw), w0, grads)
    for step, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=AGD_RTOL, atol=AGD_ATOL,
                                       err_msg=f"step {step}")
    inner = jstate[0]
    assert int(opt.count) == int(inner.count) == 10
    for i, p in enumerate(ps):
        for tq, jq in zip(opt.qtensors(p), (inner.mu[f"p{i}"],
                                            inner.nu[f"p{i}"])):
            assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
            assert np.array_equal(tq.scale.numpy(), np.asarray(jq.scale))


# ---------------------------------------------------------------- WSAM

VOCAB, SEQ, BATCH = 512, 32, 4
KEEP = 0.9  # the logits' dropout: keep probability


def _gpt_cfg(jax_side, **kw):
    if jax_side:
        return dataclasses.replace(jgpt.GPTConfig.nano(), dtype=jnp.float32,
                                   remat=False, **kw)
    return dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                               remat=False, **kw)


@pytest.fixture(scope="module")
def gpt_p0():
    model = jgpt.GPT(_gpt_cfg(True))
    return model, jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(0)))


def _host_batch(step):
    x = np.random.default_rng(step).integers(
        0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    return {"input_ids": x[:, :-1], "labels": x[:, 1:]}


def _port_loss(gen):
    """The LM loss with dropout on the logits, masks from `gen`."""
    def loss_fn(model, batch):
        logits = model(batch["input_ids"])
        keep = torch.rand(logits.shape, generator=gen) < KEEP
        logits = torch.where(keep, logits / torch.full((), KEEP),
                             torch.zeros_like(logits))
        return tgpt.cross_entropy_loss(logits, batch["labels"])
    return loss_fn


def _masks(seed, steps):
    """The masks the port's loss draws at each step: one draw a step, as
    the WSAM step restores the generator before its second pass."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.rand((BATCH, SEQ, VOCAB), generator=gen) < KEEP).numpy()
            for _ in range(steps)]


@pytest.mark.parametrize("decouple", [True, False], ids=["decoupled",
                                                         "coupled"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["plain",
                                                         "adaptive"])
def test_wsam_matches_jax(gpt_p0, decouple, adaptive):
    model, p0 = gpt_p0
    steps, lr = 3, 3e-4
    kw = dict(rho=0.05, gamma=0.9, adaptive=adaptive, decouple=decouple)
    masks = _masks(11, steps)

    def jloss(params, batch):
        logits = model.apply({"params": params}, batch["input_ids"])
        logits = jnp.where(batch["mask"], logits / KEEP, 0.0)
        return jgpt.cross_entropy_loss(logits, batch["labels"])

    jstep = jax_wsam_step(jloss, optax.adamw(lr), lr, **kw)
    carry = (jax.tree_util.tree_map(jnp.asarray, p0),
             optax.adamw(lr).init(p0))
    jl = []
    for i in range(steps):
        carry, loss = jstep(carry, dict(_host_batch(i), mask=masks[i]))
        jl.append(float(loss))

    gen = torch.Generator().manual_seed(11)
    tmodel = load_params(tgpt.GPT(_gpt_cfg(False)), p0, device="cpu")
    state = TrainState.create(tmodel, adamw(lr))
    step = make_wsam_train_step(_port_loss(gen), lr, generators=[gen], **kw)
    tl = []
    for i in range(steps):
        b = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in _host_batch(i).items()}
        state, m = step(state, b)
        tl.append(m["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    want = jax.tree_util.tree_flatten_with_path(carry[0])[0]
    got = dict(tmodel.named_parameters())
    for path, w in want:
        name = ".".join(str(k.key) for k in path)
        g = got[name].detach().numpy()
        w = np.asarray(w)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        # Adam's sign-like steps: an entry with a gradient at rounding
        # size moves a full lr either way (tests/test_torch_checkpoint.py)
        assert rel <= RTOL or np.abs(g - w).max() <= 2 * steps * lr, name


def test_wsam_passes_draw_the_same_dropout_masks():
    """GPT nano with its own dropout (rate 0.1): with rho = 0 the second
    pass runs at w itself, so the sharpness g2 - g1 is zero exactly when
    both passes drew the same masks; without the generator restored it
    is not."""
    from dlrover_wuqiong_tpu_torch.optimizers import wsam_gradients

    cfg = _gpt_cfg(False, dropout=0.1)
    model = tgpt.GPT(cfg).init_params(0, "cpu")
    gen = torch.Generator().manual_seed(5)

    def loss_fn(m, batch):
        return tgpt.cross_entropy_loss(
            m(batch["input_ids"], deterministic=False, generator=gen),
            batch["labels"])

    b = {k: torch.from_numpy(v.astype(np.int64))
         for k, v in _host_batch(0).items()}
    w0 = [p.detach().clone() for p in model.parameters()]
    _, g1, sharp = wsam_gradients(loss_fn, model, b, rho=0.0,
                                  generators=[gen])
    assert all(torch.equal(s, torch.zeros_like(s)) for s in sharp)
    assert all(torch.equal(p, w) for p, w in zip(model.parameters(), w0))
    _, _, sharp = wsam_gradients(loss_fn, model, b, rho=0.0, generators=[])
    assert any(s.abs().max() > 0 for s in sharp)



def test_wsam_refuses_a_mesh_state():
    """On a mesh the perturbation's norm and the loss would be each
    rank's own: the step raises before it touches the state."""
    model = tgpt.GPT(_gpt_cfg(False)).init_params(0, "cpu")
    state = TrainState.create(model, adamw(3e-4))
    state.mesh_state = object()
    w0 = [p.detach().clone() for p in model.parameters()]
    step = make_wsam_train_step(_port_loss(torch.Generator()), 3e-4)
    b = {k: torch.from_numpy(v.astype(np.int64))
         for k, v in _host_batch(0).items()}
    with pytest.raises(NotImplementedError, match="WSAM over a mesh"):
        step(state, b)
    assert all(torch.equal(p, w) for p, w in zip(model.parameters(), w0))


# ---------------------------------------------------------------- muP

FAMILY = {
    "gpt": (lambda w: dataclasses.replace(_gpt_cfg(True), n_embd=w),
            lambda w: dataclasses.replace(_gpt_cfg(False), n_embd=w),
            jgpt.GPT, tgpt.GPT),
    "llama": (lambda w: dataclasses.replace(
        jllama.LlamaConfig.nano(), dtype=jnp.float32, remat=False,
        hidden_size=w, intermediate_size=2 * w),
        lambda w: dataclasses.replace(
            tllama.LlamaConfig.nano(), dtype=torch.float32, remat=False,
            hidden_size=w, intermediate_size=2 * w),
        jllama.Llama, tllama.Llama),
}


def _jax_mults(fam, base_w, w, real=False):
    """JAX's mults of width `w` against `base_w` (from abstract shapes,
    which is all width_mults reads) and, with `real`, the initialized
    parameters of width `w`."""
    jc, _, jm, _ = FAMILY[fam]
    rng = jax.random.PRNGKey(0)
    base = jax.eval_shape(jm(jc(base_w)).init_params, rng)
    params = (jm(jc(w)).init_params(rng) if real
              else jax.eval_shape(jm(jc(w)).init_params, rng))
    mults = jmup.width_mults(base, params)
    flat = jax.tree_util.tree_flatten_with_path(
        mults, is_leaf=lambda x: isinstance(x, dict) and "mult" in x)[0]
    return params, mults, {jmup._path_of(p): m for p, m in flat}


@pytest.mark.parametrize("fam", sorted(FAMILY))
@pytest.mark.parametrize("widths", [(64, 128), (128, 256)],
                         ids=["64-128", "128-256"])
def test_mup_mults_roles_and_lr_table_match_jax(fam, widths):
    _, tc, _, tm = FAMILY[fam]
    _, _, want = _jax_mults(fam, *widths)
    got = width_mults(tm(tc(widths[0])), tm(tc(widths[1])))
    assert dict(got) == want
    assert {r["role"] for r in got.values()} >= {"input", "hidden",
                                                 "finite"}
    table = tmup.lr_table(got, adam=True)
    assert table == {k: jmup._lr_factor(m["role"], m["mult"], True)
                     for k, m in want.items()}
    assert tmup.lr_table(got, adam=False) == {
        k: jmup._lr_factor(m["role"], m["mult"], False)
        for k, m in want.items()}
    for path, (b, s) in [("h/ln/scale", ((8,), (32,))),
                         ("wte/embedding", ((32, 8), (32, 32))),
                         ("lm_head/kernel", ((8, 32), (32, 32))),
                         ("mlp/kernel", ((8, 8), (32, 32)))]:
        assert tmup.classify_param(path, b, s) == jmup.classify_param(
            path, b, s)


@pytest.mark.parametrize("fam", sorted(FAMILY))
def test_mup_init_is_jax_bitwise(fam):
    _, tc, _, tm = FAMILY[fam]
    params, jm, tmults = _jax_mults(fam, 64, 128, real=True)
    want = jmup.mup_init(params, jm)
    model = load_params(tm(tc(128)), jax.tree_util.tree_map(
        np.asarray, params), device="cpu")
    mup_init(model, width_mults(tm(tc(64)), model))
    flat = {jmup._path_of(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    scaled = 0
    for name, p in model.named_parameters():
        w = flat[name.replace(".", "/")]
        assert np.array_equal(p.detach().numpy(), w), name
        scaled += tmults[name.replace(".", "/")]["role"] == "hidden"
    assert scaled > 0


def test_mup_adam_trajectory_matches_jax(gpt_p0):
    """3 steps of mup_adam at n_embd 128 against a base of 64, weight
    decay on: losses and parameters as tests/test_torch_train_step.py
    holds adamw (RTOL)."""
    jc, tc, jmod, tmod = FAMILY["gpt"]
    rng = jax.random.PRNGKey(0)
    base = jax.eval_shape(jmod(jc(64)).init_params, rng)
    model, p0 = gpt_p0
    tx = jmup.mup_adam(1e-3, jmup.width_mults(base, p0), weight_decay=0.1)
    grad = jax.value_and_grad(jax_lm_loss(model.apply))

    @jax.jit
    def jstep(params, st, b):
        loss, g = grad(params, b)
        u, st = tx.update(g, st, params)
        return optax.apply_updates(params, u), st, loss

    params = jax.tree_util.tree_map(jnp.asarray, p0)
    st = tx.init(params)
    jl = []
    for i in range(3):
        params, st, loss = jstep(params, st, _host_batch(i))
        jl.append(float(loss))
    tm = load_params(tmod(tc(128)), p0, device="cpu")
    opt = mup_adam(1e-3, width_mults(tmod(tc(64)), tm), weight_decay=0.1)
    state = TrainState.create(tm, opt)
    from dlrover_wuqiong_tpu_torch.trainer.train_step import make_train_step

    step = make_train_step(make_lm_loss())
    tl = []
    for i in range(3):
        b = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in _host_batch(i).items()}
        state, m = step(state, b)
        tl.append(m["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    lrs = sorted({g["lr"] for g in state.opt_state.param_groups})
    assert lrs == [5e-4, 1e-3]
