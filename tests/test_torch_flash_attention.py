"""Port parity: flash attention's plain versions and public API vs JAX.

The port's plain forward and backward (what a CPU tensor takes, and what
the CUDA kernels are held against on the card) against the Pallas
kernels run in interpret mode, as tests/test_parallel_training.py runs
them: float32, bh = 2, d = 64 and 128, blocks of 64 (the split backward)
and blocks equal to the sequences (the fused backward), inputs from numpy
with a fixed seed.
Then the public API (`flash_attention`, `flash_attention_with_lse`,
`mha`) against JAX's, gradients included, and the backward route rule.

Tolerances are the JAX tests' own: atol 2e-5 forward (o and lse), 5e-4
backward.  Both sides compute in float32 and sum in different orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.ops import flash_attention as jfa
from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
BWD_TOL = 5e-4


def _inputs(seed, bh, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    g = rng.standard_normal((bh, sq, d)).astype(np.float32)
    return q, k, v, g


def _t(*xs):
    return [torch.from_numpy(x.copy()) for x in xs]


def _close(a, b, atol):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _check_forward(to, tl, jo, jl, causal, sq, sk):
    _close(to, jo, FWD_TOL)
    jl = np.asarray(jl)[:, 0, :]
    tl = tl.numpy()
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    fin = np.isfinite(jl)
    _close(tl[fin], jl[fin], FWD_TOL)
    if causal and sq > sk:  # the first sq - sk rows see no key
        empty = sq - sk
        assert np.all(to.numpy()[:, :empty] == 0.0)
        assert np.all(np.isneginf(tl[:, :empty]))
        assert np.all(np.isfinite(tl[:, empty:]))


def _forward_backward(causal, sq, sk, d, block_q, block_k, seed):
    """Plain forward and backward against the Pallas pair (interpret
    mode) at blocks (block_q, block_k)."""
    q, k, v, g = _inputs(seed, 2, sq, sk, d)
    scale = 1.0 / np.sqrt(d)
    fwd = jax.jit(functools.partial(
        jfa._fa_forward_pallas, causal=causal, sm_scale=scale,
        block_q=block_q, block_k=block_k, interpret=True))
    bwd = jax.jit(functools.partial(
        jfa._fa_backward_pallas, causal=causal, sm_scale=scale,
        block_q=block_q, block_k=block_k, interpret=True))
    jo, jl = fwd(q, k, v)
    jd = bwd(q, k, v, jo, jl, g)
    tq, tk, tv, tg = _t(q, k, v, g)
    to, tl = tfa._fa_forward_plain(tq, tk, tv, causal, scale)
    _check_forward(to, tl, jo, jl, causal, sq, sk)
    td = tfa._fa_backward_plain(tq, tk, tv, to, tl, tg, causal, scale)
    for a, b in zip(td, jd):
        _close(a, b, BWD_TOL)


# every forward case runs at blocks of 64 and at single blocks, and each
# head dim (64, 128) meets every case in one of the two groups.  Then the
# card's 128-row q tiles (two warpgroups of 64 rows): at 256 x 192 (off =
# -64) the first q tile's first 64 rows see no key while its second 64 do;
# 192 x 192 at d = 128 leaves the second tile's upper 64 rows past sq.  The
# last is chip_smoke's "llama_d128" case at Llama-3's head dim, sq != sk:
# two of the card dk/dv kernel's 128-row kv tiles, which four and two of
# its 64-row q tiles see.
@pytest.mark.parametrize("causal,sq,sk,d", [(True, 128, 128, 64),
                                            (False, 128, 128, 128),
                                            (True, 64, 256, 64),
                                            (True, 128, 64, 128),
                                            (True, 256, 192, 64),
                                            (True, 192, 192, 128),
                                            (True, 384, 256, 128)])
def test_multi_block_forward_and_split_backward(causal, sq, sk, d):
    """Blocks of 64: the online-softmax forward over several kv blocks,
    and the split dq and dk/dv kernels."""
    _forward_backward(causal, sq, sk, d, 64, 64, seed=2)


@pytest.mark.parametrize("causal,sq,sk,d", [(True, 128, 128, 128),
                                            (False, 128, 128, 64),
                                            (True, 64, 128, 128),
                                            (True, 128, 64, 64)])
def test_single_block_forward_and_fused_backward(causal, sq, sk, d):
    """Blocks equal to the sequences (the shapes of the JAX package's own
    fused-backward test): the single-step forward, with empty rows when
    sq > sk, and the fused dq+dk+dv kernel."""
    _forward_backward(causal, sq, sk, d, sq, sk, seed=3)


def test_with_lse_gradients_match_jax():
    """A nonzero lse cotangent folds into delta on both sides."""
    rng = np.random.default_rng(4)
    shape = (1, 2, 64, 32)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    gl = rng.standard_normal(shape[:3]).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, True)
        return (o * g).sum() + (lse * gl).sum()

    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, True)
    tval = (o * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(gl)).sum()
    tval.backward()
    assert abs(tval.item() - float(jval)) <= 1e-3
    for t, j in zip((tq, tk, tv), jgrads):
        _close(t.grad, j, BWD_TOL)


def test_odd_head_dim_public_api_matches_jax():
    """d = 48 through `mha` (flax layout), forward and grads."""
    rng = np.random.default_rng(5)
    shape = (2, 64, 2, 48)  # (b, s, h, d)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))

    def jloss(q, k, v):
        return (jfa.mha(q, k, v, causal=True) * g).sum()

    jo = jax.jit(jfa.mha)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    to = tfa.mha(tq, tk, tv, causal=True)
    _close(to.detach(), jo, FWD_TOL)
    (to * torch.from_numpy(g)).sum().backward()
    for t, j in zip((tq, tk, tv), jgrads):
        _close(t.grad, j, BWD_TOL)


@pytest.mark.parametrize("seq,blocks,route", [
    (128, {}, "fused"),                      # default 1024 blocks, T < 1024
    (1024, {}, "fused"),                     # GPT-2's T with its blocks
    (2048, {}, "split"),                     # two 1024 blocks
    (128, {"block_q": 64, "block_k": 64}, "split"),
    (128, {"bwd_block_q": 32}, "split"),     # backward blocks decide
])
def test_backward_route_rule(seq, blocks, route, monkeypatch):
    assert tfa.backward_route(
        seq, seq, blocks.get("bwd_block_q") or blocks.get("block_q", 1024),
        blocks.get("block_k", 1024)) == route
    # the wrapper's backward hands that route to the kernels' dispatch
    taken = []
    backward = tfa._fa_backward

    def spy(*args):
        taken.append(args[-1])
        return backward(*args)

    monkeypatch.setattr(tfa, "_fa_backward", spy)
    tfa.reset_launches()
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 1, seq, 8)).astype(
        np.float32)).requires_grad_()
    tfa.flash_attention(x, x, x, True, None, **blocks).sum().backward()
    assert taken == [route]
    # a CPU tensor takes the plain versions: no kernel launched
    assert sum(tfa.LAUNCHES.values()) == 0


def test_cuda_wrapper_raises_on_what_the_kernels_do_not_take():
    x = torch.zeros((1, 64, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa._fa_forward_kernel(x, x, x, True, 0.125)
    # the kernels compute in bf16: a float32 operand is refused, not
    # rounded (the model's attention layer casts, models/attention.py)
    x32 = torch.zeros((1, 64, 64))
    with pytest.raises(ValueError, match="take bfloat16"):
        tfa._fa_forward_kernel(x32, x32, x32, True, 0.125)
    with pytest.raises(ValueError, match="take bfloat16"):
        tfa._kernel_operands("backward", x32.bfloat16(), x32.bfloat16(),
                             x32.bfloat16(), x32)
    with pytest.raises(ValueError, match="head dims up to 128"):
        tfa._kernel_head_dim(256, torch.device("cuda"))
    assert tfa._kernel_head_dim(48, torch.device("cuda")) == 64
    assert tfa._kernel_head_dim(96, torch.device("cuda")) == 128
    assert tfa._kernel_head_dim(48, torch.device("cpu")) == 48


# ------------------------------------------------- the streamed scan
#
# The port's streamed scans (`_fa_forward_streamed` over key blocks,
# `_fa_backward_streamed` over query blocks) against JAX's
# `_streamed_with_lse` and `_streamed_bwd`, called directly on the same
# float32 inputs with blocks of 64 (several blocks a sequence), at the
# file's tolerances.  JAX computes in natural-log units from an unrounded
# q; the port in log2 units from q pre-scaled and rounded to its dtype
# (float32 here), as its kernels do.

STREAMED = [(True, 256, 256), (False, 256, 256), (True, 128, 256),
            (True, 256, 128), (False, 128, 256)]


@pytest.mark.parametrize("causal,sq,sk", STREAMED)
@pytest.mark.parametrize("with_glse", [False, True])
def test_streamed_scan_matches_jax(causal, sq, sk, with_glse):
    d, block = 32, 64
    q, k, v, g = _inputs(11, 2, sq, sk, d)
    glse = (np.random.default_rng(12).standard_normal((2, sq))
            .astype(np.float32) if with_glse else None)
    scale = 1.0 / np.sqrt(d)
    q4, k4, v4, g4 = (x[None] for x in (q, k, v, g))
    jo, jl = jax.jit(functools.partial(
        jfa._streamed_with_lse, causal=causal, scale=scale,
        block_k=block))(q4, k4, v4)
    jd = jax.jit(functools.partial(
        jfa._streamed_bwd, causal=causal, scale=scale, block_q=block))(
        q4, k4, v4, jo, jl, g4,
        glse=None if glse is None else glse[None])
    tq, tk, tv, tg = _t(q, k, v, g)
    to, tl = tfa._fa_forward_streamed(tq, tk, tv, causal, scale,
                                      block_k=block)
    _check_forward(to, tl, np.asarray(jo)[0], np.asarray(jl)[0][:, None],
                   causal, sq, sk)
    td = tfa._fa_backward_streamed(
        tq, tk, tv, to, tl, tg, causal, scale,
        None if glse is None else torch.from_numpy(glse), block_q=block)
    for t, j in zip(td, jd):
        _close(t, np.asarray(j)[0], BWD_TOL)
    # and the port's dense plain versions on the same inputs
    po, pl = tfa._fa_forward_plain(tq, tk, tv, causal, scale)
    _close(to, po, FWD_TOL)
    pd = tfa._fa_backward_plain(
        tq, tk, tv, to, tl, tg, causal, scale,
        None if glse is None else torch.from_numpy(glse))
    for t, p in zip(td, pd):
        _close(t, p, BWD_TOL)


def test_public_api_takes_the_streamed_scan_at_the_threshold(monkeypatch):
    """b·h = 1, S = 2048, d = 16: the CPU path reaches 2048² scores and
    takes the streamed scans, forward and backward (the lse cotangent
    folded in), against JAX's `flash_attention_with_lse`, which takes its
    own streamed scan there."""
    assert tfa.use_streamed(2048, 2048) and not tfa.use_streamed(2047, 2048)
    taken = []
    for name in ("_fa_forward_streamed", "_fa_backward_streamed"):
        fn = getattr(tfa, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            taken.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tfa, name, spy)
    rng = np.random.default_rng(13)
    q, k, v, g = (rng.standard_normal((1, 1, 2048, 16)).astype(np.float32)
                  for _ in range(4))
    gl = rng.standard_normal((1, 1, 2048)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, True)
        return (o * g).sum() + (lse * gl).sum(), (o, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to, tl = tfa.flash_attention_with_lse(*ts, causal=True)
    ((to * torch.from_numpy(g)).sum()
     + (tl * torch.from_numpy(gl)).sum()).backward()
    assert taken == ["_fa_forward_streamed", "_fa_backward_streamed"]
    _close(to.detach(), jo, FWD_TOL)
    _close(tl.detach(), jl, FWD_TOL)
    for t, j in zip(ts, jg):
        _close(t.grad, j, BWD_TOL)
