"""Port parity: the cached GPT decode step, init layout and `generate`.

Both sides run `GPTConfig.nano()` in float32 on the same weights: the JAX
model's init, converted with `params_from_jax`.  Inputs come from numpy
with a fixed seed.

Tolerance: logits and caches within atol = rtol = 1e-4.  The two sides
sum in different orders (matmul blocking, the softmax and LayerNorm
reductions), and flax's LayerNorm takes the fast variance E[x^2] - E[x]^2,
which the port repeats but whose rounding depends on that order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.models.gpt import GPT as JaxGPT
from dlrover_wuqiong_tpu.models.gpt import GPTConfig as JaxGPTConfig
from dlrover_wuqiong_tpu.rl import generation as jgen
from dlrover_wuqiong_tpu_torch.convert import params_from_jax
from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig, init_params
from dlrover_wuqiong_tpu_torch.rl import generation as tgen

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def cfgs():
    return (dataclasses.replace(JaxGPTConfig.nano(), dtype=jnp.float32),
            dataclasses.replace(GPTConfig.nano(), dtype=torch.float32))


@pytest.fixture(scope="module")
def jparams(cfgs):
    return JaxGPT(cfgs[0]).init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def _random_caches(cfg, B, L, seed):
    rng = np.random.default_rng(seed)
    shape = (B, L, cfg.n_head, cfg.head_dim)
    return [(rng.standard_normal(shape).astype(np.float32),
             rng.standard_normal(shape).astype(np.float32))
            for _ in range(cfg.n_layer)]


def _both_caches(np_caches):
    jc = [(jnp.asarray(k), jnp.asarray(v)) for k, v in np_caches]
    tc = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
          for k, v in np_caches]
    return jc, tc


def _close_caches(jc, tc):
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk, jk)
        _close(tv, jv)


class TestConfigAndInit:
    def test_config_presets_match(self):
        for name in ("nano", "gpt2", "gpt2_medium", "gpt2_large",
                     "gpt2_xl"):
            j, t = getattr(JaxGPTConfig, name)(), getattr(GPTConfig, name)()
            for f in ("vocab_size", "n_layer", "n_head", "n_embd",
                      "block_size"):
                assert getattr(j, f) == getattr(t, f), (name, f)
            assert j.head_dim == t.head_dim
            assert j.num_params() == t.num_params()
        assert GPTConfig.gpt2().dtype == torch.bfloat16

    def test_init_layout_matches_flax(self, cfgs, jparams):
        tp = _paths(init_params(cfgs[1], seed=0, device="cpu"))
        jp = _paths(jparams)
        assert set(tp) == set(jp)
        for path, leaf in jp.items():
            assert tuple(tp[path].shape) == leaf.shape, path
            assert tp[path].dtype == torch.float32, path
        n = sum(v.numel() for v in tp.values())
        assert n == cfgs[1].num_params()

    def test_init_distribution_matches_flax(self, cfgs, jparams):
        """Same initializers: per-leaf std within 15% (a few thousand
        samples per leaf), ones/zeros exact."""
        tp = _paths(init_params(cfgs[1], seed=3, device="cpu"))
        for path, leaf in _paths(jparams).items():
            want = np.asarray(leaf)
            got = tp[path].numpy()
            if path.endswith(("scale", "bias")):
                np.testing.assert_array_equal(got, want)
            else:
                assert got.std() == pytest.approx(want.std(), rel=0.15), path
                assert np.abs(got).max() <= 4.5 * want.std() or \
                    path.endswith("embedding"), path  # truncated at 2 std

    def test_init_seeded(self, cfgs):
        a = init_params(cfgs[1], seed=1, device="cpu")
        b = init_params(cfgs[1], seed=1, device="cpu")
        c = init_params(cfgs[1], seed=2, device="cpu")
        assert torch.equal(a["wte"]["embedding"], b["wte"]["embedding"])
        assert not torch.equal(a["wte"]["embedding"], c["wte"]["embedding"])

    def test_params_from_jax_keeps_layout(self, jparams, tparams):
        jp, tp = _paths(jparams), _paths(tparams)
        assert set(jp) == set(tp)
        # Dense kernels stay (in, out); values bitwise
        k = "h_0/attn/c_attn/kernel"
        assert tuple(tp[k].shape) == jp[k].shape == (128, 384)
        for path in jp:
            np.testing.assert_array_equal(tp[path].numpy(),
                                          np.asarray(jp[path]))


class TestForwardStep:
    def test_scalar_pos_prefill_and_decode(self, cfgs, jparams, tparams):
        jcfg, tcfg = cfgs
        B, L = 2, 12
        jc, tc = _both_caches(_random_caches(tcfg, B, L, seed=1))
        toks = np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, 6))
        for pos in range(6):
            tok = toks[:, pos:pos + 1]
            jl, jc = jgen.forward_step(jcfg, jparams, jnp.asarray(tok), jc,
                                       pos)
            tl, tc = tgen.forward_step(tcfg, tparams, torch.from_numpy(tok),
                                       tc, pos)
            assert tuple(tl.shape) == (B, tcfg.vocab_size)
            _close(tl, jl)
            _close_caches(jc, tc)

    def test_vector_pos(self, cfgs, jparams, tparams):
        """Per-row positions, rows far apart, over stale (random) caches:
        the write lands at each row's pos and attention stops there."""
        jcfg, tcfg = cfgs
        B, L = 3, 16
        jc, tc = _both_caches(_random_caches(tcfg, B, L, seed=3))
        rng = np.random.default_rng(4)
        pos = np.array([0, 5, 11])
        for _ in range(3):
            tok = rng.integers(0, tcfg.vocab_size, (B, 1))
            jl, jc = jgen.forward_step(jcfg, jparams, jnp.asarray(tok), jc,
                                       jnp.asarray(pos, jnp.int32))
            tl, tc = tgen.forward_step(tcfg, tparams, torch.from_numpy(tok),
                                       tc, torch.from_numpy(pos))
            _close(tl, jl)
            _close_caches(jc, tc)
            pos = pos + np.array([1, 2, 1])

    def test_multi_token_prefill_equals_token_steps(self, cfgs, jparams,
                                                    tparams):
        """One port call over a whole prompt (T = P) equals JAX's P
        one-token steps: the last logits, and the caches."""
        jcfg, tcfg = cfgs
        B, L, P = 2, 10, 7
        jc, tc = _both_caches(_random_caches(tcfg, B, L, seed=5))
        prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size,
                                                   (B, P))
        for i in range(P):
            jl, jc = jgen.forward_step(jcfg, jparams,
                                       jnp.asarray(prompt[:, i:i + 1]), jc, i)
        tl, tc = tgen.forward_step(tcfg, tparams, torch.from_numpy(prompt),
                                   tc, 0)
        _close(tl, jl)
        _close_caches(jc, tc)

    def test_vector_pos_needs_one_token(self, cfgs, tparams):
        tc = tgen.init_caches(cfgs[1], 2, 8, device="cpu")
        with pytest.raises(ValueError, match="one token per row"):
            tgen.forward_step(cfgs[1], tparams, torch.zeros((2, 2),
                                                            dtype=torch.long),
                              tc, torch.tensor([0, 1]))

    def test_init_caches_layout(self, cfgs):
        jc = jgen.init_caches(cfgs[0], 3, 9)
        tc = tgen.init_caches(cfgs[1], 3, 9, device="cpu")
        assert len(tc) == len(jc)
        for (jk, _), (tk, tv) in zip(jc, tc):
            assert tuple(tk.shape) == jk.shape == tuple(tv.shape)
            assert not tk.any()


class TestSampling:
    def test_greedy_sample_token_matches_jax(self):
        logits = np.random.default_rng(8).standard_normal((4, 64)).astype(
            np.float32)
        for top_k in (0, 5):
            jt, jl = jgen.sample_token(jnp.asarray(logits),
                                       jax.random.PRNGKey(0), 0.0, top_k)
            tt, tl = tgen.sample_token(torch.from_numpy(logits), None, 0.0,
                                       top_k)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            _close(tl, jl)

    def test_sampled_tokens_stay_in_top_k(self):
        logits = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (64, 32)).astype(np.float32))
        gen = torch.Generator().manual_seed(0)
        tok, logp = tgen.sample_token(logits, gen, 1.0, top_k=3)
        top3 = torch.topk(logits, 3, dim=-1).indices
        assert (top3 == tok[:, None]).any(-1).all()
        assert torch.isfinite(logp).all()


class TestGenerate:
    def test_greedy_matches_jax(self, cfgs, jparams, tparams):
        jcfg, tcfg = cfgs
        prompt = np.random.default_rng(10).integers(0, tcfg.vocab_size,
                                                    (2, 5))
        jsample = jgen.SampleConfig(max_new_tokens=8, temperature=0.0)
        tsample = tgen.SampleConfig(max_new_tokens=8, temperature=0.0)
        jt, jl = jgen.generate(jcfg, jparams, jnp.asarray(prompt),
                               jax.random.PRNGKey(0), jsample)
        tt, tl = tgen.generate(tcfg, tparams, torch.from_numpy(prompt),
                               None, tsample)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        _close(tl, jl)

    def test_seeded_generate_deterministic(self, cfgs, tparams):
        tcfg = cfgs[1]
        prompt = torch.tensor([[1, 7, 13]])
        sample = tgen.SampleConfig(max_new_tokens=8, temperature=1.0)

        def run(seed):
            gen = torch.Generator().manual_seed(seed)
            return tgen.generate(tcfg, tparams, prompt, gen, sample)

        (t1, l1), (t2, l2), (t3, _) = run(9), run(9), run(10)
        assert torch.equal(t1, t2) and torch.equal(l1, l2)
        assert not torch.equal(t1, t3)

    def test_prompt_too_long(self, cfgs, tparams):
        prompt = torch.zeros((1, 100), dtype=torch.long)
        with pytest.raises(ValueError, match="block size"):
            tgen.generate(cfgs[1], tparams, prompt, None,
                          tgen.SampleConfig(max_new_tokens=64))
