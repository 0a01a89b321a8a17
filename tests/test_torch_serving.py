"""Port parity: the continuous-batching serving engine and scheduler.

Against JAX (same converted `GPTConfig.nano()` weights, float32 on both
sides): greedy requests give the same tokens, one for one, with
``quant=""``, ``"int8"`` and ``"fp8"``, and the scheduler's ledger counts
the same.  Sampled tokens cannot match (JAX's threefry bits are not
reproducible in torch), so the port's own invariants are pinned instead,
as tests/test_serving.py pins JAX's: a request's tokens are a pure
function of (weights, prompt, seed) under slot churn, staggered
admission and another batch geometry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_wuqiong_tpu.common import messages as jmsg
from dlrover_wuqiong_tpu.models.gpt import GPT as JaxGPT
from dlrover_wuqiong_tpu.models.gpt import GPTConfig as JaxGPTConfig
from dlrover_wuqiong_tpu.serving import ServeSpec as JaxServeSpec
from dlrover_wuqiong_tpu.serving import ServingEngine as JaxServingEngine
from dlrover_wuqiong_tpu.serving.scheduler import (
    SlotScheduler as JaxSlotScheduler,
)
from dlrover_wuqiong_tpu.serving.scheduler import (
    request_trace_id as jax_trace_id,
)
from dlrover_wuqiong_tpu.telemetry import serving as jtel
from dlrover_wuqiong_tpu_torch.common import messages as tmsg
from dlrover_wuqiong_tpu_torch.convert import params_from_jax
from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig, init_params
from dlrover_wuqiong_tpu_torch.ops import quantization as tq
from dlrover_wuqiong_tpu_torch.serving import (
    LocalServer,
    ServeSpec,
    ServingEngine,
    SlotScheduler,
    request_trace_id,
)
from dlrover_wuqiong_tpu_torch.telemetry import serving as ttel
from dlrover_wuqiong_tpu_torch.telemetry import spans as tspans

SPEC = dict(max_slots=2, max_len=48, max_prompt_len=8, fused_tokens=4)

# (request_id, prompt, max_new_tokens, temperature, seed) — mixed
# temperatures INCLUDING greedy (temp=0), mixed lengths, distinct seeds
REQS = [
    ("a", [1, 7, 13], 12, 1.0, 5),
    ("b", [2, 9], 9, 0.0, 0),
    ("c", [3, 4, 5, 6], 11, 1.0, 6),
    ("d", [8], 12, 0.7, 7),
]
GREEDY = [
    ("g0", [1, 7, 13], 10, 0.0, 5),
    ("g1", [2, 9], 9, 0.0, 0),
    ("g2", [3, 4, 5, 6, 10, 11, 12, 500], 11, 0.0, 6),
    ("g3", [8], 7, 0.0, 7),
]


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


@pytest.fixture(scope="module")
def engine(cfgs, tparams):
    return ServingEngine(cfgs[1], tparams, ServeSpec(**SPEC), device="cpu")


def _submit(server, spec):
    rid, prompt, n, temp, seed = spec
    server.submit(rid, prompt, max_new_tokens=n, seed=seed,
                  temperature=temp)


def _drain_scheduler(sch):
    out = {}
    while not sch.idle():
        sch.step()
        for r in sch.take_results():
            out[r.request_id] = list(r.tokens)
    return out


def _alone(eng, spec):
    s = LocalServer(eng)
    _submit(s, spec)
    return s.drain()[spec[0]]


# ------------------------------------------------------- parity with JAX


@pytest.mark.parametrize("quant", ["", "int8", "fp8"])
def test_greedy_tokens_match_jax(cfgs, jparams, tparams, quant):
    """Greedy decoding on the same weights gives JAX's tokens, request for
    request, with slots churning (4 requests on 2 slots); the two
    schedulers' ledgers count the same."""
    jcfg, tcfg = cfgs
    jeng = JaxServingEngine(jcfg, jparams, JaxServeSpec(**SPEC, quant=quant))
    teng = ServingEngine(tcfg, tparams, ServeSpec(**SPEC, quant=quant),
                         device="cpu")
    jsch = JaxSlotScheduler(jeng, ledger=jtel.ServeLedger())
    tsch = SlotScheduler(teng, ledger=ttel.ServeLedger())
    for rid, prompt, n, temp, seed in GREEDY:
        jsch.submit(jmsg.ServeRequest(request_id=rid, prompt=prompt,
                                      max_new_tokens=n, seed=seed,
                                      temperature=temp))
        tsch.submit(tmsg.ServeRequest(request_id=rid, prompt=prompt,
                                      max_new_tokens=n, seed=seed,
                                      temperature=temp))
    want = _drain_scheduler(jsch)
    got = _drain_scheduler(tsch)
    assert got == want
    for rid, _, n, _, _ in GREEDY:
        assert len(got[rid]) == n
    assert tsch.ledger.snapshot()["counters"] == \
        jsch.ledger.snapshot()["counters"]


def test_int8_store_matches_jax(cfgs, jparams, tparams):
    """The int8 store holds JAX's q and scales for every quantized leaf,
    and leaves the same 1-D leaves exact."""
    from dlrover_wuqiong_tpu.serving.engine import _quantize_tree as jqt
    from dlrover_wuqiong_tpu_torch.serving.engine import _quantize_tree

    jstore, jmeta = jqt(jparams, "int8")
    tstore, tmeta = _quantize_tree(tparams, "int8", torch.device("cpu"))
    n_quantized = 0

    def rec(js, jm, ts, tm):
        nonlocal n_quantized
        for k, m in jm.items():
            if isinstance(m, dict):
                rec(js[k], m, ts[k], tm[k])
            elif m is None:
                assert tm[k] is None
                np.testing.assert_array_equal(ts[k].numpy(),
                                              np.asarray(js[k]))
            else:
                n_quantized += 1
                assert tm[k] == m
                np.testing.assert_array_equal(ts[k]["q"].numpy(),
                                              np.asarray(js[k]["q"]))
                np.testing.assert_array_equal(ts[k]["s"].numpy(),
                                              np.asarray(js[k]["s"]))

    rec(jstore, jmeta, tstore, tmeta)
    # wte, wpe and four matrices per layer
    assert n_quantized == 2 + 4 * cfgs[1].n_layer


def _int8_leaves(store, meta, out=None):
    """[(store leaf, (mode, size, shape))] of every int8 leaf, in order."""
    out = [] if out is None else out
    for k, m in meta.items():
        if isinstance(m, dict):
            _int8_leaves(store[k], m, out)
        elif m is not None and m[0] == "int8":
            out.append((store[k], m))
    return out


def test_int8_store_is_one_flat_store(cfgs, tparams):
    """Every int8 leaf's q and s are views of one (R, 256) q and one (R, 1)
    scale, at consecutive row offsets, whole rows a leaf."""
    from dlrover_wuqiong_tpu_torch.serving.engine import (
        _INT8_FLAT,
        _quantize_tree,
    )

    store, meta = _quantize_tree(tparams, "int8", torch.device("cpu"))
    q, s = store[_INT8_FLAT]
    leaves = _int8_leaves(store, meta)
    assert len(leaves) == 2 + 4 * cfgs[1].n_layer
    row = 0
    for leaf, (_, size, _) in leaves:
        rows = -(-size // 256)
        assert leaf["q"].untyped_storage().data_ptr() == \
            q.untyped_storage().data_ptr()
        assert leaf["s"].untyped_storage().data_ptr() == \
            s.untyped_storage().data_ptr()
        assert leaf["q"].storage_offset() == row * 256
        assert leaf["s"].storage_offset() == row
        assert leaf["q"].shape == (rows, 256) and leaf["s"].shape == (rows, 1)
        row += rows
    assert q.shape == (row, 256) and s.shape == (row, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_materialize_views_one_buffer(cfgs, tparams, dtype):
    """On the CPU `_materialize` dequantizes the flat store once: every
    int8 leaf is a view of one buffer, equal bitwise to dequantizing that
    leaf alone."""
    from dlrover_wuqiong_tpu_torch.serving.engine import (
        _materialize,
        _quantize_tree,
    )

    store, meta = _quantize_tree(tparams, "int8", torch.device("cpu"))
    params = _materialize(store, meta, dtype)
    got = _int8_leaves(params, meta)
    want = _int8_leaves(store, meta)
    base = got[0][0].untyped_storage().data_ptr()
    for (out, _), (leaf, (_, size, shape)) in zip(got, want):
        assert out.untyped_storage().data_ptr() == base
        assert out.shape == shape and out.dtype == dtype
        ref = tq._dequantize_plain(leaf["q"], leaf["s"], size, shape, dtype)
        assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           ref.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32))


def test_int8_store_mixed_leaf_dtypes(cfgs, tparams):
    """bf16 and f32 matrices in one tree are quantized together in f32,
    which holds each bf16 value exactly: the same q and s as each leaf's
    own quantization."""
    from dlrover_wuqiong_tpu_torch.serving.engine import _quantize_tree

    mixed = {"a": tparams["wte"]["embedding"].to(torch.bfloat16),
             "b": tparams["wpe"]["embedding"]}
    store, meta = _quantize_tree(mixed, "int8", torch.device("cpu"))
    for k in ("a", "b"):
        q, s = tq.quantize_int8_blockwise(mixed[k])
        assert torch.equal(store[k]["q"], q) and torch.equal(store[k]["s"], s)


def test_schemas_match_jax():
    assert ttel.SERVE_STATES == jtel.SERVE_STATES
    assert ttel.SERVE_COUNTERS == jtel.SERVE_COUNTERS
    assert ttel.SERVE_SCHEMA_VERSION == jtel.SERVE_SCHEMA_VERSION
    for cls in ("ServeRequest", "ServeResult"):
        jf = {(f.name, repr(f.default)) for f in
              dataclasses.fields(getattr(jmsg, cls))}
        tf = {(f.name, repr(f.default)) for f in
              dataclasses.fields(getattr(tmsg, cls))}
        assert tf == jf, cls
    assert set(jtel.ServeLedger().snapshot()) == \
        set(ttel.ServeLedger().snapshot())
    for rid in ("req-00", "req-01", "x"):
        assert request_trace_id(rid) == jax_trace_id(rid)


# ---------------------------------------------------- spec validation


class TestServeSpecValidation:
    def test_bad_quant_mode(self, cfgs, tparams):
        with pytest.raises(ValueError, match="quant mode"):
            ServingEngine(cfgs[1], tparams, ServeSpec(quant="int4"),
                          device="cpu")

    def test_max_len_exceeds_block_size(self, cfgs, tparams):
        with pytest.raises(ValueError, match="block_size"):
            ServingEngine(cfgs[1], tparams, ServeSpec(
                max_len=cfgs[1].block_size + 1), device="cpu")

    def test_bad_max_prompt_len(self, cfgs, tparams):
        with pytest.raises(ValueError, match="max_prompt_len"):
            ServingEngine(cfgs[1], tparams, ServeSpec(
                max_len=32, max_prompt_len=64), device="cpu")
        with pytest.raises(ValueError, match="max_prompt_len"):
            ServingEngine(cfgs[1], tparams, ServeSpec(max_prompt_len=0),
                          device="cpu")

    def test_bad_slots_and_fusion(self, cfgs, tparams):
        with pytest.raises(ValueError, match="max_slots"):
            ServingEngine(cfgs[1], tparams, ServeSpec(max_slots=0),
                          device="cpu")
        with pytest.raises(ValueError, match="fused_tokens"):
            ServingEngine(cfgs[1], tparams, ServeSpec(fused_tokens=0),
                          device="cpu")

    def test_admit_prompt_too_long(self, engine):
        with pytest.raises(ValueError, match="prompt length"):
            engine.admit(0, list(range(1, 10)), seed=0)  # 9 > 8

    def test_admit_budget_exceeds_max_len(self, engine):
        with pytest.raises(ValueError, match="max_len"):
            engine.admit(0, [1, 2, 3], seed=0, max_new_tokens=46)

    def test_admit_occupied_slot(self, engine):
        engine.admit(0, [1, 2], seed=0)
        try:
            with pytest.raises(ValueError, match="occupied"):
                engine.admit(0, [3, 4], seed=1)
        finally:
            engine.retire(0)


# ----------------------------------------- continuous-batching equivalence


class TestContinuousBatchingEquivalence:
    def test_busy_batch_matches_alone(self, engine):
        busy = LocalServer(engine)
        for spec in REQS:
            _submit(busy, spec)
        packed = busy.drain()
        assert set(packed) == {r[0] for r in REQS}
        for spec in REQS:
            assert len(packed[spec[0]]) == spec[2]
            assert packed[spec[0]] == _alone(engine, spec), spec[0]

    def test_staggered_admission_matches_alone(self, engine):
        s = LocalServer(engine)
        _submit(s, REQS[0])
        _submit(s, REQS[1])
        s.scheduler.step()  # a window decodes before the late arrivals
        _submit(s, REQS[2])
        _submit(s, REQS[3])
        out = _drain_scheduler(s.scheduler)
        for spec in REQS:
            assert out[spec[0]] == _alone(engine, spec), spec[0]

    def test_cross_geometry_identical(self, cfgs, tparams, engine):
        other = ServingEngine(cfgs[1], tparams, ServeSpec(
            max_slots=3, max_len=48, max_prompt_len=8, fused_tokens=2),
            device="cpu")
        a = LocalServer(engine)
        b = LocalServer(other)
        for spec in REQS:
            _submit(a, spec)
            _submit(b, spec)
        assert a.drain() == b.drain()

    def test_greedy_ignores_seed(self, engine):
        rid, prompt, n, _, _ = REQS[1]
        t1 = _alone(engine, (rid, prompt, n, 0.0, 0))
        t2 = _alone(engine, (rid, prompt, n, 0.0, 12345))
        assert t1 == t2


class TestSeededDeterminism:
    def test_same_seed_same_tokens(self, engine):
        spec = ("det", [5, 6, 7], 10, 1.0, 42)
        assert _alone(engine, spec) == _alone(engine, spec)

    def test_different_seed_differs(self, engine):
        a = _alone(engine, ("s0", [5, 6, 7], 12, 1.0, 0))
        b = _alone(engine, ("s1", [5, 6, 7], 12, 1.0, 1))
        assert a != b

    def test_top_k_one_is_greedy(self, cfgs, tparams, engine):
        """top_k masks before temperature scaling: with k = 1 a hot
        request decodes its greedy tokens."""
        eng = ServingEngine(cfgs[1], tparams, ServeSpec(**SPEC, top_k=1),
                            device="cpu")
        hot = _alone(eng, ("k", [5, 6, 7], 9, 1.5, 3))
        assert hot == _alone(engine, ("k", [5, 6, 7], 9, 0.0, 3))


# ------------------------------------------------------------ sampling


class TestSampling:
    def test_noise_is_a_pure_function_of_key_and_position(self):
        from dlrover_wuqiong_tpu_torch.serving.engine import _gumbel_noise

        keys = torch.tensor([3, 3, 9, 12345])
        pos = torch.tensor([5, 6, 5, 5])
        g = _gumbel_noise(keys, pos, 64)
        for i in range(4):  # a row's noise ignores the rest of the batch
            assert torch.equal(g[i], _gumbel_noise(keys[i:i + 1],
                                                   pos[i:i + 1], 64)[0])
        assert not torch.equal(g[0], g[1])  # another position
        assert not torch.equal(g[0], g[2])  # another request

    @pytest.mark.parametrize("temp", [1.0, 0.5])
    def test_sampled_frequencies_follow_softmax(self, temp):
        """Gumbel-max over the hash noise draws from softmax(logits / T):
        20,000 independent requests (distinct keys), frequencies within
        0.015 (about 5 standard errors at p = 0.5)."""
        from dlrover_wuqiong_tpu_torch.serving.engine import (
            _request_key,
            _sample_rows,
        )

        n = 20_000
        logits = torch.tensor([2.0, 1.0, 0.0, -1.0]).repeat(n, 1)
        keys = torch.tensor([_request_key(i) for i in range(n)])
        tok = _sample_rows(logits, keys, torch.full((n,), 7),
                           torch.full((n,), temp), top_k=0)
        freq = torch.bincount(tok, minlength=4).float() / n
        want = torch.softmax(logits[0] / temp, -1)
        assert (freq - want).abs().max() < 0.015


# ------------------------------------------------ dispatches and weights


class TestDispatchAndSync:
    def test_one_dispatch_per_admit_and_window(self, cfgs, tparams):
        eng = ServingEngine(cfgs[1], tparams, ServeSpec(**SPEC, quant="int8"),
                            device="cpu")
        tq.reset_launches()
        s = LocalServer(eng)
        _submit(s, ("w", [1, 2], 9, 0.0, 0))  # 1 admit + 2 windows of 4
        s.drain()
        assert eng.dispatches == 3
        # the CPU runs the plain versions: no kernel launch is counted
        assert tq.LAUNCHES["dequantize_int8_blockwise"] == 0

    def test_int8_decodes_and_syncs(self, cfgs, tparams):
        eng = ServingEngine(cfgs[1], tparams, ServeSpec(
            max_slots=1, max_len=16, max_prompt_len=4, fused_tokens=2,
            quant="int8"), device="cpu")
        spec = ("q", [1, 2], 6, 1.0, 3)
        first = _alone(eng, spec)
        assert len(first) == 6
        fresh = init_params(cfgs[1], seed=1, device="cpu")
        eng.sync_from_trainer(fresh)
        after = _alone(eng, spec)
        assert len(after) == 6
        assert after != first           # the new weights are served
        assert _alone(eng, spec) == after

    def test_sync_rejects_different_tree(self, cfgs, tparams):
        eng = ServingEngine(cfgs[1], tparams, ServeSpec(
            max_slots=1, max_len=16, max_prompt_len=4, fused_tokens=2),
            device="cpu")
        with pytest.raises(ValueError, match="tree structure"):
            eng.sync_from_trainer({"bogus": torch.ones((2, 2))})

    def test_finish_spans_share_request_trace(self, engine):
        tspans.clear_spans()
        _alone(engine, ("t", [1, 2], 3, 0.0, 0))
        names = [(s["name"], s["trace_id"]) for s in tspans.spans_snapshot()]
        assert names == [("serve:admit", request_trace_id("t")),
                         ("serve:finish", request_trace_id("t"))]
