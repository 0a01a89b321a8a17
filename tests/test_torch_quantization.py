"""Port parity: the blockwise int8 pair and fp8 scaling against JAX.

The port's plain int8 versions (what a CPU tensor runs, and what the
CUDA kernels are held against on the card) must equal the JAX package's
bit for bit: its jnp path, and the Pallas `_quant_kernel` /
`_dequant_kernel` run in interpret mode with the BlockSpecs of
dlrover_wuqiong_tpu/ops/quantization.py:97-105,120-127.

Tolerance against the jnp path: none.  q is compared exactly and scales
and dequantized values bitwise: both sides divide in IEEE float32, round
half to even, and multiply once in float32.  Against the Pallas kernels
in interpret mode, scales may sit one ulp apart (interpret mode divides
by 127 as a reciprocal multiply); see `test_int8_matches_pallas_interpret`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dlrover_wuqiong_tpu.ops import quantization as jq
from dlrover_wuqiong_tpu_torch.ops import quantization as tq
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 256


def _ties(rng):
    """Blocks whose x / scale land exactly on .5: absmax 127 (scale 1.0)
    and absmax 63.5 (scale 0.5)."""
    a = rng.integers(-126, 127, BLOCK).astype(np.float32) + 0.5
    a[0] = 127.0
    b = (rng.integers(-126, 127, BLOCK).astype(np.float32) + 0.5) * 0.5
    b[0] = 63.5
    return np.concatenate([a, b])


def _zero_block(rng):
    x = rng.standard_normal(3 * BLOCK).astype(np.float32)
    x[BLOCK:2 * BLOCK] = 0.0
    return x.reshape(3, BLOCK)


CASES = {
    "ties": _ties,
    "zero_block": _zero_block,
    "ragged": lambda rng: rng.standard_normal(1000).astype(np.float32) * 3,
    "rows_not_div8": lambda rng: rng.standard_normal((5, 200)).astype(
        np.float32),
    "rows_div8": lambda rng: rng.standard_normal((16, 256)).astype(
        np.float32) * 0.02,
    "nano_c_fc": lambda rng: rng.standard_normal((128, 512)).astype(
        np.float32) * 0.09,
}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(case, dtype):
    x = CASES[case](np.random.default_rng(7))
    tdt, jdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    # the same values on both sides: bf16 rounding done once, by torch
    xj = jnp.asarray(xt.float().numpy()).astype(jdt)
    return xt, xj


def _pallas_quant(tiled):
    rows = tiled.shape[0]
    return pl.pallas_call(
        jq._quant_kernel,
        grid=(rows // 8,),
        in_specs=[pl.BlockSpec((8, BLOCK), lambda i: (i, 0))],
        out_specs=(pl.BlockSpec((8, BLOCK), lambda i: (i, 0)),
                   pl.BlockSpec((8, 1), lambda i: (i, 0))),
        out_shape=(jax.ShapeDtypeStruct((rows, BLOCK), jnp.int8),
                   jax.ShapeDtypeStruct((rows, 1), jnp.float32)),
        interpret=True,
    )(tiled)


def _pallas_dequant(q, s):
    rows = q.shape[0]
    return pl.pallas_call(
        jq._dequant_kernel,
        grid=(rows // 8,),
        in_specs=[pl.BlockSpec((8, BLOCK), lambda i: (i, 0)),
                  pl.BlockSpec((8, 1), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, BLOCK), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, BLOCK), jnp.float32),
        interpret=True,
    )(q, s)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
class TestInt8AgainstJax:
    def test_quantize_matches_jnp(self, case, dtype):
        xt, xj = _inputs(case, dtype)
        q, s = tq.quantize_int8_blockwise(xt)
        qj, sj = jq.quantize_int8_blockwise(xj)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert tuple(q.shape) == qj.shape and tuple(s.shape) == sj.shape
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(sj))

    def test_dequantize_matches_jnp(self, case, dtype):
        xt, xj = _inputs(case, dtype)
        qj, sj = jq.quantize_int8_blockwise(xj)
        q = torch.from_numpy(np.array(qj))
        s = torch.from_numpy(np.array(sj))
        shape = tuple(xt.shape)
        for out_t, out_j in DTYPES.values():
            got = tq.dequantize_int8_blockwise(q, s, xt.numel(), shape,
                                               dtype=out_t)
            want = jq.dequantize_int8_blockwise(qj, sj, xt.numel(), shape,
                                                dtype=out_j)
            assert got.dtype == out_t and tuple(got.shape) == shape
            np.testing.assert_array_equal(
                _bits(got.float().numpy()),
                _bits(np.asarray(want.astype(jnp.float32))))



PALLAS_CASES = {
    "ties": lambda rng: np.tile(_ties(rng), 4),           # 8 rows
    "zero_block": lambda rng: np.tile(_zero_block(rng), (3, 1)),  # 9 -> 8
    "rows_div8": CASES["rows_div8"],
    "nano_c_fc": CASES["nano_c_fc"],
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_int8_matches_pallas_interpret(case, dtype):
    """The Pallas kernels take rows % 8 == 0 only (quantization.py:95),
    so these cases have 8k rows; the others are held against the jnp path
    above."""
    x = PALLAS_CASES[case](np.random.default_rng(11))
    x = x.reshape(-1)[:(x.size // (8 * BLOCK)) * 8 * BLOCK]
    tdt, jdt = DTYPES[dtype]
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(xt.float().numpy()).astype(jdt)
    q, s = tq.quantize_int8_blockwise(xt)
    qp, sp = _pallas_quant(xj.reshape(-1, BLOCK))
    # interpret mode computes absmax / 127 as absmax * (1 / 127), which
    # can land one ulp from the IEEE quotient that the jnp path and the
    # port compute (ROADMAP queue 3).  Rows whose scales agree must agree
    # exactly; a row one ulp off may move a value sitting on a rounding
    # tie by one step.
    same = _bits(s.numpy())[:, 0] == _bits(sp)[:, 0]
    ulps = np.abs(_bits(s.numpy()).astype(np.int64)
                  - _bits(sp).astype(np.int64))
    assert ulps.max() <= 1
    np.testing.assert_array_equal(q.numpy()[same], np.asarray(qp)[same])
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(qp, np.int32))
    assert dq.max() <= 1
    # dequantize from the same (q, scale): bitwise
    xp = _pallas_dequant(qp, sp)
    back = tq.dequantize_int8_blockwise(
        torch.from_numpy(np.array(qp)), torch.from_numpy(np.array(sp)),
        xp.size, tuple(xp.shape))
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(xp))


class TestInt8Semantics:
    def test_ties_round_half_to_even(self):
        x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
        q, s = tq.quantize_int8_blockwise(x)
        assert float(s[0, 0]) == 1.0
        assert q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
        assert q[0, 8:].abs().sum() == 0  # zero padding

    def test_all_zero_block_scale_one(self):
        q, s = tq.quantize_int8_blockwise(torch.zeros(2, BLOCK))
        assert s.flatten().tolist() == [1.0, 1.0]
        assert q.abs().sum() == 0

    def test_cpu_takes_plain_path_without_launch(self):
        tq.reset_launches()
        q, s = tq.quantize_int8_blockwise(torch.ones(300))
        tq.dequantize_int8_blockwise(q, s, 300, (300,))
        assert tq.LAUNCHES == {"quantize_int8_blockwise": 0,
                               "dequantize_int8_blockwise": 0}

    def test_non_cpu_non_cuda_tensor_raises(self):
        """A tensor that is not on the CPU goes to the kernel or raises;
        it never falls back to the plain version."""
        x = torch.empty(512, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            tq.quantize_int8_blockwise(x)
        q = torch.empty((2, BLOCK), dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            tq.dequantize_int8_blockwise(q, torch.empty((2, 1)), 512, (512,))


# ------------------------------------------------------------ grouped


def _offset1(x: torch.Tensor) -> torch.Tensor:
    """x's values in a tensor that starts one element into its storage
    (not 16-byte aligned)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _leaves(rng, dtype):
    """Small leaves of one dtype: two matrices, a ragged leaf, an all-zero
    block, a single value and a leaf at storage offset 1."""
    tdt = DTYPES[dtype][0]
    xs = [rng.standard_normal((12, 64)).astype(np.float32) * 0.05,
          rng.standard_normal((3, 256)).astype(np.float32),
          rng.standard_normal(1000).astype(np.float32) * 3,
          _zero_block(rng),
          np.array([2.5], np.float32),
          rng.standard_normal((5, 200)).astype(np.float32)]
    out = [torch.from_numpy(x).to(tdt) for x in xs]
    out[-1] = _offset1(out[-1])
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
class TestGroupedInt8:
    def test_grouped_plain_matches_jnp_per_leaf(self, dtype):
        """Each leaf's rows of the flat store are JAX's quantization of
        that leaf alone, bitwise."""
        xs = _leaves(np.random.default_rng(5), dtype)
        assert xs[-1].storage_offset() == 1 and xs[-1].data_ptr() % 16
        q, s, first = tq.quantize_int8_blockwise_grouped(xs)
        rows = [-(-x.numel() // BLOCK) for x in xs]
        assert first == list(np.cumsum([0] + rows[:-1]))
        assert q.shape == (sum(rows), BLOCK) and s.shape == (sum(rows), 1)
        jdt = DTYPES[dtype][1]
        for x, r0, r in zip(xs, first, rows):
            qj, sj = jq.quantize_int8_blockwise(
                jnp.asarray(x.float().numpy()).astype(jdt))
            np.testing.assert_array_equal(q[r0:r0 + r].numpy(),
                                          np.asarray(qj))
            np.testing.assert_array_equal(_bits(s[r0:r0 + r].numpy()),
                                          _bits(sj))
        # the all-zero block: scale 1, q 0
        z = first[3] + 1
        assert float(s[z, 0]) == 1.0 and not q[z].any()

    def test_flat_dequantize_views_match_per_leaf(self, dtype):
        """One dequantize over all rows, cut into per-leaf views, equals
        `_dequantize_plain` of each leaf's rows, bitwise, in both output
        dtypes."""
        xs = _leaves(np.random.default_rng(6), dtype)
        q, s, first = tq.quantize_int8_blockwise_grouped(xs)
        for out_t in (torch.float32, torch.bfloat16):
            flat = tq.dequantize_int8_blockwise(q, s, q.numel(),
                                                (q.numel(),), dtype=out_t)
            for x, r0, r1 in zip(xs, first, first[1:] + [q.shape[0]]):
                got = flat[r0 * BLOCK:r0 * BLOCK + x.numel()].view(x.shape)
                want = tq._dequantize_plain(q[r0:r1], s[r0:r1], x.numel(),
                                            tuple(x.shape), out_t)
                assert got.dtype == out_t
                np.testing.assert_array_equal(
                    _bits(got.float().numpy()), _bits(want.float().numpy()))

    def test_no_launch_on_cpu(self, dtype):
        tq.reset_launches()
        tq.quantize_int8_blockwise_grouped(
            _leaves(np.random.default_rng(7), dtype))
        assert tq.LAUNCHES["quantize_int8_blockwise"] == 0


class TestGroupedInt8Errors:
    def test_mixed_dtypes_raise(self):
        with pytest.raises(ValueError, match="one dtype"):
            tq.quantize_int8_blockwise_grouped(
                [torch.ones(300), torch.ones(300, dtype=torch.bfloat16)])

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError, match="one device"):
            tq.quantize_int8_blockwise_grouped(
                [torch.ones(300), torch.empty(300, device="meta")])

    def test_empty_raises(self):
        with pytest.raises(ValueError, match="no tensors"):
            tq.quantize_int8_blockwise_grouped([])

    def test_non_cpu_non_cuda_raises(self):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tq.quantize_int8_blockwise_grouped(
                [torch.empty(512, device="meta")])


class TestAlign16:
    def test_misaligned_gets_an_aligned_copy(self):
        from dlrover_wuqiong_tpu_torch.ops.flash_attention import align16

        x = _offset1(torch.arange(40, dtype=torch.float32).reshape(5, 8))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        y = align16(x)
        assert y.data_ptr() % 16 == 0 and y.is_contiguous()
        assert y.data_ptr() != x.data_ptr() and torch.equal(x, y)

    def test_aligned_is_returned_as_is(self):
        from dlrover_wuqiong_tpu_torch.ops.flash_attention import align16

        x = torch.arange(64, dtype=torch.bfloat16).reshape(4, 16)
        assert x.data_ptr() % 16 == 0
        assert align16(x) is x
        # a view at an offset of 16 bytes is aligned too
        v = x[1:]
        assert v.data_ptr() % 16 == 0 and align16(v) is v


class TestFp8AgainstJax:
    @pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
    def test_quantize_dequantize_bitwise(self, fmt):
        tdt = {"e4m3": tq.E4M3, "e5m2": tq.E5M2}[fmt]
        jdt = {"e4m3": jq.E4M3, "e5m2": jq.E5M2}[fmt]
        x = np.random.default_rng(3).standard_normal((64, 48)).astype(
            np.float32) * 5
        q, s = tq.fp8_quantize(torch.from_numpy(x), tdt)
        qj, sj = jq.fp8_quantize(jnp.asarray(x), jdt)
        assert q.dtype == tdt
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(sj))
        np.testing.assert_array_equal(
            q.view(torch.uint8).numpy(),
            np.asarray(qj).view(np.uint8))
        back = tq.fp8_dequantize(q, s)
        np.testing.assert_array_equal(
            _bits(back.numpy()), _bits(jq.fp8_dequantize(qj, sj)))
