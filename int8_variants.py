#!/usr/bin/env python3
"""A/B of the int8 kernels' design on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 int8_variants.py

Builds the committed ``dlrover_wuqiong_tpu_torch/csrc/int8_blockwise.cu``
and variants of it made by text substitution, one nvcc each, all started
together, into the git-ignored ``dlrover_wuqiong_tpu_torch/_build/``:

- ``loads1`` / ``loads2`` / ``loads4``: the committed dequantize (no
  persistent loop; a chunk is 16 bytes of output, one store; each thread
  loads ``kDequantLoads`` chunks of q before its first store) with 1, 2 or
  4 chunks a thread; the one the source sets is marked "committed";
- ``persistent``: the same chunks walked by a persistent grid (the SM
  count times the blocks an SM keeps resident) in a grid-stride loop,
  2 chunks in flight a thread;
- ``persistent_two_stores``: the persistent loop over chunks of 16
  values, each stored as two 16-byte halves 32 bytes apart;
- ``earlier_kernel``: the earlier dequantize, one chunk of 16 values a
  thread (two 16-byte stores 32 bytes apart) and a grid over all chunks,
  as one flat launch;
- ``bulk``: q moved by ``cp.async.bulk`` into a ring of 4 shared-memory
  stages of 16 rows (4 KB) a block, completed on an ``mbarrier``, then
  converted and stored as the committed kernel stores, in a persistent
  loop;
- ``plain_stores``: the committed kernel with plain stores in place of
  ``st.global.cs``;
- ``quant_persistent``: the committed grouped quantize (a grid of one
  warp a row) with a persistent grid of warps walking the rows.

Each dequantize variant dequantizes the flat int8 store of GPT-2 124M's
50 weight matrices (seeded random weights, quantized by the committed
grouped kernel) to bf16 in one launch and is held bitwise against the
plain version (`_dequantize_plain`); the two quantize builds quantize the
50 float32 matrices in one grouped launch and are held bitwise against
`_quantize_grouped_plain`.  All are timed by CUDA events in the order
A B C ... C B A, beside their bounds (bytes over 3.35 TB/s) and, for the
dequantize, PyTorch's int8 -> bf16 cast (``copy_``) of the same q into a
buffer of the same size (the same traffic but for the scales).  Prints
each variant's registers (``-Xptxas -v``), then the card's ``nvidia-smi``
line and one JSON object of the times.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "dlrover_wuqiong_tpu_torch", "csrc",
                   "int8_blockwise.cu")
LOADS = re.compile(r"constexpr int kDequantLoads = (\d+);")
LAUNCH_DEQUANT = "template <typename T>\nint launch_dequant("
NAMESPACE_END = "}  // namespace"
LAUNCH_QUANT = "template <typename T>\nint launch_quant("
QUANT_GRID = ("  const unsigned grid = static_cast<unsigned>(need);  "
              "// a warp a row\n")

# blocks of `kernel` one SM keeps resident, times the device's SMs: the
# grid of a persistent kernel
RESIDENT = r'''template <typename K>
long long resident_blocks(K kernel, int threads, size_t smem, int* rc) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  *rc = static_cast<int>(e);
  return static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

'''
# the quantize's warps walking the rows on a persistent grid
QUANT_PERSISTENT = r'''  int rc = 0;
  static const long long resident = resident_blocks(
      quant_kernel<T>, kQuantThreads, 3 * sizeof(long long) * kMaxLeaves,
      &rc);
  if (rc) return rc;
  const unsigned grid =
      static_cast<unsigned>(need < resident ? need : resident);
'''

# a persistent grid-stride loop over the committed kernel's chunks
PERSISTENT = r'''template <typename T, int LOADS>
__global__ void __launch_bounds__(kDequantThreads)
dequant_persistent(const int8_t* __restrict__ q,
                   const float* __restrict__ scale, long long size,
                   T* __restrict__ out) {
  using Q = typename Chunk<T>::Q;
  constexpr int kN = sizeof(Q);
  const long long chunks = (size + kN - 1) / kN;
  const long long stride = static_cast<long long>(gridDim.x) * kDequantThreads;
  const bool vec = aligned16(out);
  const Q* qc = reinterpret_cast<const Q*>(q);
  for (long long c0 =
           static_cast<long long>(blockIdx.x) * kDequantThreads + threadIdx.x;
       c0 < chunks; c0 += stride * LOADS) {
    Q raw[LOADS];
    float s[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const long long c = c0 + u * stride;
      if (c < chunks) {
        raw[u] = qc[c];
        s[u] = __ldg(scale + c * kN / kBlock);
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const long long c = c0 + u * stride;
      if (c < chunks) {
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw[u]);
        const long long i = c * kN;
        if (vec && i + kN <= size) {
          store_chunk(out + i, b, s[u]);
        } else {
          for (int j = 0; j < kN && i + j < size; ++j)
            put(out + i + j, static_cast<float>(b[j]) * s[u]);
        }
      }
    }
  }
}

template <typename T>
int launch_dequant(const void* q, const void* scale, long long size,
                   void* out, void* stream) {
  int rc = 0;
  static const long long resident = resident_blocks(
      dequant_persistent<T, 2>, kDequantThreads, 0, &rc);
  if (rc) return rc;
  const long long chunks = (size + 15) / 16;
  const long long need = (chunks + kDequantThreads - 1) / kDequantThreads;
  dequant_persistent<T, 2><<<
      static_cast<unsigned>(need < resident ? need : resident),
      kDequantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), size,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''

# chunks of 16 values: two (bf16) or four (f32) 16-byte stores, 32 or 64
# bytes apart; PERSIST selects the grid-stride loop over a resident grid,
# else one chunk a thread and a grid over all chunks (the earlier kernel)
STORE16 = r'''__device__ __forceinline__ void store16(float* out, long long i,
                                        long long size, bool vec,
                                        const float f[16]) {
  if (vec && i + 16 <= size) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      __stcs(reinterpret_cast<float4*>(out + i) + j,
             make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]));
  } else {
    for (int j = 0; j < 16 && i + j < size; ++j) out[i + j] = f[j];
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, long long i,
                                        long long size, bool vec,
                                        const float f[16]) {
  if (vec && i + 16 <= size) {
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<uint32_t*>(&h);
    }
    int4* o = reinterpret_cast<int4*>(out + i);
    __stcs(o, make_int4(w[0], w[1], w[2], w[3]));
    __stcs(o + 1, make_int4(w[4], w[5], w[6], w[7]));
  } else {
    for (int j = 0; j < 16 && i + j < size; ++j)
      out[i + j] = __float2bfloat16_rn(f[j]);
  }
}
'''
TWO_STORES = STORE16 + r'''
template <typename T, int LOADS>
__global__ void __launch_bounds__(kDequantThreads)
dequant_two_stores(const int8_t* __restrict__ q,
                   const float* __restrict__ scale, long long size,
                   T* __restrict__ out) {
  const long long chunks = (size + 15) / 16;
  const long long stride = PERSIST
      ? static_cast<long long>(gridDim.x) * kDequantThreads : chunks;
  const bool vec = aligned16(out);
  const int4* q16 = reinterpret_cast<const int4*>(q);
  for (long long c0 =
           static_cast<long long>(blockIdx.x) * kDequantThreads + threadIdx.x;
       c0 < chunks; c0 += stride * LOADS) {
    int4 raw[LOADS];
    float s[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const long long c = c0 + u * stride;
      if (c < chunks) {
        raw[u] = __ldcs(q16 + c);
        s[u] = __ldg(scale + c / 16);
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const long long c = c0 + u * stride;
      if (c < chunks) {
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw[u]);
        float f[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) f[j] = static_cast<float>(b[j]) * s[u];
        store16(out, c * 16, size, vec, f);
      }
    }
  }
}

template <typename T>
int launch_dequant(const void* q, const void* scale, long long size,
                   void* out, void* stream) {
  constexpr int kLoads = PERSIST ? 2 : 1;
  int rc = 0;
  static const long long resident = resident_blocks(
      dequant_two_stores<T, kLoads>, kDequantThreads, 0, &rc);
  if (rc) return rc;
  const long long chunks = (size + 15) / 16;
  const long long need = (chunks + kDequantThreads - 1) / kDequantThreads;
  dequant_two_stores<T, kLoads><<<
      static_cast<unsigned>(PERSIST && resident < need ? resident : need),
      kDequantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), size,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''

BULK = r'''constexpr int kBulkRows = 16;    // rows of q a stage holds: 4 KB
constexpr int kBulkStages = 4;

__device__ __forceinline__ uint32_t bulk_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a block takes the tiles of 16 rows b, b + grid, ...
template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
dequant_bulk(const int8_t* __restrict__ q, const float* __restrict__ scale,
             long long size, T* __restrict__ out) {
  using Q = typename Chunk<T>::Q;
  constexpr int kN = sizeof(Q);
  constexpr int kStageChunks = kBulkRows * kBlock / kN;
  __shared__ alignas(128) Q ring[kBulkStages][kStageChunks];
  __shared__ alignas(8) uint64_t full[kBulkStages];
  const long long rows = (size + kBlock - 1) / kBlock;
  const long long tiles = (rows + kBulkRows - 1) / kBulkRows;
  const long long mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long chunks = (size + kN - 1) / kN;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kBulkStages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       bulk_smem(&full[st])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long k) {
    const long long r0 = (blockIdx.x + k * gridDim.x) * kBulkRows;
    const long long left = rows - r0;
    const unsigned bytes = static_cast<unsigned>(
        (left < kBulkRows ? left : kBulkRows) * kBlock);
    const int st = static_cast<int>(k % kBulkStages);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bulk_smem(&full[st])), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(bulk_smem(ring[st])),
        "l"(q + r0 * kBlock), "r"(bytes), "r"(bulk_smem(&full[st]))
        : "memory");
  };
  if (threadIdx.x == 0)
    for (long long k = 0; k < mine && k < kBulkStages; ++k) issue(k);
  const bool vec = aligned16(out);
  for (long long k = 0; k < mine; ++k) {
    const int st = static_cast<int>(k % kBulkStages);
    const uint32_t parity = static_cast<uint32_t>((k / kBulkStages) & 1);
    asm volatile(
        "{\n.reg .pred p;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra LAB_WAIT;\n}\n" ::"r"(bulk_smem(&full[st])), "r"(parity)
        : "memory");
    const long long base = (blockIdx.x + k * gridDim.x) * kStageChunks;
    for (int x = threadIdx.x; x < kStageChunks; x += kDequantThreads) {
      const long long c = base + x;
      if (c < chunks) {
        const Q raw = ring[st][x];
        const float s = __ldg(scale + c * kN / kBlock);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        const long long i = c * kN;
        if (vec && i + kN <= size) {
          store_chunk(out + i, b, s);
        } else {
          for (int j = 0; j < kN && i + j < size; ++j)
            put(out + i + j, static_cast<float>(b[j]) * s);
        }
      }
    }
    __syncthreads();  // the stage is read before it is filled again
    if (threadIdx.x == 0 && k + kBulkStages < mine) issue(k + kBulkStages);
  }
}

template <typename T>
int launch_dequant(const void* q, const void* scale, long long size,
                   void* out, void* stream) {
  int rc = 0;
  static const long long resident = resident_blocks(
      dequant_bulk<T>, kDequantThreads, 0, &rc);
  if (rc) return rc;
  const long long tiles = ((size + kBlock - 1) / kBlock + kBulkRows - 1) /
                          kBulkRows;
  dequant_bulk<T><<<static_cast<unsigned>(tiles < resident ? tiles
                                                           : resident),
                    kDequantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), size,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''

PLAIN_STORE = r'''template <typename P, typename V>
__device__ __forceinline__ void st_plain(P* p, V v) { *p = v; }

'''
STORE_CHUNK = "// one streaming 16-byte store of a chunk's values b * s"

# H100 SXM data sheet: HBM3 rate
HBM_BYTES_PER_S = 3.35e12
QUANT = ("committed_quant", "quant_persistent")  # the quantize builds timed


def fail(msg: str):
    print(f"int8_variants: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        fail(f"the int8 source moved: {old.strip()[:60]!r} found "
             f"{src.count(old)} times, expected {count}")
    return src.replace(old, new)


def committed_loads(src: str) -> int:
    m = LOADS.findall(src)
    if len(m) != 1:
        fail("the int8 source moved: kDequantLoads not found once")
    return int(m[0])


def with_launcher(src: str, code: str) -> str:
    """src with its dequantize launcher replaced by `code` (kernel and
    launcher), placed where the launcher was."""
    if src.count(LAUNCH_DEQUANT) != 1:
        fail("the int8 source moved: launch_dequant not found once")
    head, tail = src.split(LAUNCH_DEQUANT)
    return head + RESIDENT + code + "\n" + tail[tail.index(NAMESPACE_END):]


def variants(src: str) -> dict:
    committed_loads(src)
    line = LOADS.search(src).group(0)
    out = {f"loads{n}": sub(src, line, f"constexpr int kDequantLoads = {n};")
           for n in (1, 2, 4)}
    out["persistent"] = with_launcher(src, PERSISTENT)
    for name, persist in (("persistent_two_stores", "true"),
                          ("earlier_kernel", "false")):
        out[name] = with_launcher(src, TWO_STORES.replace("PERSIST",
                                                          persist))
    out["bulk"] = with_launcher(src, BULK)
    out["plain_stores"] = sub(sub(src, STORE_CHUNK,
                                  PLAIN_STORE + STORE_CHUNK),
                              "__stcs(", "st_plain(", 2)
    out["quant_persistent"] = sub(sub(src, LAUNCH_QUANT,
                                      RESIDENT + LAUNCH_QUANT),
                                  QUANT_GRID, QUANT_PERSISTENT)
    return out


def build(tq, _build):
    out_dir = os.path.join(_build.BUILD_DIR, "int8_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(SRC) as f:
        srcs = variants(f.read())
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", os.path.join(out_dir, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, notes = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        kernel = "quant_kernel" if name in QUANT else "dequant"
        for i, line in enumerate(lines):
            if "Compiling entry" in line and kernel in line \
                    and "nv_bfloat16" in line:
                notes[name] = " ".join(x.strip() for x in lines[i + 1:i + 4])
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, args in tq._SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, notes


def timed_in_turns(torch, chip_smoke, fns: dict) -> dict:
    times = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        times[n].append(chip_smoke.cuda_ms(torch, fns[n], 20))
    return times


def report(times: dict, nbytes: int) -> float:
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    for n, ts in times.items():
        mean = sum(ts) / len(ts)
        print(f"{n}: {', '.join(f'{t:.4f}' for t in ts)} ms; "
              f"{nbytes / mean / 1e6:.0f} GB/s; {bound / mean:.1%} of the "
              f"bound")
    return bound


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    import chip_smoke
    from dlrover_wuqiong_tpu_torch import _build
    from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig, init_params
    from dlrover_wuqiong_tpu_torch.ops import quantization as tq

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    libs, notes = build(tq, _build)
    with open(SRC) as f:
        committed = f"loads{committed_loads(f.read())}"
    for name, line in notes.items():
        print(f"{name}: {'quantize' if name in QUANT else 'dequantize'} "
              f"bf16: {line}")
    print(f"committed: {committed}")

    params = init_params(GPTConfig.gpt2(), seed=0)
    mats = [t for t in chip_smoke.leaves(params) if t.dim() >= 2]
    del params
    q, s, first = tq.quantize_int8_blockwise_grouped(mats)
    size = q.numel()
    stream = torch.cuda.current_stream().cuda_stream

    # dequantize: every build but the quantize variant
    ref = tq._dequantize_plain(q, s, size, (size,), torch.bfloat16)
    deq = [n for n in libs if n not in QUANT]
    outs = {n: torch.empty(size, dtype=torch.bfloat16, device="cuda")
            for n in deq}

    def dequant(n):
        return lambda: tq._check_rc(libs[n].dequantize_int8_blockwise_bf16(
            q.data_ptr(), s.data_ptr(), size, outs[n].data_ptr(), stream), n)

    for n in deq:
        outs[n].fill_(float("nan"))
        dequant(n)()
        torch.cuda.synchronize()
        if not torch.equal(outs[n].view(torch.int16), ref.view(torch.int16)):
            fail(f"{n}: differs bitwise from the plain dequantize")
    print(f"every dequantize variant equals the plain version bitwise "
          f"({q.shape[0]} rows, {size} values)")
    fns = {n: dequant(n) for n in deq}
    cast_out = torch.empty(size, dtype=torch.bfloat16, device="cuda")
    fns["torch_cast"] = lambda: cast_out.copy_(q.view(-1))
    d_bytes = q.numel() + s.numel() * 4 + size * 2
    d_times = timed_in_turns(torch, chip_smoke, fns)
    d_bound = report(d_times, d_bytes)
    del outs, ref, cast_out

    # quantize: the committed grouped launch and its persistent grid, each
    # into its own store, from the same leaf table
    qp, sp, _ = tq._quantize_grouped_plain(mats)
    table = torch.tensor(
        [t.data_ptr() for t in mats] + [t.numel() for t in mats] + first,
        dtype=torch.int64, device="cuda")
    libs["committed_quant"] = libs[committed]
    stores = {n: (torch.empty_like(q), torch.empty_like(s)) for n in QUANT}

    def quant(n):
        qo, so = stores[n]
        return lambda: tq._check_rc(
            libs[n].quantize_int8_blockwise_grouped_f32(
                table.data_ptr(), len(mats), q.shape[0], qo.data_ptr(),
                so.data_ptr(), stream), n)

    for n in QUANT:
        quant(n)()
        torch.cuda.synchronize()
        qo, so = stores[n]
        if not (torch.equal(qo, qp) and torch.equal(
                so.view(torch.int32), sp.view(torch.int32))):
            fail(f"{n}: differs bitwise from the plain grouped quantize")
    print("both quantize builds equal the plain grouped quantize bitwise")
    q_bytes = sum(t.numel() for t in mats) * 4 + q.numel() + s.numel() * 4
    q_times = timed_in_turns(torch, chip_smoke, {n: quant(n) for n in QUANT})
    q_bound = report(q_times, q_bytes)
    print(card)
    print(json.dumps({"committed": committed, "rows": q.shape[0],
                      "dequantize": {"bytes": d_bytes, "bound_ms": d_bound,
                                     "ms": d_times},
                      "quantize": {"bytes": q_bytes, "bound_ms": q_bound,
                                   "ms": q_times}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
