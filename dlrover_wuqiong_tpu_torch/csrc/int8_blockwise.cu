// Blockwise absmax int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the Pallas pair in dlrover_wuqiong_tpu/ops/quantization.py:
//   _quant_kernel   (:69, launched by quantize_int8_blockwise :97)
//   _dequant_kernel (:78, launched by dequantize_int8_blockwise :120)
//
// What bounds them: bytes.  Quantize does ~5 float32 operations per
// element for 5.02 bytes moved (f32 in, int8 and a scale out), dequantize
// 3 for 3.02 (int8 in, bf16 out), against the ~20 float32 operations per
// byte the H100 can do at its memory rate (67 TFLOP/s over 3.35 TB/s).
//
// Why one launch per tensor missed the bound.  Serving stores GPT-2 124M's
// 50 weight matrices as int8.  48 of them hold 0.59M-2.36M elements, so
// dequantizing one moves 1.8-7.1 MB: 0.5-2.1 us at 3.35 TB/s, about what a
// launch spends filling the card and draining it.  50 launches a dispatch
// lost ~3.6 us each to that, on top of 50 wrapper calls on the host.
//
// The design: one stream of work, one launch.
//   - The store is one flat (R, 256) int8 q and one (R, 1) float32 scale,
//     each leaf a range of whole rows, so every leaf starts 16-byte
//     aligned.  A serving dispatch dequantizes all R rows in ONE launch
//     and the leaves are views of its output.
//   - dequantize: no persistent loop.  Block b converts the 512 chunks
//     from b * 512 on, two a thread, and the grid covers every chunk.  A
//     chunk is 16 bytes of output (8 bf16 values from 8 bytes of q, 4 f32
//     from 4), so each store instruction of a warp writes 512 contiguous
//     bytes.  A thread issues both loads of q and their rows' scales
//     before its first store, and stores with st.global.cs: 249 MB of
//     bf16 do not stay in the 50 MB L2.  Only the first `size` values
//     are written.  int8_variants.py measured the alternatives on an H100
//     80GB HBM3 at 700 W: chunks of 16 values stored as two 16-byte
//     halves 32 bytes apart (each store instruction covers half of every
//     sector it touches) ran ~30% slower in a persistent loop; a
//     persistent grid-stride loop with these chunks ~6% slower; 1 or 4
//     loads a thread within 1.5%; a cp.async.bulk ring of q no faster.
//   - quantize: ONE grouped launch for all leaves of an engine build.  A
//     small leaf table (pointer, element count, first row) is copied into
//     each block's shared memory; a warp takes a row of the global row
//     space, finds its leaf by binary search over the first rows, and
//     reads its 256 values straight from that leaf: 8 a lane (one 16 B
//     load for bf16, two for f32) where the leaf's pointer is 16-byte
//     aligned, else one value at a time, and zeros past the leaf's end
//     (the JAX wrapper's jnp.pad).  The row absmax is a warp-shuffle max.
//     The per-tensor quantize is the one-leaf case of the same kernel,
//     its leaf passed inline.  A persistent grid of warps walking the
//     rows ran 6% slower (int8_variants.py).
//
// Numerics match jnp bit for bit: IEEE division (__fdiv_rn, never a
// reciprocal multiply), round half to even (__float2int_rn, as
// jnp.round), scale 1.0 for an all-zero row, f32 products, and
// round-to-nearest-even to bf16.  Inputs are assumed finite.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;           // elements per quantization row
constexpr int kLanes = 32;
constexpr int kPerLane = kBlock / kLanes;  // 8
constexpr int kQuantThreads = 256;    // 8 warps, one row each at a time
constexpr int kMaxLeaves = 1024;      // leaf table entries per launch
constexpr int kDequantThreads = 256;
constexpr int kDequantLoads = 2;      // chunks a thread loads before storing

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Load 8 consecutive values starting at flat index i; values at or past n
// read as zero (the JAX wrapper's jnp.pad).
__device__ __forceinline__ void load8(const float* x, long long i,
                                      long long n, bool vec, float v[8]) {
  if (vec && i + 8 <= n) {
    float4 a = *reinterpret_cast<const float4*>(x + i);
    float4 b = *reinterpret_cast<const float4*>(x + i + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (i + j < n) ? x[i + j] : 0.0f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, long long i,
                                      long long n, bool vec, float v[8]) {
  if (vec && i + 8 <= n) {
    uint4 u = *reinterpret_cast<const uint4*>(x + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (i + j < n) ? __bfloat162float(x[i + j]) : 0.0f;
  }
}

// The leaves of one quantize launch: `table` in device memory holds
// count pointers, then count element counts, then count first rows
// (ascending from 0), all int64; or, when table is null, the one leaf
// (x, n) at row 0.
struct Leaves {
  const long long* table;
  int count;
  const void* x;
  long long n;
};

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quant_kernel(Leaves leaves, long long rows, int8_t* __restrict__ q,
             float* __restrict__ scale) {
  extern __shared__ long long tab[];  // pointers, counts, first rows
  const int count = leaves.count;
  if (leaves.table != nullptr) {
    for (int i = threadIdx.x; i < 3 * count; i += blockDim.x)
      tab[i] = leaves.table[i];
  } else if (threadIdx.x == 0) {
    tab[0] = reinterpret_cast<long long>(leaves.x);
    tab[1] = leaves.n;
    tab[2] = 0;
  }
  __syncthreads();
  const long long* first = tab + 2 * count;
  const int lane = threadIdx.x % kLanes;
  const long long warps =
      static_cast<long long>(gridDim.x) * (kQuantThreads / kLanes);
  // the launch gives each warp one row; a smaller grid would walk the
  // rest (warp-uniform: the shuffles stay full)
  for (long long row =
           static_cast<long long>(blockIdx.x) * (kQuantThreads / kLanes) +
           threadIdx.x / kLanes;
       row < rows; row += warps) {
    // the row's leaf: the last whose first row is <= row (an empty leaf
    // shares its first row with the next one and is passed over)
    int lo = 0, hi = count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= row) lo = mid; else hi = mid - 1;
    }
    const T* x = reinterpret_cast<const T*>(tab[lo]);
    float v[kPerLane];
    load8(x, (row - first[lo]) * kBlock + lane * kPerLane, tab[count + lo],
          aligned16(x), v);

    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) m = fmaxf(m, fabsf(v[j]));
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float s = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;

    union {
      int8_t b[kPerLane];
      uint2 u;
    } out;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      int r = __float2int_rn(__fdiv_rn(v[j], s));
      out.b[j] = static_cast<int8_t>(min(127, max(-127, r)));
    }
    // q rows are 256 B apart and the lane offset is 8 B: always aligned
    *reinterpret_cast<uint2*>(q + row * kBlock + lane * kPerLane) = out.u;
    if (lane == 0) scale[row] = s;
  }
}

// A chunk is 16 bytes of output: 8 bf16 values from 8 bytes of q, or 4
// f32 values from 4, so each store instruction of a warp writes 512
// contiguous bytes.
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> { using Q = uint2; };
template <> struct Chunk<float> { using Q = uint32_t; };

__device__ __forceinline__ void put(float* o, float f) { *o = f; }
__device__ __forceinline__ void put(__nv_bfloat16* o, float f) {
  *o = __float2bfloat16_rn(f);
}

// one streaming 16-byte store of a chunk's values b * s
__device__ __forceinline__ void store_chunk(__nv_bfloat16* o,
                                            const int8_t* b, float s) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 h =
        __floats2bfloat162_rn(static_cast<float>(b[2 * j]) * s,
                              static_cast<float>(b[2 * j + 1]) * s);
    w[j] = *reinterpret_cast<uint32_t*>(&h);  // .x in the low half
  }
  __stcs(reinterpret_cast<int4*>(o), make_int4(w[0], w[1], w[2], w[3]));
}

__device__ __forceinline__ void store_chunk(float* o, const int8_t* b,
                                            float s) {
  __stcs(reinterpret_cast<float4*>(o),
         make_float4(static_cast<float>(b[0]) * s,
                     static_cast<float>(b[1]) * s,
                     static_cast<float>(b[2]) * s,
                     static_cast<float>(b[3]) * s));
}

// q: (rows, 256) int8, 16-byte aligned, with size <= rows * 256, so every
// chunk that holds a value below size exists in full.  Block b converts
// the kDequantThreads * LOADS chunks from b * kDequantThreads * LOADS on,
// thread t the chunks t, t + kDequantThreads, ...; only the first `size`
// values are written.
template <typename T, int LOADS>
__global__ void __launch_bounds__(kDequantThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               long long size, T* __restrict__ out) {
  using Q = typename Chunk<T>::Q;
  constexpr int kN = sizeof(Q);  // values a chunk
  const long long chunks = (size + kN - 1) / kN;
  const long long c0 =
      static_cast<long long>(blockIdx.x) * kDequantThreads * LOADS +
      threadIdx.x;
  const bool vec = aligned16(out);
  const Q* qc = reinterpret_cast<const Q*>(q);
  // every load first, then the conversions and stores
  Q raw[LOADS];
  float s[LOADS];
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const long long c = c0 + u * kDequantThreads;
    if (c < chunks) {
      raw[u] = qc[c];
      s[u] = __ldg(scale + c * kN / kBlock);
    }
  }
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const long long c = c0 + u * kDequantThreads;
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

template <typename T>
int launch_quant(Leaves leaves, long long rows, void* q, void* scale,
                 void* stream) {
  if (leaves.count < 1 || leaves.count > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 3 * sizeof(long long) * leaves.count;
  const long long need = (rows + kQuantThreads / kLanes - 1) /
                         (kQuantThreads / kLanes);
  const unsigned grid = static_cast<unsigned>(need);  // a warp a row
  quant_kernel<T><<<grid, kQuantThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      leaves, rows, static_cast<int8_t*>(q), static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequant(const void* q, const void* scale, long long size,
                   void* out, void* stream) {
  constexpr long long kN = sizeof(typename Chunk<T>::Q);
  constexpr long long kPerBlock = kDequantThreads * kDequantLoads;
  const long long chunks = (size + kN - 1) / kN;
  dequant_kernel<T, kDequantLoads><<<
      static_cast<unsigned>((chunks + kPerBlock - 1) / kPerBlock),
      kDequantThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), size,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One tensor: x holds n contiguous values; q: (rows, 256) int8; scale:
// (rows,) f32, with rows = ceil(n / 256) > 0.
int quantize_int8_blockwise_f32(const void* x, long long n, long long rows,
                                void* q, void* scale, void* stream) {
  return launch_quant<float>(Leaves{nullptr, 1, x, n}, rows, q, scale,
                             stream);
}

int quantize_int8_blockwise_bf16(const void* x, long long n, long long rows,
                                 void* q, void* scale, void* stream) {
  return launch_quant<__nv_bfloat16>(Leaves{nullptr, 1, x, n}, rows, q,
                                     scale, stream);
}

// Grouped: table is int64 on the device, count pointers (each leaf's n
// contiguous values), count sizes n, count first rows (ascending from 0,
// leaf i owning rows first[i] .. first[i] + ceil(n_i / 256) - 1); q:
// (rows, 256) int8; scale: (rows,) f32, rows > 0; 1 <= count <= 1024.
int quantize_int8_blockwise_grouped_f32(const void* table, int count,
                                        long long rows, void* q, void* scale,
                                        void* stream) {
  return launch_quant<float>(
      Leaves{static_cast<const long long*>(table), count, nullptr, 0}, rows,
      q, scale, stream);
}

int quantize_int8_blockwise_grouped_bf16(const void* table, int count,
                                         long long rows, void* q,
                                         void* scale, void* stream) {
  return launch_quant<__nv_bfloat16>(
      Leaves{static_cast<const long long*>(table), count, nullptr, 0}, rows,
      q, scale, stream);
}

// q: (rows, 256) int8, 16-byte aligned; scale: (rows,) f32; out: size > 0
// contiguous values, size <= rows * 256.
int dequantize_int8_blockwise_f32(const void* q, const void* scale,
                                  long long size, void* out, void* stream) {
  return launch_dequant<float>(q, scale, size, out, stream);
}

int dequantize_int8_blockwise_bf16(const void* q, const void* scale,
                                   long long size, void* out, void* stream) {
  return launch_dequant<__nv_bfloat16>(q, scale, size, out, stream);
}

}  // extern "C"
