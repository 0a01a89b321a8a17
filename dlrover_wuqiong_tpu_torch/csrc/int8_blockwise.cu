// Blockwise absmax int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the Pallas pair in dlrover_wuqiong_tpu/ops/quantization.py:
//   _quant_kernel   (:69-75, launched by quantize_int8_blockwise :97)
//   _dequant_kernel (:78-79, launched by dequantize_int8_blockwise :120)
//
// Both are bound by device memory, not by arithmetic: a few operations per
// byte against the ~295 the H100 needs before its ALUs become the limit.
// The design therefore moves each byte once, in 16-byte accesses:
//   - quantize: one warp per 256-element row, 8 values per lane (one 16 B
//     load for bf16, two for f32); the row absmax is a warp-shuffle max,
//     so no shared memory and no second pass.  The zero padding of the
//     last row is synthesised in registers instead of being copied in.
//   - dequantize: one thread per 16 int8 values (one 16 B load), writing
//     the output dtype directly and only the first `size` elements, so
//     the trim, reshape and cast of the JAX wrapper cost no extra pass.
//
// Numerics match jnp bit for bit: IEEE division (__fdiv_rn, never a
// reciprocal multiply), round half to even (__float2int_rn, as
// jnp.round), f32 products, and round-to-nearest-even to bf16.  Inputs
// are assumed finite.
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
constexpr int kWarpsPerCta = 8;
constexpr int kDequantPerThread = 16;
constexpr int kDequantThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * kLanes)
quant_kernel(const T* __restrict__ x, long long n, long long rows,
             int8_t* __restrict__ q, float* __restrict__ scale) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (row >= rows) return;  // warp-uniform: the shuffles below stay full
  const long long i = row * kBlock + lane * kPerLane;
  float v[kPerLane];
  load8(x, i, n, aligned16(x), v);

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
  *reinterpret_cast<uint2*>(q + i) = out.u;
  if (lane == 0) scale[row] = s;
}

__device__ __forceinline__ void store16(float* out, long long i,
                                        long long size, bool vec,
                                        const float f[16]) {
  if (vec && i + 16 <= size) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reinterpret_cast<float4*>(out + i)[j] =
          make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
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
      w[j] = *reinterpret_cast<uint32_t*>(&h);  // .x in the low half
    }
    reinterpret_cast<uint4*>(out + i)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4*>(out + i)[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
    for (int j = 0; j < 16 && i + j < size; ++j)
      out[i + j] = __float2bfloat16_rn(f[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               long long size, T* __restrict__ out) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * kDequantThreads + threadIdx.x) *
      kDequantPerThread;
  if (i >= size) return;  // the trimmed tail is never read
  // q is (rows, 256) int8 and size <= rows * 256, so all 16 bytes exist
  union {
    int4 v;
    int8_t b[16];
  } raw;
  raw.v = *reinterpret_cast<const int4*>(q + i);
  const float s = scale[i / kBlock];
  float f[kDequantPerThread];
#pragma unroll
  for (int j = 0; j < kDequantPerThread; ++j)
    f[j] = static_cast<float>(raw.b[j]) * s;
  store16(out, i, size, aligned16(out), f);
}

template <typename T>
int launch_quant(const void* x, long long n, long long rows, void* q,
                 void* scale, void* stream) {
  const unsigned grid =
      static_cast<unsigned>((rows + kWarpsPerCta - 1) / kWarpsPerCta);
  quant_kernel<T><<<grid, kWarpsPerCta * kLanes, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n, rows, static_cast<int8_t*>(q),
      static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequant(const void* q, const void* scale, long long size,
                   void* out, void* stream) {
  const long long threads =
      (size + kDequantPerThread - 1) / kDequantPerThread;
  const unsigned grid = static_cast<unsigned>(
      (threads + kDequantThreads - 1) / kDequantThreads);
  dequant_kernel<T><<<grid, kDequantThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), size,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n contiguous values; q: (rows, 256) int8; scale: (rows,) f32, with
// rows = ceil(n / 256) > 0.
int quantize_int8_blockwise_f32(const void* x, long long n, long long rows,
                                void* q, void* scale, void* stream) {
  return launch_quant<float>(x, n, rows, q, scale, stream);
}

int quantize_int8_blockwise_bf16(const void* x, long long n, long long rows,
                                 void* q, void* scale, void* stream) {
  return launch_quant<__nv_bfloat16>(x, n, rows, q, scale, stream);
}

// q: (rows, 256) int8; scale: (rows,) f32; out: size > 0 contiguous values.
int dequantize_int8_blockwise_f32(const void* q, const void* scale,
                                  long long size, void* out, void* stream) {
  return launch_dequant<float>(q, scale, size, out, stream);
}

int dequantize_int8_blockwise_bf16(const void* q, const void* scale,
                                   long long size, void* out, void* stream) {
  return launch_dequant<__nv_bfloat16>(q, scale, size, out, stream);
}

}  // extern "C"
