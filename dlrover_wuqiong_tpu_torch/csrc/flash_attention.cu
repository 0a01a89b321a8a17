// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the four Pallas kernels of
// dlrover_wuqiong_tpu/ops/flash_attention.py:
//   fa_fwd_kernel       <- _fa_fwd_kernel       (:108, launched by
//                          _fa_forward_pallas :241, call :255)
//   fa_bwd_dq_kernel    <- _fa_bwd_dq_kernel    (:327, _fa_backward_pallas
//                          :458, call :511)
//   fa_bwd_dkv_kernel   <- _fa_bwd_dkv_kernel   (:375, call :531)
//   fa_bwd_fused_kernel <- _fa_bwd_fused_kernel (:429, call :492)
//
// Layout: q (bh, sq, D), k and v (bh, sk, D), o, do, dq, dk, dv alike, all
// bf16 and contiguous; lse and delta (bh, sq) float32.  D is 64 or 128
// (the wrapper zero-pads other head dims).  Any sq, sk >= 1: ragged tiles
// are zero-filled on load and masked.
//
// Semantics kept from the Pallas kernels: q is pre-scaled by
// sm_scale*log2(e) and rounded back to bf16, so scores live in log2 units
// and every exponential is exp2; the causal mask is aligned bottom-right
// (key j is visible to query i when j <= i + sk - sq) and is built only on
// tiles that straddle the diagonal or the ragged edge, tiles past the
// diagonal are skipped; masked scores are -1e30; p is rounded to bf16
// before the PV product; lse is natural log, -inf for a row with no
// visible key (whose o is 0); the backward recomputes p = exp2(s - lse *
// log2(e)) and takes ds = p * (dp - delta) * sm_scale, where delta =
// rowsum(dO*O) - glse comes in from the wrapper.  The dk/dv kernel rounds
// p to bf16 before ds, as its Pallas counterpart does; dq and the fused
// kernel use the float32 p.
//
// What bounds them (computed at GPT-2's step: bh = 288, s = 1024, D = 64,
// causal; H100 SXM data sheet, 989 TFLOP/s bf16, 3.35 TB/s): the forward
// moves ~152 MB for ~39 GFLOP and is bound by bytes (45 us); the fused
// backward moves ~267 MB for ~97 GFLOP, dq ~58 and dk/dv ~77 GFLOP, all
// bound by operations (98, 59 and 78 us).  All four sit near the card's
// ridge point, so the tensor cores are the resource to keep fed.  The
// design, simple on purpose:
//   - 4 warps per block, each owns 16 rows of a 64-row tile; products are
//     mma.sync m16n8k16 bf16 -> f32 with ldmatrix fragment loads from
//     shared memory rows padded by 8 bf16 (conflict-free ldmatrix);
//   - tiles come in with cp.async (16 B per thread per copy), one buffer
//     per operand: latency is hidden by the other resident blocks, not by
//     a software pipeline (a later change: double buffering, then wgmma
//     and TMA);
//   - forward: one block per (bh, 64-row q tile), heaviest causal tiles
//     first; m, l and the output accumulator stay in registers;
//   - dq: one block per (bh, q tile), loop over kv tiles, dq in registers;
//   - dk/dv: one block per (bh, kv tile), loop over q tiles, dk and dv in
//     registers;
//   - fused: one block per bh walks the kv tiles and, inside, the q tiles.
//     dk and dv stay in registers; dq is added into a float32 scratch
//     (bh, sq, D) whose every element belongs to one thread for the whole
//     walk (warp w owns rows 16w.. of each q tile).  No atomics: the sums
//     run in one fixed order, so two runs on equal inputs give bitwise
//     equal dq, dk and dv (the JAX package pins bit-identical replays).
//     The price is parallelism: bh blocks (288 at GPT-2's step) for 132
//     SMs, and the scratch's read-modify-write traffic, mostly in L2.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute); the Python
// wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // masked score, as the Pallas kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvLog2e = 0.6931471805599453f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // rows of the tile the 4 warps share

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `valid` false zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(f32(x) * s) for both halves of a bf16 pair
__device__ __forceinline__ uint32_t scale_pair(uint32_t r, float s) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
  return pack_bf16(f.x * s, f.y * s);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------- fragments
// Fragment layouts of mma.m16n8k16 (lane = 4g + t): A holds (row g | g+8,
// cols 2t, 2t+1 | +8), B holds (k 2t, 2t+1 | +8, col g), C holds (row
// g | g+8, cols 2t, 2t+1).  `ld` is the row stride of the tile in bf16.

// A (16x16 at row r0, col c0) of a row-major tile M[r][c]
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* m, int ld,
                                     int r0, int c0, int lane) {
  ldsm_x4(a, m + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// A = S^T (16x16 at row r0, col c0) from a row-major tile S[c][r]
__device__ __forceinline__ void ld_a_t(uint32_t (&a)[4], const bf16* s,
                                       int ld, int r0, int c0, int lane) {
  ldsm_x4_t(a, s + (c0 + (lane & 7) + (lane >> 4) * 8) * ld + r0 +
                   ((lane >> 3) & 1) * 8);
}

// B for two 8-col n tiles (n0, n0+8) and k rows k0..k0+15, from a tile
// stored n-major (M[n][k], e.g. K when computing q K^T).  b[0], b[1] are
// the n0 tile's registers, b[2], b[3] the n0+8 tile's.
__device__ __forceinline__ void ld_b_n(uint32_t (&b)[4], const bf16* m,
                                       int ld, int n0, int k0, int lane) {
  ldsm_x4(b, m + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// the same from a tile stored k-major (M[k][n], e.g. V when computing P V)
__device__ __forceinline__ void ld_b_k(uint32_t (&b)[4], const bf16* m,
                                       int ld, int k0, int n0, int lane) {
  ldsm_x4_t(b, m + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// A for k block kk from a 16 x (16*KB) f32 accumulator in C layout
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// copy rows [row0, row0 + R) of a (n, D) bf16 matrix into smem[r * ld + c];
// rows at or past n are zero
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          int row0, int n, int R) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const int gr = row0 + r;
    const bool ok = gr < n;
    cp_async16(dst + r * ld + c, src + (size_t)(ok ? gr : 0) * D + c, ok);
  }
}

// q <- bf16(f32(q) * s) over R rows of a tile in shared memory
template <int D>
__device__ __forceinline__ void scale_rows(bf16* m, int ld, int R, float s) {
  for (int i = threadIdx.x; i < R * D / 2; i += kThreads) {
    uint32_t* p = reinterpret_cast<uint32_t*>(m + (i / (D / 2)) * ld +
                                              (i % (D / 2)) * 2);
    *p = scale_pair(*p, s);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// ------------------------------------------------------------------ forward

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
              const bf16* __restrict__ V, bf16* __restrict__ O,
              float* __restrict__ LSE, int sq, int sk, int causal,
              float scale_log2) {
  constexpr int BQ = kTile, BK = kTile, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int nqt = (sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - blockIdx.x) * BQ;  // heavy causal tiles first
  const size_t bh = blockIdx.y;
  const int off = sk - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* Qb = Q + bh * sq * D;
  const bf16* Kb = K + bh * sk * D;
  const bf16* Vb = V + bh * sk * D;

  load_rows<D>(sQ, LD, Qb, q0, sq, BQ);
  cp_async_wait_all();
  __syncthreads();
  scale_rows<D>(sQ, LD, BQ, scale_log2);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a, +8
  const int kv_end = causal ? min(sk, q0 + BQ + off) : sk;
  const int nkv = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  for (int j = 0; j < nkv; ++j) {
    const int kv0 = j * BK;
    __syncthreads();  // previous tile's readers are done (and sQ scaled)
    load_rows<D>(sK, LD, Kb, kv0, sk, BK);
    load_rows<D>(sV, LD, Vb, kv0, sk, BK);
    cp_async_wait_all();
    __syncthreads();

    float s[BK / 8][4];
    zero(s);
#pragma unroll
    for (int kb = 0; kb < D / 16; ++kb) {
      uint32_t a[4];
      ld_a(a, sQ, LD, warp * 16, kb * 16, lane);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ld_b_n(b, sK, LD, np * 16, kb * 16, lane);
        mma(s[2 * np], a, b[0], b[1]);
        mma(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    const bool masked =
        kv0 + BK > sk || (causal && kv0 + BK - 1 > q0 + off);
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nt * 8 + 2 * t + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (col >= sk || (causal && col > row + off)) s[nt][e] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a row with no visible key so far has m = -1e30: exp2(0) would
        // count its masked entries
        const float p = (masked && s[nt][e] <= kNegInf)
                            ? 0.f
                            : exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ld_b_k(b, sV, LD, kk * 16, dp * 16, lane);
        mma(acc[2 * dp], a, b[0], b[1]);
        mma(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row_a + h * 8;
    if (row >= sq) continue;
    const float ls = l[h] > 0.f ? l[h] : 1.f;
    uint32_t* orow = reinterpret_cast<uint32_t*>(O + (bh * sq + row) * D);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      orow[(dt * 8 + 2 * t) / 2] =
          pack_bf16(acc[dt][2 * h] / ls, acc[dt][2 * h + 1] / ls);
    if (t == 0)
      LSE[bh * sq + row] =
          l[h] > 0.f ? m[h] * kInvLog2e + logf(ls) : -INFINITY;
  }
}

// ------------------------------------------------------------- backward: dq

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                 const bf16* __restrict__ V, const bf16* __restrict__ dO,
                 const float* __restrict__ LSE,
                 const float* __restrict__ DELTA, bf16* __restrict__ dQ,
                 int sq, int sk, int causal, float scale_log2,
                 float sm_scale) {
  constexpr int BQ = kTile, BK = kTile, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int nqt = (sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - blockIdx.x) * BQ;
  const size_t bh = blockIdx.y;
  const int off = sk - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* Kb = K + bh * sk * D;
  const bf16* Vb = V + bh * sk * D;

  load_rows<D>(sQ, LD, Q + bh * sq * D, q0, sq, BQ);
  load_rows<D>(sdO, LD, dO + bh * sq * D, q0, sq, BQ);
  cp_async_wait_all();
  __syncthreads();
  scale_rows<D>(sQ, LD, BQ, scale_log2);

  const int row_a = q0 + warp * 16 + g;
  float lse2[2], delta[2];
  bool fin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + h * 8;
    const float L = row < sq ? LSE[bh * sq + row] : -INFINITY;
    fin[h] = isfinite(L);
    lse2[h] = fin[h] ? L * kLog2e : 0.f;
    delta[h] = row < sq ? DELTA[bh * sq + row] : 0.f;
  }
  float dq[D / 8][4];
  zero(dq);
  const int kv_end = causal ? min(sk, q0 + BQ + off) : sk;
  const int nkv = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  for (int j = 0; j < nkv; ++j) {
    const int kv0 = j * BK;
    __syncthreads();
    load_rows<D>(sK, LD, Kb, kv0, sk, BK);
    load_rows<D>(sV, LD, Vb, kv0, sk, BK);
    cp_async_wait_all();
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kb = 0; kb < D / 16; ++kb) {
      uint32_t aq[4], ao[4];
      ld_a(aq, sQ, LD, warp * 16, kb * 16, lane);
      ld_a(ao, sdO, LD, warp * 16, kb * 16, lane);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ld_b_n(b, sK, LD, np * 16, kb * 16, lane);
        mma(s[2 * np], aq, b[0], b[1]);
        mma(s[2 * np + 1], aq, b[2], b[3]);
        ld_b_n(b, sV, LD, np * 16, kb * 16, lane);
        mma(dp[2 * np], ao, b[0], b[1]);
        mma(dp[2 * np + 1], ao, b[2], b[3]);
      }
    }
    const bool masked =
        kv0 + BK > sk || (causal && kv0 + BK - 1 > q0 + off);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float sv = s[nt][e];
        if (masked) {
          const int col = kv0 + nt * 8 + 2 * t + (e & 1);
          if (col >= sk || (causal && col > row_a + h * 8 + off))
            sv = kNegInf;
        }
        const float p = fin[h] ? exp2f(sv - lse2[h]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta[h]) * sm_scale;  // ds
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t b[4];
        ld_b_k(b, sK, LD, kk * 16, dt * 16, lane);
        mma(dq[2 * dt], a, b[0], b[1]);
        mma(dq[2 * dt + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + h * 8;
    if (row >= sq) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dQ + (bh * sq + row) * D);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      out[(dt * 8 + 2 * t) / 2] = pack_bf16(dq[dt][2 * h], dq[dt][2 * h + 1]);
  }
}

// ------------------------------------------------ backward: one q tile's work
// for a 64-row kv tile: S^T, P^T, dV, dP^T, dS^T and dK, shared by the dk/dv
// kernel and the fused kernel.  Leaves dS^T (f32, C layout) in `st`.

template <int D, int BQ, bool kRoundP>
__device__ __forceinline__ void kv_tile_step(
    const bf16* sK, const bf16* sV, const bf16* sQ, const bf16* sdO,
    const float* sL, const float* sD, int kv0, int q0, int sk, int off,
    int causal, float scale_log2, float sm_scale, float (&dk)[D / 8][4],
    float (&dv)[D / 8][4], float (&st)[BQ / 8][4]) {
  constexpr int LD = D + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float dpt[BQ / 8][4];
  zero(st);
  zero(dpt);
#pragma unroll
  for (int kb = 0; kb < D / 16; ++kb) {
    uint32_t ak[4], av[4];
    ld_a(ak, sK, LD, warp * 16, kb * 16, lane);
    ld_a(av, sV, LD, warp * 16, kb * 16, lane);
#pragma unroll
    for (int np = 0; np < BQ / 16; ++np) {
      uint32_t b[4];
      ld_b_n(b, sQ, LD, np * 16, kb * 16, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) b[r] = scale_pair(b[r], scale_log2);
      mma(st[2 * np], ak, b[0], b[1]);
      mma(st[2 * np + 1], ak, b[2], b[3]);
      ld_b_n(b, sdO, LD, np * 16, kb * 16, lane);
      mma(dpt[2 * np], av, b[0], b[1]);
      mma(dpt[2 * np + 1], av, b[2], b[3]);
    }
  }
  const int kv_a = kv0 + warp * 16 + g;  // this thread's kv rows: kv_a, +8
  const bool masked =
      kv0 + kTile > sk || (causal && q0 + off < kv0 + kTile - 1);
#pragma unroll
  for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = nt * 8 + 2 * t + (e & 1);
      float sv = st[nt][e];
      if (masked) {
        const int kv = kv_a + (e >> 1) * 8;
        if (kv >= sk || (causal && kv > q0 + qc + off)) sv = kNegInf;
      }
      const float L = sL[qc];
      float p = isfinite(L) ? exp2f(sv - L * kLog2e) : 0.f;
      if (kRoundP) p = round_bf16(p);
      st[nt][e] = p;
    }
  // dV += P^T dO
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    uint32_t a[4];
    c_to_a(a, st, kk);
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t b[4];
      ld_b_k(b, sdO, LD, kk * 16, dt * 16, lane);
      mma(dv[2 * dt], a, b[0], b[1]);
      mma(dv[2 * dt + 1], a, b[2], b[3]);
    }
  }
  // dS^T = P^T * (dP^T - delta) * sm_scale
#pragma unroll
  for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[nt][e] = st[nt][e] * (dpt[nt][e] - sD[nt * 8 + 2 * t + (e & 1)]) *
                  sm_scale;
  // dK += dS^T Q
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    uint32_t a[4];
    c_to_a(a, st, kk);
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t b[4];
      ld_b_k(b, sQ, LD, kk * 16, dt * 16, lane);
      mma(dk[2 * dt], a, b[0], b[1]);
      mma(dk[2 * dt + 1], a, b[2], b[3]);
    }
  }
}

// load one q tile's rows of Q, dO, lse and delta (rows past sq: lse -inf,
// so p = 0 there, and delta 0)
template <int D, int BQ>
__device__ __forceinline__ void load_q_tile(
    bf16* sQ, bf16* sdO, float* sL, float* sD, const bf16* Qb,
    const bf16* dOb, const float* Lb, const float* Db, int q0, int sq) {
  constexpr int LD = D + 8;
  load_rows<D>(sQ, LD, Qb, q0, sq, BQ);
  load_rows<D>(sdO, LD, dOb, q0, sq, BQ);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = q0 + r;
    sL[r] = row < sq ? Lb[row] : -INFINITY;
    sD[r] = row < sq ? Db[row] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
}

template <int D>
__device__ __forceinline__ void store_kv_rows(bf16* dK, bf16* dV,
                                              const float (&dk)[D / 8][4],
                                              const float (&dv)[D / 8][4],
                                              int kv0, int sk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kv = kv0 + warp * 16 + g + h * 8;
    if (kv >= sk) continue;
    uint32_t* ok = reinterpret_cast<uint32_t*>(dK + (size_t)kv * D);
    uint32_t* ov = reinterpret_cast<uint32_t*>(dV + (size_t)kv * D);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      ok[(dt * 8 + 2 * t) / 2] = pack_bf16(dk[dt][2 * h], dk[dt][2 * h + 1]);
      ov[(dt * 8 + 2 * t) / 2] = pack_bf16(dv[dt][2 * h], dv[dt][2 * h + 1]);
    }
  }
}

// first q tile whose rows can see kv row kv0 (causal), 0 otherwise
__device__ __forceinline__ int first_q_tile(int kv0, int off, int causal,
                                            int BQ) {
  return causal ? max(0, kv0 - off) / BQ : 0;
}

// ---------------------------------------------------------- backward: dk/dv

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                  const bf16* __restrict__ V, const bf16* __restrict__ dO,
                  const float* __restrict__ LSE,
                  const float* __restrict__ DELTA, bf16* __restrict__ dK,
                  bf16* __restrict__ dV, int sq, int sk, int causal,
                  float scale_log2, float sm_scale) {
  constexpr int BK = kTile, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sdO = sQ + BQ * LD;
  float* sL = reinterpret_cast<float*>(sdO + BQ * LD);
  float* sD = sL + BQ;

  const int kv0 = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  const int off = sk - sq;
  load_rows<D>(sK, LD, K + bh * sk * D, kv0, sk, BK);
  load_rows<D>(sV, LD, V + bh * sk * D, kv0, sk, BK);

  float dk[D / 8][4], dv[D / 8][4], st[BQ / 8][4];
  zero(dk);
  zero(dv);
  const int nqt = (sq + BQ - 1) / BQ;
  for (int i = first_q_tile(kv0, off, causal, BQ); i < nqt; ++i) {
    __syncthreads();
    load_q_tile<D, BQ>(sQ, sdO, sL, sD, Q + bh * sq * D, dO + bh * sq * D,
                       LSE + bh * sq, DELTA + bh * sq, i * BQ, sq);
    kv_tile_step<D, BQ, true>(sK, sV, sQ, sdO, sL, sD, kv0, i * BQ, sk, off,
                              causal, scale_log2, sm_scale, dk, dv, st);
  }
  store_kv_rows<D>(dK + bh * sk * D, dV + bh * sk * D, dk, dv, kv0, sk);
}

// ---------------------------------------------------------- backward: fused

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
fa_bwd_fused_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                    const bf16* __restrict__ V, const bf16* __restrict__ dO,
                    const float* __restrict__ LSE,
                    const float* __restrict__ DELTA, bf16* __restrict__ dQ,
                    bf16* __restrict__ dK, bf16* __restrict__ dV,
                    float* __restrict__ dQacc, int sq, int sk, int causal,
                    float scale_log2, float sm_scale) {
  constexpr int BK = kTile, LD = D + 8, LDS = BQ + 8;
  // the dq product: warp w takes rows 16*(w % RG) of the q tile and
  // columns DC*(w / RG) of the head dim
  constexpr int RG = BQ / 16, CG = 4 / RG, DC = D / CG;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sdO = sQ + BQ * LD;
  bf16* sdS = sdO + BQ * LD;  // dS^T, (BK, BQ)
  float* sL = reinterpret_cast<float*>(sdS + BK * LDS);
  float* sD = sL + BQ;

  const size_t bh = blockIdx.x;
  const int off = sk - sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % RG, cg = warp / RG;
  float* acc = dQacc + bh * sq * D;
  for (int i = threadIdx.x; i < sq * D / 4; i += kThreads)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int nqt = (sq + BQ - 1) / BQ;
  const int nkt = (sk + BK - 1) / BK;
  for (int j = 0; j < nkt; ++j) {
    const int kv0 = j * BK;
    __syncthreads();
    load_rows<D>(sK, LD, K + bh * sk * D, kv0, sk, BK);
    load_rows<D>(sV, LD, V + bh * sk * D, kv0, sk, BK);
    float dk[D / 8][4], dv[D / 8][4], st[BQ / 8][4];
    zero(dk);
    zero(dv);
    for (int i = first_q_tile(kv0, off, causal, BQ); i < nqt; ++i) {
      const int q0 = i * BQ;
      __syncthreads();
      load_q_tile<D, BQ>(sQ, sdO, sL, sD, Q + bh * sq * D, dO + bh * sq * D,
                         LSE + bh * sq, DELTA + bh * sq, q0, sq);
      kv_tile_step<D, BQ, false>(sK, sV, sQ, sdO, sL, sD, kv0, q0, sk, off,
                                 causal, scale_log2, sm_scale, dk, dv, st);
      // dS^T to shared memory, rounded to bf16 as the dq product takes it
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              sdS + (warp * 16 + g + h * 8) * LDS + nt * 8 + 2 * t) =
              pack_bf16(st[nt][2 * h], st[nt][2 * h + 1]);
      __syncthreads();
      // dQ tile += dS K, this warp's (16, DC) share
      float dqp[DC / 8][4];
      zero(dqp);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        ld_a_t(a, sdS, LDS, rg * 16, kk * 16, lane);
#pragma unroll
        for (int dt = 0; dt < DC / 16; ++dt) {
          uint32_t b[4];
          ld_b_k(b, sK, LD, kk * 16, cg * DC + dt * 16, lane);
          mma(dqp[2 * dt], a, b[0], b[1]);
          mma(dqp[2 * dt + 1], a, b[2], b[3]);
        }
      }
      // every element of acc is read and written by this one thread for
      // the whole walk: a fixed order of sums, no atomics
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + rg * 16 + g + h * 8;
        if (row >= sq) continue;
#pragma unroll
        for (int nt = 0; nt < DC / 8; ++nt) {
          float2* p = reinterpret_cast<float2*>(acc + (size_t)row * D +
                                                cg * DC + nt * 8 + 2 * t);
          float2 v = *p;
          v.x += dqp[nt][2 * h];
          v.y += dqp[nt][2 * h + 1];
          *p = v;
        }
      }
    }
    store_kv_rows<D>(dK + bh * sk * D, dV + bh * sk * D, dk, dv, kv0, sk);
  }
  __syncthreads();
  uint32_t* out = reinterpret_cast<uint32_t*>(dQ + bh * sq * D);
  for (int i = threadIdx.x; i < sq * D / 2; i += kThreads) {
    const float2 v = reinterpret_cast<const float2*>(acc)[i];
    out[i] = pack_bf16(v.x, v.y);
  }
}

// ------------------------------------------------------------------ launch

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int sk, int causal,
               float scale_log2, cudaStream_t stream) {
  const size_t smem = 3 * kTile * (D + 8) * sizeof(bf16);
  auto kern = fa_fwd_kernel<D>;
  if (int rc = prepare(kern, smem)) return rc;
  dim3 grid((sq + kTile - 1) / kTile, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, sq, sk,
      causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int sq,
              int sk, int causal, float scale_log2, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = 4 * kTile * (D + 8) * sizeof(bf16);
  auto kern = fa_bwd_dq_kernel<D>;
  if (int rc = prepare(kern, smem)) return rc;
  dim3 grid((sq + kTile - 1) / kTile, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dq, sq, sk, causal, scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// q tile of the dk/dv and fused kernels: 64 rows at D = 64, 32 at D = 128
// (keeps dk, dv, S^T and dP^T in registers)
template <int D>
constexpr int bwd_bq() { return D == 64 ? 64 : 32; }

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int sq, int sk, int causal, float scale_log2,
               float sm_scale, cudaStream_t stream) {
  constexpr int BQ = bwd_bq<D>();
  const size_t smem = (2 * kTile + 2 * BQ) * (D + 8) * sizeof(bf16) +
                      2 * BQ * sizeof(float);
  auto kern = fa_bwd_dkv_kernel<D, BQ>;
  if (int rc = prepare(kern, smem)) return rc;
  dim3 grid((sk + kTile - 1) / kTile, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, sq, sk, causal, scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, float* dq_acc, int bh, int sq,
                 int sk, int causal, float scale_log2, float sm_scale,
                 cudaStream_t stream) {
  constexpr int BQ = bwd_bq<D>();
  const size_t smem = (2 * kTile + 2 * BQ) * (D + 8) * sizeof(bf16) +
                      kTile * (BQ + 8) * sizeof(bf16) +
                      2 * BQ * sizeof(float);
  auto kern = fa_bwd_fused_kernel<D, BQ>;
  if (int rc = prepare(kern, smem)) return rc;
  kern<<<bh, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dq, (bf16*)dk, (bf16*)dv, dq_acc, sq, sk, causal,
      scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------ C interface
// d must be 64 or 128; anything else returns cudaErrorInvalidValue.

extern "C" int fa_forward_bf16(const void* q, const void* k, const void* v,
                               void* o, float* lse, int bh, int sq, int sk,
                               int d, int causal, float scale_log2,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(q, k, v, o, lse, bh, sq, sk, causal,
                                     scale_log2, s);
  if (d == 128) return launch_fwd<128>(q, k, v, o, lse, bh, sq, sk, causal,
                                       scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fa_backward_dq_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int bh, int sq, int sk, int d,
                                   int causal, float scale_log2,
                                   float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, sq,
                                    sk, causal, scale_log2, sm_scale, s);
  if (d == 128) return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, sq,
                                      sk, causal, scale_log2, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fa_backward_dkv_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int bh, int sq,
                                    int sk, int d, int causal,
                                    float scale_log2, float sm_scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     sq, sk, causal, scale_log2, sm_scale, s);
  if (d == 128) return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                       sq, sk, causal, scale_log2, sm_scale,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fa_backward_fused_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, void* dk, void* dv,
                                      float* dq_acc, int bh, int sq, int sk,
                                      int d, int causal, float scale_log2,
                                      float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fused<64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       dq_acc, bh, sq, sk, causal, scale_log2,
                                       sm_scale, s);
  if (d == 128) return launch_fused<128>(q, k, v, dout, lse, delta, dq, dk,
                                         dv, dq_acc, bh, sq, sk, causal,
                                         scale_log2, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
