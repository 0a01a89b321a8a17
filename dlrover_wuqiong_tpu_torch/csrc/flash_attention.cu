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
// p to bf16 before ds, as its Pallas counterpart does; dq and both roles of
// the fused kernel use the float32 p, as the Pallas dq and fused kernels.
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
//   - tiles come in with cp.async (16 B per thread per copy).  The
//     forward, dq and dk/dv kernels keep one buffer per operand and wait
//     for each tile: latency is hidden by the other resident blocks;
//   - forward: one block per (bh, 64-row q tile), heaviest causal tiles
//     first; m, l and the output accumulator stay in registers;
//   - dq: one block per (bh, q tile), loop over kv tiles, dq in registers;
//   - dk/dv: one block per (bh, kv tile), loop over q tiles, dk and dv in
//     registers.
//
// The fused backward is one launch of bh * (ceil(sk/64) + ceil(sq/64))
// blocks (9216 at GPT-2's step) in two roles, none waiting on another:
//   - roles: a dk/dv role per (bh, 64-row kv tile) loops over the q tiles
//     that see its keys, dk and dv in registers (the dk/dv kernel's
//     per-tile code with p kept float32); a dq role per (bh, 64-row q tile)
//     loops over the kv tiles its rows see, dq in registers (the dq
//     kernel's per-tile code, in the same order, so its dq equals the dq
//     kernel's bit for bit).  Every output row belongs to one block, which
//     writes it once, as zeros where a row sees no key or no query sees a
//     key.  No atomics and no scratch: two runs on equal inputs give
//     bitwise equal dq, dk and dv (the JAX package pins bit-identical
//     replays).
//   - order: block numbers go by rank r, the dk/dv blocks of kv tile r then
//     the dq blocks of q tile nqt - 1 - r, so under the causal mask both
//     roles start with their longest loops and the last wave holds the
//     shortest;
//   - pipeline: each role has two shared-memory stages, of q tiles (Q, dO,
//     a pre-scaled copy of Q, lse, delta) or of kv tiles (K, V).  At the
//     top of tile i a thread waits for its own copies (cp.async.wait_group
//     0), then one barrier publishes tile i and frees tile i - 1's stage;
//     the copies of tile i + 1 go out into that stage and fly while tile i
//     computes.  No group count depends on where the loop ends.  Before
//     the barrier each thread of the dk/dv role scales the Q chunks it
//     copied itself (its own cp.async data is visible to it after its
//     wait), so S^T reads pre-scaled fragments instead of converting 64
//     fragment pairs per thread per tile;
//   - registers (nvcc -Xptxas -v): the dk/dv role holds dk, dv, S^T and
//     dP^T, 128 floats a thread at D = 64.  __launch_bounds__ caps the
//     kernel at 168 registers at D = 64 (with a few bytes of spill) so that
//     3 blocks (12 warps, 73 KB of shared memory each) fit an SM; uncapped
//     it takes 183 and fits 2, and ran 13% slower on the card (PERF.md).
//     At D = 128 the dq role's two K/V stages take 102 KB: 2 blocks an SM;
//   - why 7 products, where the Pallas kernel takes 5: the Pallas kernel
//     fuses only when one block covers both sequences, so S and dP serve
//     dq, dk and dv at once.  On Hopper such a block per head leaves bh
//     blocks for 132 SMs and walks the kv tiles in series (the previous
//     design, 1.61 ms at GPT-2's step).  With dq summed over kv tiles and
//     dk/dv over q tiles by different blocks, each role recomputes S and
//     dP: 135.4 GFLOP of products for the function's 96.7 at GPT-2's step.
//   - next: wgmma (warpgroup products from shared memory, the only way to
//     the tensor cores' full rate) fed by TMA into an mbarrier ring from a
//     producer warp, which frees the registers and issue slots that
//     ldmatrix and address arithmetic take now; then FlashAttention-3's one
//     role, dq added in float32 in device memory under a per-tile
//     semaphore that fixes the order of the kv tiles (deterministic, 5
//     products, but blocks wait on each other).
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

// 4-byte async copy (a row's lse or delta)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for every group this thread committed
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// dst <- bf16(f32(src) * s) over the 16-byte chunks of R rows that this
// thread copied with load_rows: its own cp.async data is visible to it
// after cp_async_wait0, before any barrier
template <int D>
__device__ __forceinline__ void scale_own_rows(bf16* dst, const bf16* src,
                                               int ld, int R, float s) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int o = (i / kChunks) * ld + (i % kChunks) * 8;
    uint4 v = *reinterpret_cast<const uint4*>(src + o);
    v.x = scale_pair(v.x, s);
    v.y = scale_pair(v.y, s);
    v.z = scale_pair(v.z, s);
    v.w = scale_pair(v.w, s);
    *reinterpret_cast<uint4*>(dst + o) = v;
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
// The work of one 64-row q tile, shared by the dq kernel and the fused
// kernel's dq role: each thread's two rows' lse (in log2 units) and delta,
// the product of one kv tile (S, dP, dS, dQ += dS K) and the store.

struct RowStats {
  float lse2[2], delta[2];
  bool fin[2];  // lse finite: the row sees a key (else p = 0)
};

__device__ __forceinline__ RowStats row_stats(const float* Lb,
                                              const float* Db, int q0,
                                              int sq) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  RowStats r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + h * 8;
    const float L = row < sq ? Lb[row] : -INFINITY;
    r.fin[h] = isfinite(L);
    r.lse2[h] = r.fin[h] ? L * kLog2e : 0.f;
    r.delta[h] = row < sq ? Db[row] : 0.f;
  }
  return r;
}

// dq += dS K for one 64-row kv tile at kv0; sQ holds the pre-scaled q
// tile, p is float32 (not rounded before dS)
template <int D>
__device__ __forceinline__ void q_tile_step(
    const bf16* sQ, const bf16* sdO, const bf16* sK, const bf16* sV,
    const RowStats& rs, int kv0, int q0, int sk, int off, int causal,
    float sm_scale, float (&dq)[D / 8][4]) {
  constexpr int BK = kTile, LD = D + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g;
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
  const bool masked = kv0 + BK > sk || (causal && kv0 + BK - 1 > q0 + off);
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float sv = s[nt][e];
      if (masked) {
        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
        if (col >= sk || (causal && col > row_a + h * 8 + off)) sv = kNegInf;
      }
      const float p = rs.fin[h] ? exp2f(sv - rs.lse2[h]) : 0.f;
      s[nt][e] = p * (dp[nt][e] - rs.delta[h]) * sm_scale;  // ds
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

template <int D>
__device__ __forceinline__ void store_q_rows(bf16* dQ,
                                             const float (&dq)[D / 8][4],
                                             int q0, int sq) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + h * 8;
    if (row >= sq) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dQ + (size_t)row * D);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      out[(dt * 8 + 2 * t) / 2] = pack_bf16(dq[dt][2 * h], dq[dt][2 * h + 1]);
  }
}

// kv tiles the q tile at q0 sees: up to its last row's diagonal (causal),
// all otherwise
__device__ __forceinline__ int num_kv_tiles(int q0, int sq, int sk,
                                            int causal) {
  const int kv_end = causal ? min(sk, q0 + kTile + sk - sq) : sk;
  return kv_end > 0 ? (kv_end + kTile - 1) / kTile : 0;
}

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
  const bf16* Kb = K + bh * sk * D;
  const bf16* Vb = V + bh * sk * D;

  load_rows<D>(sQ, LD, Q + bh * sq * D, q0, sq, BQ);
  load_rows<D>(sdO, LD, dO + bh * sq * D, q0, sq, BQ);
  cp_async_wait_all();
  __syncthreads();
  scale_rows<D>(sQ, LD, BQ, scale_log2);

  const RowStats rs = row_stats(LSE + bh * sq, DELTA + bh * sq, q0, sq);
  float dq[D / 8][4];
  zero(dq);
  const int nkv = num_kv_tiles(q0, sq, sk, causal);

  for (int j = 0; j < nkv; ++j) {
    const int kv0 = j * BK;
    __syncthreads();
    load_rows<D>(sK, LD, Kb, kv0, sk, BK);
    load_rows<D>(sV, LD, Vb, kv0, sk, BK);
    cp_async_wait_all();
    __syncthreads();
    q_tile_step<D>(sQ, sdO, sK, sV, rs, kv0, q0, sk, off, causal, sm_scale,
                   dq);
  }
  store_q_rows<D>(dQ + bh * sq * D, dq, q0, sq);
}

// ------------------------------------------------ backward: one q tile's work
// for a 64-row kv tile: S^T, P^T, dV, dP^T, dS^T and dK, shared by the dk/dv
// kernel and the fused kernel.  Leaves dS^T (f32, C layout) in `st`.  S^T
// takes q pre-scaled: from `sQs` as it is, or (kScaleQ) from sQ with each
// fragment scaled in registers.

template <int D, int BQ, bool kRoundP, bool kScaleQ>
__device__ __forceinline__ void kv_tile_step(
    const bf16* sK, const bf16* sV, const bf16* sQ, const bf16* sQs,
    const bf16* sdO, const float* sL, const float* sD, int kv0, int q0,
    int sk, int off, int causal, float scale_log2, float sm_scale,
    float (&dk)[D / 8][4], float (&dv)[D / 8][4], float (&st)[BQ / 8][4]) {
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
      if (kScaleQ) {
        ld_b_n(b, sQ, LD, np * 16, kb * 16, lane);
#pragma unroll
        for (int r = 0; r < 4; ++r) b[r] = scale_pair(b[r], scale_log2);
      } else {
        ld_b_n(b, sQs, LD, np * 16, kb * 16, lane);
      }
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
    kv_tile_step<D, BQ, true, true>(sK, sV, sQ, sQ, sdO, sL, sD, kv0, i * BQ,
                                    sk, off, causal, scale_log2, sm_scale, dk,
                                    dv, st);
  }
  store_kv_rows<D>(dK + bh * sk * D, dV + bh * sk * D, dk, dv, kv0, sk);
}

// ---------------------------------------------------------- backward: fused
// One launch of two roles (the source note above): a dk/dv role per (bh,
// kv tile) and a dq role per (bh, q tile), each a two-stage cp.async
// pipeline with one barrier per tile.

// issue one q tile's copies of Q, dO, lse and delta into a stage; rows
// past sq get lse -inf (p = 0 there) and delta 0 by plain stores, which
// the barrier before the stage is read publishes
template <int D, int BQ>
__device__ __forceinline__ void issue_q_tile(bf16* sQ, bf16* sdO, float* sL,
                                             float* sD, const bf16* Qb,
                                             const bf16* dOb, const float* Lb,
                                             const float* Db, int q0,
                                             int sq) {
  constexpr int LD = D + 8;
  load_rows<D>(sQ, LD, Qb, q0, sq, BQ);
  load_rows<D>(sdO, LD, dOb, q0, sq, BQ);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = q0 + r;
    if (row < sq) {
      cp_async4(sL + r, Lb + row);
      cp_async4(sD + r, Db + row);
    } else {
      sL[r] = -INFINITY;
      sD[r] = 0.f;
    }
  }
  cp_async_commit();
}

// shared memory of each role: the dk/dv role keeps its K and V tile and
// two stages of (Q, dO, pre-scaled Q, lse, delta); the dq role keeps its Q
// and dO tile and two stages of (K, V)
template <int D, int BQ>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  return 3 * BQ * (D + 8) * sizeof(bf16) + 2 * BQ * sizeof(float);
}
template <int D, int BQ>
__host__ __device__ constexpr size_t dkv_role_smem() {
  return 2 * kTile * (D + 8) * sizeof(bf16) + 2 * dkv_stage_bytes<D, BQ>();
}
template <int D>
__host__ __device__ constexpr size_t dq_role_smem() {
  return 6 * kTile * (D + 8) * sizeof(bf16);
}

// dk and dv of the kv tile at kv0: loop over the q tiles that see it, the
// next tile's copies in flight while this one computes.  p stays float32
// before dS (kv_tile_step<..., false>), as the Pallas fused kernel's pT.
template <int D, int BQ>
__device__ __forceinline__ void dkv_role(
    unsigned char* smem, const bf16* Qb, const bf16* Kb, const bf16* Vb,
    const bf16* dOb, const float* Lb, const float* Db, bf16* dKb,
    bf16* dVb, int kv0, int sq, int sk, int causal, float scale_log2,
    float sm_scale) {
  constexpr int BK = kTile, LD = D + 8;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LD;
  unsigned char* stages = smem + 2 * BK * LD * sizeof(bf16);
  auto q_of = [&](int st) {
    return reinterpret_cast<bf16*>(stages + st * dkv_stage_bytes<D, BQ>());
  };
  auto l_of = [&](int st) {
    return reinterpret_cast<float*>(q_of(st) + 3 * BQ * LD);
  };
  const int off = sk - sq;
  const int nqt = (sq + BQ - 1) / BQ;
  const int i0 = first_q_tile(kv0, off, causal, BQ);
  float dk[D / 8][4], dv[D / 8][4], st[BQ / 8][4];
  zero(dk);
  zero(dv);
  if (i0 < nqt) {
    load_rows<D>(sK, LD, Kb, kv0, sk, BK);
    load_rows<D>(sV, LD, Vb, kv0, sk, BK);
    issue_q_tile<D, BQ>(q_of(0), q_of(0) + BQ * LD, l_of(0), l_of(0) + BQ,
                        Qb, dOb, Lb, Db, i0 * BQ, sq);
  }
  for (int i = i0; i < nqt; ++i) {
    const int cur = (i - i0) & 1;
    bf16* sQ = q_of(cur);
    cp_async_wait0();
    scale_own_rows<D>(sQ + 2 * BQ * LD, sQ, LD, BQ, scale_log2);
    // tile i (and its scaled q) is in for every thread, and every thread
    // is done with tile i - 1, whose stage the next copies overwrite
    __syncthreads();
    if (i + 1 < nqt)
      issue_q_tile<D, BQ>(q_of(cur ^ 1), q_of(cur ^ 1) + BQ * LD,
                          l_of(cur ^ 1), l_of(cur ^ 1) + BQ, Qb, dOb, Lb, Db,
                          (i + 1) * BQ, sq);
    kv_tile_step<D, BQ, false, false>(
        sK, sV, sQ, sQ + 2 * BQ * LD, sQ + BQ * LD, l_of(cur), l_of(cur) + BQ,
        kv0, i * BQ, sk, off, causal, scale_log2, sm_scale, dk, dv, st);
  }
  store_kv_rows<D>(dKb, dVb, dk, dv, kv0, sk);
}

// dq of the q tile at q0: loop over the kv tiles it sees, the next tile's
// copies in flight while this one computes.  A tile that sees no key
// stores zeros.
template <int D>
__device__ __forceinline__ void dq_role(
    unsigned char* smem, const bf16* Qb, const bf16* Kb, const bf16* Vb,
    const bf16* dOb, const float* Lb, const float* Db, bf16* dQb, int q0,
    int sq, int sk, int causal, float scale_log2, float sm_scale) {
  constexpr int BQ = kTile, BK = kTile, LD = D + 8;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LD;
  bf16* sKV = sdO + BQ * LD;  // stage st: K at sKV + 2 st BK LD, V after
  const int nkv = num_kv_tiles(q0, sq, sk, causal);
  load_rows<D>(sQ, LD, Qb, q0, sq, BQ);
  load_rows<D>(sdO, LD, dOb, q0, sq, BQ);
  if (nkv > 0) {
    load_rows<D>(sKV, LD, Kb, 0, sk, BK);
    load_rows<D>(sKV + BK * LD, LD, Vb, 0, sk, BK);
  }
  cp_async_commit();
  const RowStats rs = row_stats(Lb, Db, q0, sq);
  cp_async_wait0();
  __syncthreads();
  scale_rows<D>(sQ, LD, BQ, scale_log2);
  float dq[D / 8][4];
  zero(dq);
  for (int j = 0; j < nkv; ++j) {
    const int cur = j & 1;
    if (j > 0) cp_async_wait0();
    // tile j (and, at j = 0, the scaled q) is in for every thread, and
    // every thread is done with tile j - 1, whose stage is overwritten next
    __syncthreads();
    if (j + 1 < nkv) {
      bf16* nk = sKV + 2 * (cur ^ 1) * BK * LD;
      load_rows<D>(nk, LD, Kb, (j + 1) * BK, sk, BK);
      load_rows<D>(nk + BK * LD, LD, Vb, (j + 1) * BK, sk, BK);
      cp_async_commit();
    }
    const bf16* sK = sKV + 2 * cur * BK * LD;
    q_tile_step<D>(sQ, sdO, sK, sK + BK * LD, rs, j * BK, q0, sk, sk - sq,
                   causal, sm_scale, dq);
  }
  store_q_rows<D>(dQb, dq, q0, sq);
}

// Block b's work, heaviest first in both roles: rank r pairs the dk/dv
// role of kv tile r (which sees the most q tiles at r = 0 under the causal
// mask) with the dq role of q tile nqt - 1 - r (which sees the most kv
// tiles at r = 0); each rank holds its bh dk/dv blocks, then its bh dq
// blocks.  Ranks past the shorter of the two roles hold the longer one's
// blocks only.
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 2)
fa_bwd_fused_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                    const bf16* __restrict__ V, const bf16* __restrict__ dO,
                    const float* __restrict__ LSE,
                    const float* __restrict__ DELTA, bf16* __restrict__ dQ,
                    bf16* __restrict__ dK, bf16* __restrict__ dV, int bh,
                    int sq, int sk, int causal, float scale_log2,
                    float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkt = (sk + kTile - 1) / kTile;
  const int nqt = (sq + kTile - 1) / kTile;
  const long long paired = 2LL * bh * min(nkt, nqt);
  long long b = blockIdx.x;
  int rank, head;
  bool dkv;
  if (b < paired) {
    rank = static_cast<int>(b / (2 * bh));
    const int w = static_cast<int>(b % (2 * bh));
    dkv = w < bh;
    head = dkv ? w : w - bh;
  } else {
    b -= paired;
    rank = min(nkt, nqt) + static_cast<int>(b / bh);
    head = static_cast<int>(b % bh);
    dkv = nkt > nqt;
  }
  const size_t h = head;
  const bf16* Qb = Q + h * sq * D;
  const bf16* Kb = K + h * sk * D;
  const bf16* Vb = V + h * sk * D;
  const bf16* dOb = dO + h * sq * D;
  const float* Lb = LSE + h * sq;
  const float* Db = DELTA + h * sq;
  if (dkv)
    dkv_role<D, BQ>(smem, Qb, Kb, Vb, dOb, Lb, Db, dK + h * sk * D,
                    dV + h * sk * D, rank * kTile, sq, sk, causal, scale_log2,
                    sm_scale);
  else
    dq_role<D>(smem, Qb, Kb, Vb, dOb, Lb, Db, dQ + h * sq * D,
               (nqt - 1 - rank) * kTile, sq, sk, causal, scale_log2,
               sm_scale);
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
                 void* dq, void* dk, void* dv, int bh, int sq, int sk,
                 int causal, float scale_log2, float sm_scale,
                 cudaStream_t stream) {
  constexpr int BQ = bwd_bq<D>();
  constexpr size_t smem = dkv_role_smem<D, BQ>() > dq_role_smem<D>()
                              ? dkv_role_smem<D, BQ>()
                              : dq_role_smem<D>();
  auto kern = fa_bwd_fused_kernel<D, BQ>;
  if (int rc = prepare(kern, smem)) return rc;
  // the most shared memory the SM's L1 split allows, for 3 blocks an SM
  if (int rc = static_cast<int>(cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared)))
    return rc;
  const int tiles = (sk + kTile - 1) / kTile + (sq + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(bh) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dq, (bf16*)dk, (bf16*)dv, bh, sq, sk, causal, scale_log2,
      sm_scale);
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
                                      void* dq, void* dk, void* dv, int bh,
                                      int sq, int sk, int d, int causal,
                                      float scale_log2, float sm_scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fused<64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       bh, sq, sk, causal, scale_log2,
                                       sm_scale, s);
  if (d == 128) return launch_fused<128>(q, k, v, dout, lse, delta, dq, dk,
                                         dv, bh, sq, sk, causal, scale_log2,
                                         sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
