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
// reads q, k, v and writes o and lse, 152.2 MB (45.4 us), for 38.7 GFLOP
// of products (39.1 us), so it is bound by bytes, barely; the fused
// backward moves ~267 MB for ~97 GFLOP, dq ~58 and dk/dv ~77 GFLOP, all
// bound by operations (98, 59 and 78 us).  All four sit near the card's
// ridge point, so the tensor cores are the resource to keep fed.
//
// The forward (fa_fwd_kernel) is written for Hopper's asynchronous units:
//   - products: wgmma m64nNk16 bf16 -> f32 by warpgroups of 4 warps, B from
//     shared memory by descriptor (K K-major, V MN-major through the
//     transpose bit), A from registers (the pre-scaled q, and p packed
//     from the S accumulator, whose layout is the mma.sync C layout);
//   - loads: TMA boxes of 64 columns in the 128-byte swizzle, from 3-D
//     tensor maps (D, s, bh) built by the launcher (so a ragged tile's
//     rows come back zero), into a ring of 3 stages of one K and one V
//     tile, guarded by a `full` (bytes in) and an `empty` (8 consumer
//     warps out) mbarrier per stage; q the same way into two buffers; o
//     out through a swizzled staging tile and a TMA store;
//   - schedule: a persistent block per SM, 3 warpgroups: one producer
//     thread issues every TMA load, two consumer warpgroups own 64 q rows
//     each of a 128-row work item; items go heaviest causal tiles first
//     within groups of heads small enough for L2, alternating direction
//     per round (FwdItems).  A consumer issues tile j's Q K^T with tile
//     j-1's P V and runs tile j's softmax while P V flies
//     (FlashAttention-3's in-warpgroup overlap); the two warpgroups run
//     independently and fill each other's gaps;
//   - tiles and memory: kv tiles of 128 rows at D = 64 (64 at D = 128),
//     so S and O take 64 + 32 floats a thread (32 + 64); dynamic shared
//     memory is 96 KB of ring + four 16 KB q and staging tiles + 1 KB of
//     alignment at D = 64 (164,944 B; 230,480 B at D = 128, under the
//     232,448 a block may have): one block an SM;
//   - registers: 384 threads launch with 168 each; setmaxnreg leaves the
//     producer 24 and gives the consumers 240 (nvcc -Xptxas -v: no spill);
//   - softmax: exp2 by ex2.approx.ftz for p (subnormal p flushed to 0, a
//     value no sum next to the row max's 1 can see), one reciprocal per
//     row for o = acc / l.
// The dk/dv kernel (fa_bwd_dkv_kernel) follows the forward's design:
//   - work: a persistent block per SM walks (head, 128-row kv tile) items
//     in pairs of equal causal work, kv tile p with tile nkt - 1 - p of
//     the same head, dealt round robin over heads in order, so blocks get
//     the same work and a round's heads keep their Q and dO in L2
//     (DkvItems); two consumer warpgroups own 64 kv rows each, one
//     producer warpgroup feeds them;
//   - loads: an item's K and V come in once by TMA into one of two kv
//     buffers (item i + 1's load flies while item i computes) and stay
//     there as the A operands; each q tile's Q and dO (BQ = 128 rows at
//     D = 64, 64 at D = 128) come by TMA into a ring of stages (3 at
//     D = 64, 2 at D = 128), each with `full`, `scaled` and `empty`
//     mbarriers; skipped: q tiles before the item's first_q_tile, and a
//     warpgroup's tiles before its own;
//   - products, all wgmma m64nNk16 bf16 -> f32: S^T = K Q_s^T and dP^T =
//     V dO^T with both operands from shared memory (K-major), then dV +=
//     P^T dO and dK += dS^T Q with P^T and dS^T packed from the
//     accumulator into A registers (c_to_a) and dO, Q MN-major; dS^T is
//     computed while dV += P^T dO flies; dK and dV stay in registers.
//     Each group is issued and waited for inside one q tile's iteration,
//     its A registers packed there too: ptxas serialised the products
//     when a group stayed in flight across the loop's back-edge, and when
//     a group's A registers came from the previous iteration (PERF.md);
//   - why Q_s sits in shared memory: wgmma reads B only from shared
//     memory, and S^T needs q pre-scaled and rounded to bf16 as the
//     reference rounds it (scaling the f32 accumulator instead would drop
//     that rounding).  Warps 9-11 of the producer warpgroup, idle
//     otherwise, write Q_s = bf16(q * sm_scale * log2 e) from the landed
//     Q at the same swizzled offsets, and each row's -lse * log2 e (-inf
//     past sq or where lse is -inf, so p = 0 there by construction) and
//     delta; then fence.proxy.async and arrive on the stage's `scaled`
//     mbarrier.  A global pre-scaled q would cost a launch and a write and
//     a read of q (37.7 MB at GPT-2's step, ~23 us);
//   - p: exp2 by ex2.approx.ftz, as the forward's p; each pair rounded to
//     bf16 by the one packed conversion that makes P^T's A fragment, and
//     the rounded values taken back from it by bit moves for dS^T
//     (dropping a third conversion a value so cut this phase's SM clocks
//     by a third: PERF.md);
//   - masks: only on q tiles that straddle the causal diagonal; kv rows
//     past sk compute garbage of their own that is never stored;
//   - stores: dK and dV go to bf16 in the warpgroup's own rows of the K
//     and V tiles (free once its last product lands), swizzled, then one
//     TMA store per 64-column slab, which drops rows past sk; the buffer
//     is handed back to the producer when the stores have read it.  Every
//     row is written once, no atomics and no scratch: two runs are
//     bitwise equal;
//   - memory and registers: two kv buffers of 2 x 128 x D bf16 and the
//     ring: 217,192 B of dynamic shared memory at D = 64 and 231,504 B at
//     D = 128 (one block an SM); 384 threads launch with 168 registers,
//     setmaxnreg leaves the producer 40 and gives the consumers 232 (dK,
//     dV, S^T and dP^T take 192 floats a thread at either D; nvcc
//     -Xptxas -v: no spill);
//   - bound: at GPT-2's step, 77.4 GFLOP of products against 228.9 MB of
//     operands (78 against 68 us), and at Llama-3 8B's (32 heads, T =
//     4096, D = 128) 274.9 GFLOP against 202.4 MB (278 against 60 us):
//     operations, so the design keeps the tensor cores fed: operands by
//     TMA and producer warps, one warpgroup's exponentials and dS under
//     the other's products.
// The dq kernel (fa_bwd_dq_kernel) follows the same design:
//   - work: a persistent block per SM walks (head, 128-row q tile) items
//     in pairs of equal causal work, q tile nqt - 1 - p with tile p of the
//     same head, dealt round robin over heads in order, so blocks get the
//     same work and a round's heads keep their K and V in L2 (DqItems);
//     two consumer warpgroups own 64 q rows each, one producer thread
//     feeds them;
//   - loads: an item's Q and dO come in once by TMA into one of two item
//     buffers (item i + 1's go out after item i's kv tiles and fly while
//     item i computes); each kv tile's K and V (BK = 128 rows at D = 64,
//     64 at D = 128) come by TMA into a ring of stages (4 at D = 64, 2 at
//     D = 128), each with `full` and `empty` mbarriers; a warpgroup lets
//     through the kv tiles that only the other one's rows see;
//   - products, all wgmma m64nNk16 bf16 -> f32: S = Q_s K^T and dP = dO
//     V^T with Q_s and dO in A registers (read once an item by ldmatrix,
//     Q_s pre-scaled and rounded as the forward's q) and K, V K-major;
//     then dQ += dS K with dS packed from the accumulator into A registers
//     (c_to_a) and K MN-major.  p is computed while dP flies; dQ stays in
//     registers for the whole item.  Each group is issued, fed and waited
//     for inside one kv tile's iteration, as in the dk/dv kernel: ptxas
//     serialised products left in flight across a loop's back-edge, and
//     injected a warpgroup.arrive (C7519) for a wait between two groups
//     (PERF.md);
//   - arithmetic, as the Pallas dq kernel: p = exp2(s - lse log2 e) by
//     ex2.approx.ftz (0 where lse is -inf), ds = p (dp - delta) sm_scale
//     in float32 with p not rounded, ds rounded to bf16 only by the packing
//     into dQ's A fragments; the mask only on kv tiles that straddle the
//     causal diagonal or the ragged kv edge;
//   - stores: dQ goes to bf16 in the warpgroup's own rows of the item's Q
//     tile (free once read into registers), swizzled, then one TMA store
//     per 64-column slab, which drops rows past sq; the item buffer goes
//     back to the producer when both warpgroups' stores have read it.  An
//     item whose rows see no key stores zeros and never waits on the ring.
//     Every row is written once, no atomics and no scratch: two runs are
//     bitwise equal;
//   - memory and registers: two item buffers of 2 x 128 x D bf16 and the
//     ring: 197,728 B of dynamic shared memory at D = 64 and 197,696 B at
//     D = 128 (one block an SM); 384 threads launch with 168 registers,
//     setmaxnreg leaves the producer 24 and gives the consumers 240 (S,
//     dP, dQ, Q_s, dO and dS's fragments: 224 at D = 64, 208 at D = 128;
//     nvcc -Xptxas -v: no spill);
//   - bound: at GPT-2's step, 58.0 GFLOP of products against 191.1 MB of
//     operands (59 against 57 us), and at Llama-3 8B's 206.2 GFLOP against
//     168.8 MB (208 against 50 us): operations.
// The fused backward is one launch of bh * (ceil(sk/64) + ceil(sq/64))
// blocks (9216 at GPT-2's step) in two roles, none waiting on another:
//   - roles: a dk/dv role per (bh, 64-row kv tile) loops over the q tiles
//     that see its keys, dk and dv in registers (kv_tile_step: mma.sync
//     on padded rows, p kept float32); a dq role per (bh, 64-row q tile)
//     loops over the kv tiles its rows see, dq in registers
//     (q_tile_step: mma.sync on padded rows, p kept float32).  It is not
//     the dq kernel's code, but both add the k16 slices of dS K in the
//     same order: their dq have come out bitwise equal on the H100
//     (PERF.md), and chip_smoke.py holds them within FA_TOL.  Every
//     output row belongs to one block, which writes it once, as zeros
//     where a row sees no key or no query sees a key.  No atomics and no
//     scratch: two runs on equal inputs give bitwise equal dq, dk and dv
//     (the JAX package pins bit-identical replays).
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
//   - next: the dk/dv kernel's wgmma, mbarrier and TMA design for it
//     (products from shared memory, the only way to the tensor cores' full
//     rate, fed by a producer); then FlashAttention-3's one role, dq added
//     in float32 in device memory under a per-tile semaphore that fixes the
//     order of the kv tiles (deterministic, 5 products, but blocks wait on
//     each other).
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute, of the
// device query or of the tensor-map encoding); the Python wrapper raises
// when it is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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
// Hopper's asynchronous pieces, used by the forward: mbarriers, TMA tile
// loads and warpgroup products (wgmma).

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival: the phase also waits for `bytes` of TMA data
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed (the
// loop stays inside the asm, so the compiler sees no divergent branch)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a predicated arrival, with no branch around it
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// named barrier `id` of n threads (its own warps included)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// move registers between warpgroups (all 4 warps of one execute it)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// TMA: the box of `map` at (c0, c1, c2) into shared memory at dst, counted
// on `bar`; elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// TMA: shared memory at src into the box of `map` at (c0, c1, c2); the
// box's elements outside the tensor are not written.  One bulk group per
// store, committed by the same thread.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wait until this thread's TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until this thread's TMA stores are complete
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's generic writes to shared memory before later
// async-proxy (TMA) reads of it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of this warp are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wgmma's fence, commit or wait
template <int NT>
__device__ __forceinline__ void reg_fence(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[i][e])::"memory");
}

template <int NT>
__device__ __forceinline__ void reg_fence(uint32_t (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(c[i][e])::"memory");
}

// Shared-memory matrix descriptor of a wgmma B operand in the layout a
// SWIZZLE_128B TMA box writes: rows of 128 B (64 bf16), 8-row atoms of
// 1024 B, the 16-byte chunks of row r XOR-swizzled by r % 8, every tile
// 1024-B aligned.  Fields: start address >> 4 (bits 0-13), leading byte
// offset >> 4 (16-29: the next 64-column slab of an MN-major operand;
// unused by a K-major one), stride byte offset >> 4 (32-45: the next
// 8-row atom, 1024 B), layout 1 = 128-byte swizzle (62-63).  A K-major
// operand steps its k16 slices by 32 B inside the 128-B row; the swizzle
// is applied to the address bits, so the base offset (49-51) stays 0.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (m64 x N, f32) (+)= a (m64 x k16 bf16 in registers) * B (k16 x N bf16
// in shared memory, by descriptor; kTransB 0: K-major, 1: MN-major);
// accumulate 0 overwrites d.  Per warp w of the warpgroup, d holds rows
// 16w + (g | g+8), columns 8i + 2t, +1 as d[i][0..3] and a holds the
// mma.sync A fragment of rows 16w..16w+15: the C and A layouts above.
#define WG_ACC4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

template <int kTransB>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        WG_ACC4(0), WG_ACC4(1), WG_ACC4(2), WG_ACC4(3),
        WG_ACC4(4), WG_ACC4(5), WG_ACC4(6), WG_ACC4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        WG_ACC4(0), WG_ACC4(1), WG_ACC4(2), WG_ACC4(3),
        WG_ACC4(4), WG_ACC4(5), WG_ACC4(6), WG_ACC4(7),
        WG_ACC4(8), WG_ACC4(9), WG_ACC4(10), WG_ACC4(11),
        WG_ACC4(12), WG_ACC4(13), WG_ACC4(14), WG_ACC4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

// d (m64 x N, f32) (+)= A (m64 x k16) * B (k16 x N), bf16, both from shared
// memory by descriptor and both K-major (the dk/dv kernel's S^T = K Q_s^T
// and dP^T = V dO^T, whose A tiles stay in shared memory for a whole item)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        WG_ACC4(0), WG_ACC4(1), WG_ACC4(2), WG_ACC4(3),
        WG_ACC4(4), WG_ACC4(5), WG_ACC4(6), WG_ACC4(7)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        WG_ACC4(0), WG_ACC4(1), WG_ACC4(2), WG_ACC4(3),
        WG_ACC4(4), WG_ACC4(5), WG_ACC4(6), WG_ACC4(7),
        WG_ACC4(8), WG_ACC4(9), WG_ACC4(10), WG_ACC4(11),
        WG_ACC4(12), WG_ACC4(13), WG_ACC4(14), WG_ACC4(15)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef WG_ACC4

template <int N, int kTransB>
__device__ __forceinline__ void wgmma(float (&d)[N / 8][4],
                                      const uint32_t (&a)[4], uint64_t desc,
                                      int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma: N is 64 or 128");
  if constexpr (N == 64)
    wgmma_n64<kTransB>(d, a, desc, accumulate);
  else
    wgmma_n128<kTransB>(d, a, desc, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, accumulate);
  else
    wgmma_ss_n128(d, da, db, accumulate);
}

// The forward's shapes: a block takes 128 q rows, two consumer warpgroups
// of 64, and one producer warpgroup; kv tiles of 128 rows at D = 64 and 64
// at D = 128 (S and O then take 64 + 32 and 32 + 64 floats a thread); a
// stage holds one K and one V tile (32 KB either way); two q tiles and two
// output staging tiles take D / 4 KB each; all in 64-column slabs of the
// 128-byte swizzle.  Registers: the launch gives 168 a thread; the
// producer gives back all but 24 and the consumers take 240.
constexpr int kFwdThreads = 384;
constexpr int kFwdBQ = 128;
constexpr int kFwdStages = 3;
constexpr int kFwdProducerRegs = 24;
constexpr int kFwdConsumerRegs = 240;

template <int D>
__host__ __device__ constexpr int fwd_bk() { return D == 64 ? 128 : 64; }
template <int D>
__host__ __device__ constexpr int fwd_stage_bytes() {
  return 2 * fwd_bk<D>() * D * 2;
}
template <int D>
__host__ __device__ constexpr int fwd_q_bytes() { return kFwdBQ * D * 2; }
template <int D>
__host__ __device__ constexpr size_t fwd_smem() {  // + 1024: align the ring
  return 1024 + kFwdStages * fwd_stage_bytes<D>() + 4 * fwd_q_bytes<D>() +
         (2 * kFwdStages + 4) * sizeof(uint64_t);
}

// kv tiles of BK rows seen by the 64 rows from r0 (causal: up to the last
// row's diagonal, the rows past sq left out; all otherwise); 0 when r0 is
// past sq
__device__ __forceinline__ int fwd_num_kv(int r0, int sq, int sk, int causal,
                                          int BK) {
  if (r0 >= sq) return 0;
  const int kv_end = causal ? min(sk, min(r0 + 64, sq) + sk - sq) : sk;
  return kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
}

// S = Q K^T for one kv tile: A = the pre-scaled q fragments, B = the K
// tile (K-major), k16 slices across the 64-column slabs
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 8][4],
                                         const uint32_t (&qa)[D / 16][4],
                                         const unsigned char* sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma<BK, 0>(s, qa[kk],
                 sw128_desc(sK + (kk / 4) * BK * 128 + (kk % 4) * 32, 16),
                 kk > 0);
}

// O += P V for one kv tile: A = p in registers, B = the V tile (MN-major:
// its 64-column slabs are the leading byte offset apart, its 8-row atoms
// 1024 B)
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 8][4],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const unsigned char* sV) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma<D, 1>(acc, pa[kk], sw128_desc(sV + kk * 16 * 128, BK * 128), 1);
}

// a consumer warp is done with a stage: its lane 0 arrives
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  mbar_arrive_if(bar, (threadIdx.x & 31) == 0);
}

// 2^x by the special-function unit, subnormal results flushed to 0: the
// softmax's p, which never needs a value below 2^-126 next to its row
// max's 1
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one kv tile at kv0, in place on the S accumulator:
// mask (only a tile that straddles the diagonal or the ragged edge), the
// new row max over the quad, alpha = exp2(m_old - m_new), p = exp2(s -
// m_new) left in s, l = l * alpha + rowsum(p).  A row that has seen no key
// yet (m = -1e30) takes its p against 0, so its masked entries give 0 and
// not exp2(0); elsewhere a masked entry gives exp2(-1e30 - m) = 0.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int kv0,
                                             int r0, int row_a, int sk,
                                             int off, int causal) {
  const int t = threadIdx.x & 3;
  if (kv0 + BK > sk || (causal && kv0 + BK - 1 > r0 + off)) {
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = row_a + (e >> 1) * 8;
        if (col >= sk || (causal && col > row + off)) s[nt][e] = kNegInf;
      }
  }
  float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f}, base[2];
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
    base[h] = mx[h] <= kNegInf ? 0.f : mx[h];
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2_ftz(s[nt][e] - base[e >> 1]);
      s[nt][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
}

// q <- bf16(f32(q) * scale_log2) into the A fragments of Q K^T for the 16
// rows of this warp from row0 of the q tile in shared memory (64-column
// slabs of 128 rows in the 128-byte swizzle, as TMA wrote them): ldmatrix,
// as ld_a, with each 16-byte chunk's column XOR-ed by its row
template <int D>
__device__ __forceinline__ void read_q(uint32_t (&qa)[D / 16][4],
                                       const unsigned char* sQ, int row0,
                                       float scale_log2) {
  const int lane = threadIdx.x & 31, r = row0 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = (kk % 4) * 2 + (lane >> 4);
    ldsm_x4(qa[kk], reinterpret_cast<const bf16*>(
                        sQ + (kk / 4) * kFwdBQ * 128 + r * 128 +
                        ((c ^ (r & 7)) << 4)));
#pragma unroll
    for (int e = 0; e < 4; ++e) qa[kk][e] = scale_pair(qa[kk][e], scale_log2);
  }
}

// The work items of a launch are the (bh, 128-row q tile) pairs (at most
// 2^31 - 2^16, checked at launch, so no index below overflows).  They go in groups of gh heads that span
// two rounds of the G blocks (gh = 2 G / nqt), so the K and V of the heads
// in flight stay in L2; inside a group, heaviest causal tiles first.  Block
// b takes item i * G + b in even rounds i and i * G + G - 1 - b in odd
// ones, so a block's heavy item of one round meets a light one in the
// next.
struct FwdItems {
  int nbh, nqt, total, gh;
  __device__ FwdItems(int nbh_, int nqt_)
      : nbh(nbh_), nqt(nqt_), total(nbh_ * nqt_),
        gh(max(1, 2 * static_cast<int>(gridDim.x) / nqt_)) {}
  // item i of this block: false past the last one, else its head and
  // first q row
  __device__ bool get(int i, int& bh, int& q0) const {
    const int G = gridDim.x, b = blockIdx.x;
    const int w = i * G + ((i & 1) ? G - 1 - b : b);
    if (w >= total) return false;
    const int group = w / (gh * nqt), in = w - group * gh * nqt;
    const int heads = min(gh, nbh - group * gh);  // the last group may be short
    bh = group * gh + in % heads;
    q0 = (nqt - 1 - in / heads) * kFwdBQ;
    return true;
  }
};

// Persistent: one block per SM walks its work items (FwdItems).  Warpgroup
// 2 is the producer: one thread issues the TMA loads of each item's q tile
// (two buffers, each with its own `full` and `empty` mbarriers; item i + 1's
// q goes out before item i's kv tiles) and of each kv tile's K and V into a
// ring of kFwdStages stages that runs on across items, a `full` mbarrier
// per stage counting the bytes in and an `empty` one counting the 8
// consumer warps out.  Warpgroups 0 and 1 are consumers of 64 q rows each.
// A consumer reads its q rows once per item with ldmatrix, pre-scales them
// in registers and keeps them as wgmma A fragments (so no generic write to
// shared memory precedes an async-proxy read of the operands), and runs
// FlashAttention-3's in-warpgroup overlap: tile j's S = Q K^T and tile
// j-1's O += P V are issued together, tile j's softmax runs while P V is
// in flight, and O is rescaled after it lands.  The two warpgroups run
// independently, so one's softmax and per-item work overlap the other's
// products.  m, l and O stay in registers in the accumulator layout (the
// mma.sync C layout, so c_to_a packs p into A).  O goes out through a
// swizzled staging tile and one TMA store per warpgroup, which also drops
// the rows past sq.  Role indices go through __shfl_sync so that the
// compiler knows them warp-uniform: a wgmma on a path it thinks divergent
// is serialised.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
fa_fwd_kernel(const __grid_constant__ CUtensorMap tmQ,
              const __grid_constant__ CUtensorMap tmK,
              const __grid_constant__ CUtensorMap tmV,
              const __grid_constant__ CUtensorMap tmO,
              float* __restrict__ LSE, int nbh, int sq, int sk, int causal,
              float scale_log2) {
  constexpr int BK = fwd_bk<D>(), S = kFwdStages;
  constexpr int kStage = fwd_stage_bytes<D>();  // K's slabs, then V's
  constexpr int kSlab = BK * 128;               // a 64-column slab of K or V
  constexpr int kQSlab = kFwdBQ * 128;          // ... of the q or O tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = ring + S * kStage;  // two q tiles: item i in i % 2
  unsigned char* sO = sQ + 2 * fwd_q_bytes<D>();  // two staging tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sO + 2 * fwd_q_bytes<D>());
  uint64_t* empty = full + S;
  uint64_t* q_full = empty + S;  // per q buffer
  uint64_t* q_empty = q_full + 2;

  const FwdItems items(nbh, (sq + kFwdBQ - 1) / kFwdBQ);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer; no wait counts on a loop's length
    regs_dec<kFwdProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      tma_prefetch(&tmQ);
      tma_prefetch(&tmK);
      tma_prefetch(&tmV);
      // the q tile of item i + 1 goes out before the kv tiles of item i
      auto load_q = [&](int i, int bh, int q0) {
        const int b = i & 1;
        if (i >= 2) mbar_wait(&q_empty[b], ((i >> 1) - 1) & 1);
        mbar_arrive_expect_tx(&q_full[b], fwd_q_bytes<D>());
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(sQ + b * fwd_q_bytes<D>() + c * kQSlab, &tmQ,
                      &q_full[b], 64 * c, q0, bh);
      };
      int it = 0;  // kv tiles issued so far: the ring position
      int bh, q0, bh_next, q0_next;
      bool more = items.get(0, bh, q0);
      if (more) load_q(0, bh, q0);
      for (int i = 0; more; ++i, bh = bh_next, q0 = q0_next) {
        more = items.get(i + 1, bh_next, q0_next);
        if (more) load_q(i + 1, bh_next, q0_next);
        const int nkv = max(fwd_num_kv(q0, sq, sk, causal, BK),
                            fwd_num_kv(q0 + 64, sq, sk, causal, BK));
        for (int j = 0; j < nkv; ++j, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
          unsigned char* dst = ring + st * kStage;
          mbar_arrive_expect_tx(&full[st], kStage);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_3d(dst + c * kSlab, &tmK, &full[st], 64 * c, j * BK,
                        bh);
            tma_load_3d(dst + kStage / 2 + c * kSlab, &tmV, &full[st],
                        64 * c, j * BK, bh);
          }
        }
      }
    }
    return;
  }
  regs_inc<kFwdConsumerRegs>();

  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const int rw = wg * 64 + warp * 16 + g;  // this thread's rows in a tile
  const bool leader = (threadIdx.x & 127) == 0;  // issues the O stores
  const int my_group = 1 + wg;  // named barrier of this warpgroup
  uint32_t qa[D / 16][4];
  float acc[D / 8][4], s[BK / 8][4];
  uint32_t pa[BK / 16][4];
  zero(s);
  int it = 0;  // kv tiles consumed so far: the ring position
  int bh, q0;
  for (int i = 0; items.get(i, bh, q0); ++i) {
    const int r0 = q0 + wg * 64;  // this warpgroup's first row
    const int row_a = q0 + rw;    // this thread's rows: row_a, +8
    const int nkv = max(fwd_num_kv(q0, sq, sk, causal, BK),
                        fwd_num_kv(q0 + 64, sq, sk, causal, BK));
    const int nw = fwd_num_kv(r0, sq, sk, causal, BK);
    mbar_wait(&q_full[i & 1], (i >> 1) & 1);
    read_q<D>(qa, sQ + (i & 1) * fwd_q_bytes<D>(), wg * 64 + warp * 16,
              scale_log2);
    release(&q_empty[i & 1]);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    zero(acc);
    if (nw > 0) {  // tile 0: S, softmax, p
      mbar_wait(&full[it % S], (it / S) & 1);
      reg_fence(s);
      wgmma_fence();
      issue_qk<D, BK>(s, qa, ring + (it % S) * kStage);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      softmax_tile<BK>(s, m, l, alpha, 0, r0, row_a, sk, off, causal);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) c_to_a(pa[kk], s, kk);
    }
    for (int j = 1; j < nw; ++j) {
      const int st = (it + j) % S, prev = (it + j - 1) % S;
      mbar_wait(&full[st], ((it + j) / S) & 1);
      reg_fence(acc);
      reg_fence(pa);
      wgmma_fence();
      issue_qk<D, BK>(s, qa, ring + st * kStage);
      wgmma_commit();
      issue_pv<D, BK>(acc, pa, ring + prev * kStage + kStage / 2);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile j is in; P V of tile j-1 may still fly
      reg_fence(s);
      softmax_tile<BK>(s, m, l, alpha, j * BK, r0, row_a, sk, off, causal);
      wgmma_wait<0>();  // P V of tile j-1 is in: its stage is free
      reg_fence(acc);
      reg_fence(pa);
      release(&empty[prev]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) c_to_a(pa[kk], s, kk);
    }
    if (nw > 0) {  // P V of the last tile
      const int st = (it + nw - 1) % S;
      reg_fence(acc);
      reg_fence(pa);
      wgmma_fence();
      issue_pv<D, BK>(acc, pa, ring + st * kStage + kStage / 2);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      release(&empty[st]);
    }
    // tiles only the other warpgroup sees: let them through the ring
    for (int j = nw; j < nkv; ++j) {
      mbar_wait(&full[(it + j) % S], ((it + j) / S) & 1);
      release(&empty[(it + j) % S]);
    }
    it += nkv;

    // O = acc / l into staging tile i % 2 (this warpgroup's 64 rows, 16-
    // byte chunks XOR-swizzled by row as TMA expects), then one TMA store;
    // lse straight to device memory.  Before the barrier the leader waits
    // until item i - 1's store has read its tile, which item i + 1 writes.
    unsigned char* sOi = sO + (i & 1) * fwd_q_bytes<D>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const float ls = l[h] > 0.f ? l[h] : 1.f, inv = 1.f / ls;
      const int r = rw + h * 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(sOi + (dt / 8) * kQSlab + r * 128 +
                                     (((dt % 8) ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16(acc[dt][2 * h] * inv, acc[dt][2 * h + 1] * inv);
      const int row = row_a + h * 8;
      if (t == 0 && row < sq)
        LSE[static_cast<size_t>(bh) * sq + row] =
            l[h] > 0.f ? m[h] * kInvLog2e + logf(ls) : -INFINITY;
    }
    fence_proxy_async();
    if (leader) tma_store_wait_read();
    named_sync(my_group, 128);
    if (leader && r0 < sq) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_3d(&tmO, sOi + c * kQSlab + wg * 64 * 128, 64 * c, r0, bh);
    }
  }
  if (leader) tma_store_wait();
}

// ----------------------------------------------- backward: one kv tile's work
// for a 64-row q tile, the fused kernel's dq role: each thread's two rows'
// lse (in log2 units) and delta, the product of one kv tile (S, dP, dS, dQ
// += dS K) and the store.

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

// ------------------------------------------------ backward: one q tile's work
// for a 64-row kv tile: S^T, P^T, dV, dP^T, dS^T and dK, the fused kernel's
// dk/dv role.  Leaves dS^T (f32, C layout) in `st`.  S^T takes the
// pre-scaled q from `sQs`; p stays float32 before dS, as the Pallas fused
// kernel's pT.

template <int D, int BQ>
__device__ __forceinline__ void kv_tile_step(
    const bf16* sK, const bf16* sV, const bf16* sQ, const bf16* sQs,
    const bf16* sdO, const float* sL, const float* sD, int kv0, int q0,
    int sk, int off, int causal, float sm_scale, float (&dk)[D / 8][4],
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
      ld_b_n(b, sQs, LD, np * 16, kb * 16, lane);
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
      st[nt][e] = isfinite(L) ? exp2f(sv - L * kLog2e) : 0.f;
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

// ---------------------------------------------------------- backward: dk/dv
// Hopper's dk/dv kernel (the source note above): a persistent block per
// SM walks (head, 128-row kv tile) items.  Warpgroup 2 feeds: its thread
// 256 issues every TMA load, each item's K and V into one of two kv
// buffers and each q tile's Q and dO into a ring of stages; its warps 9-11
// write each stage's pre-scaled Q_s = bf16(q * sm_scale * log2 e) beside Q,
// and the stage's -lse * log2 e and delta.  Warpgroups 0 and 1 own 64 kv
// rows each and issue the four products of every q tile with wgmma.

constexpr int kDkvThreads = 384;
constexpr int kDkvBK = 128;  // kv rows of an item, 64 per consumer warpgroup
constexpr int kDkvHelpers = 96;  // warps 9-11: Q_s, lse and delta
constexpr int kDkvProducerRegs = 40;
constexpr int kDkvConsumerRegs = 232;

// Hooks for fa_bwd_variants.py's timed build, which sums a consumer
// warpgroup's SM clocks between the stamps of its q tiles' phases; empty
// here
#define DKV_CLOCKS_BEGIN
#define DKV_STAMP(k)
#define DKV_CLOCKS_END

// The dk/dv kernel's shapes: q tiles of BQ rows (128 at D = 64, where S^T
// and dP^T then take 64 floats a thread each; 64 at D = 128) in a ring of
// S stages, each Q, dO and Q_s (64-column slabs of the 128-byte swizzle)
// and BQ floats each of -lse * log2 e and delta; two kv buffers of K then
// V (128 rows), which also stage dK and dV for their TMA stores.
template <int D>
struct Dkv {
  static constexpr int BQ = D == 64 ? 128 : 64;
  static constexpr int S = D == 64 ? 3 : 2;
  static constexpr int kKV = kDkvBK * D * 2;   // K (or V) of an item
  static constexpr int kTile = BQ * D * 2;     // a Q, dO or Q_s tile
  static constexpr int kStage = 3 * kTile;
  static constexpr size_t smem =  // + 1024: align the tiles
      1024 + 4 * kKV + S * (kStage + 2 * BQ * sizeof(float)) +
      (3 * S + 4) * sizeof(uint64_t);
};
static_assert(Dkv<64>::smem <= 232448 && Dkv<128>::smem <= 232448,
              "the dk/dv kernel's shared memory exceeds a block's");

// The work items of the dk/dv kernel are the (bh, 128-row kv tile) pairs.
// Under the causal mask kv tile t sees about nkt - t q tiles, so the items
// go in pairs of one head's tiles p and nkt - 1 - p, whose work is about
// the same for every p (an odd nkt's middle tile alone), the heavier
// first.  Block b takes pairs b, b + G, b + 2G, ...: every block gets
// nearly the same work, and a round of G pairs spans G / npairs
// consecutive heads, whose Q and dO stay in L2.
struct DkvItems {
  int nkt, npairs, total;  // total: pairs
  __device__ DkvItems(int nbh, int nkt_)
      : nkt(nkt_), npairs((nkt_ + 1) / 2), total(nbh * ((nkt_ + 1) / 2)) {}
  // item i of this block: false past the last one, else its head and
  // first kv row
  __device__ bool get(int i, int& bh, int& kv0) const {
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const int head = w / npairs, p = w - head * npairs;
      const int n = 2 * p + 1 == nkt ? 1 : 2;
      if (i < n) {
        bh = head;
        kv0 = (i == 0 ? p : nkt - 1 - p) * kDkvBK;
        return true;
      }
      i -= n;
    }
    return false;
  }
};

// first q tile whose rows can see kv row kv0 (causal), 0 otherwise
__device__ __forceinline__ int first_q_tile(int kv0, int off, int causal,
                                            int BQ) {
  return causal ? max(0, kv0 - off) / BQ : 0;
}

// S^T = K Q_s^T (or dP^T = V dO^T) for one q tile: A = this warpgroup's 64
// rows of the K (V) tile, B = the Q_s (dO) tile, both K-major, k16 slices
// across the 64-column slabs
template <int D, int BQ>
__device__ __forceinline__ void issue_kq(float (&d)[BQ / 8][4],
                                         const unsigned char* sA,
                                         const unsigned char* sB) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BQ>(d,
                 sw128_desc(sA + (kk / 4) * kDkvBK * 128 + (kk % 4) * 32, 16),
                 sw128_desc(sB + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16),
                 kk > 0);
}

// dV += P^T dO (or dK += dS^T Q) for one q tile: A = the packed rows in
// registers, B = the dO (Q) tile, MN-major (its 64-column slabs the
// leading byte offset apart)
template <int D, int BQ>
__device__ __forceinline__ void issue_acc(float (&d)[D / 8][4],
                                          const uint32_t (&a)[BQ / 16][4],
                                          const unsigned char* sB) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    wgmma<D, 1>(d, a[kk], sw128_desc(sB + kk * 16 * 128, BQ * 128), 1);
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
fa_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tmQ,
                  const __grid_constant__ CUtensorMap tmdO,
                  const __grid_constant__ CUtensorMap tmK,
                  const __grid_constant__ CUtensorMap tmV,
                  const __grid_constant__ CUtensorMap tmdK,
                  const __grid_constant__ CUtensorMap tmdV,
                  const float* __restrict__ LSE,
                  const float* __restrict__ DELTA, int nbh, int sq, int sk,
                  int causal, float scale_log2, float sm_scale) {
  using P = Dkv<D>;
  constexpr int BQ = P::BQ, S = P::S;
  constexpr int kKSlab = kDkvBK * 128;  // a 64-column slab of K, V, dK, dV
  constexpr int kQSlab = BQ * 128;      // ... of Q, dO, Q_s
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv =  // buffer b: K at kv + 2 b kKV, V after it
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = kv + 4 * P::kKV;  // stage s: Q, dO, Q_s
  float* stats = reinterpret_cast<float*>(ring + S * P::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + S * 2 * BQ);
  uint64_t* scaled = full + S;  // Q_s, -lse log2 e and delta written
  uint64_t* empty = scaled + S;
  uint64_t* kv_full = empty + S;
  uint64_t* kv_empty = kv_full + 2;  // the buffer's dK and dV stores read

  const DkvItems items(nbh, (sk + kDkvBK - 1) / kDkvBK);
  const int nqt = (sq + BQ - 1) / BQ;
  const int off = sk - sq;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&scaled[s], kDkvHelpers);
      mbar_init(&empty[s], 8);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kv_full[b], 1);
      mbar_init(&kv_empty[b], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer; no wait counts on a loop's length
    regs_dec<kDkvProducerRegs>();
    int it = 0, bh, kv0;  // it: q tiles issued so far, the ring position
    if (threadIdx.x == 2 * 128) {
      tma_prefetch(&tmQ);
      tma_prefetch(&tmdO);
      tma_prefetch(&tmK);
      tma_prefetch(&tmV);
      for (int i = 0; items.get(i, bh, kv0); ++i) {
        const int b = i & 1;
        if (i >= 2) mbar_wait(&kv_empty[b], ((i >> 1) - 1) & 1);
        unsigned char* sK = kv + b * 2 * P::kKV;
        mbar_arrive_expect_tx(&kv_full[b], 2 * P::kKV);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(sK + c * kKSlab, &tmK, &kv_full[b], 64 * c, kv0, bh);
          tma_load_3d(sK + P::kKV + c * kKSlab, &tmV, &kv_full[b], 64 * c,
                      kv0, bh);
        }
        for (int qt = first_q_tile(kv0, off, causal, BQ); qt < nqt;
             ++qt, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          unsigned char* dst = ring + s * P::kStage;
          mbar_arrive_expect_tx(&full[s], 2 * P::kTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_3d(dst + c * kQSlab, &tmQ, &full[s], 64 * c, qt * BQ,
                        bh);
            tma_load_3d(dst + P::kTile + c * kQSlab, &tmdO, &full[s], 64 * c,
                        qt * BQ, bh);
          }
        }
      }
    } else if (threadIdx.x >= 3 * 128 - kDkvHelpers) {
      // Q_s from the landed Q, 16 bytes a step at the same offset (both
      // tiles are 1024-B aligned, so one swizzle serves both), and the
      // rows' -lse * log2 e (-inf past sq or where lse is -inf, so p = 0
      // there) and delta (0 past sq); their loads go out before the wait
      constexpr int kRows = (BQ + kDkvHelpers - 1) / kDkvHelpers;
      const int h = threadIdx.x - (3 * 128 - kDkvHelpers);
      for (int i = 0; items.get(i, bh, kv0); ++i) {
        const float* Lb = LSE + static_cast<size_t>(bh) * sq;
        const float* Db = DELTA + static_cast<size_t>(bh) * sq;
        for (int qt = first_q_tile(kv0, off, causal, BQ); qt < nqt;
             ++qt, ++it) {
          const int s = it % S;
          float nl[kRows], dl[kRows];
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            const int row = qt * BQ + h + u * kDkvHelpers;
            const bool ok = h + u * kDkvHelpers < BQ && row < sq;
            const float L = ok ? Lb[row] : -INFINITY;
            nl[u] = isfinite(L) ? -(L * kLog2e) : -INFINITY;
            dl[u] = ok ? Db[row] : 0.f;
          }
          mbar_wait(&full[s], (it / S) & 1);
          float* sNL = stats + s * 2 * BQ;
#pragma unroll
          for (int u = 0; u < kRows; ++u)
            if (h + u * kDkvHelpers < BQ) {
              sNL[h + u * kDkvHelpers] = nl[u];
              sNL[BQ + h + u * kDkvHelpers] = dl[u];
            }
          const unsigned char* sQ = ring + s * P::kStage;
          unsigned char* sQs = ring + s * P::kStage + 2 * P::kTile;
          for (int c = h; c < P::kTile / 16; c += kDkvHelpers) {
            uint4 v = *reinterpret_cast<const uint4*>(sQ + 16 * c);
            v.x = scale_pair(v.x, scale_log2);
            v.y = scale_pair(v.y, scale_log2);
            v.z = scale_pair(v.z, scale_log2);
            v.w = scale_pair(v.w, scale_log2);
            *reinterpret_cast<uint4*>(sQs + 16 * c) = v;
          }
          fence_proxy_async();  // Q_s is read next by wgmma (async proxy)
          mbar_arrive_if(&scaled[s], true);
        }
      }
    }
    return;
  }
  regs_inc<kDkvConsumerRegs>();

  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp * 16 + g;  // this thread's rows of the 64: rw, rw + 8
  const bool leader = (threadIdx.x & 127) == 0;  // issues the dK, dV stores
  float dk[D / 8][4], dv[D / 8][4], sT[BQ / 8][4], dpT[BQ / 8][4];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
  int it = 0, bh, kv0;
  DKV_CLOCKS_BEGIN;
  int pend = -1;  // kv buffer whose stores this warpgroup has not seen read
  // the stores of the previous item have read buffer `pend`: the producer
  // may load the next item but one into it
  auto free_pending = [&]() {
    if (pend >= 0) {
      if (leader) tma_store_wait_read();
      mbar_arrive_if(&kv_empty[pend], leader);
      pend = -1;
    }
  };
  for (int i = 0; items.get(i, bh, kv0); ++i) {
    const int b = i & 1;
    unsigned char* sK = kv + b * 2 * P::kKV;
    unsigned char* sV = sK + P::kKV;
    const int kvw = kv0 + wg * 64;  // this warpgroup's first kv row
    const int my_first = min(first_q_tile(kvw, off, causal, BQ), nqt);
    zero(dk);
    zero(dv);
    mbar_wait(&kv_full[b], (i >> 1) & 1);
    // q tiles only the other warpgroup's rows see: let them through
    for (int qt = first_q_tile(kv0, off, causal, BQ); qt < my_first;
         ++qt, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      release(&empty[s]);
      free_pending();
    }
    for (int qt = my_first; qt < nqt; ++qt, ++it) {
      const int s = it % S;
      const unsigned char* sQ = ring + s * P::kStage;
      const unsigned char* sdO = sQ + P::kTile;
      const float* sNL = stats + s * 2 * BQ;
      DKV_STAMP(0);
      mbar_wait(&full[s], (it / S) & 1);
      mbar_wait(&scaled[s], (it / S) & 1);
      DKV_STAMP(1);
      reg_fence(sT);
      reg_fence(dpT);
      wgmma_fence();
      issue_kq<D, BQ>(sT, sK + wg * 64 * 128, sQ + 2 * P::kTile);
      wgmma_commit();
      issue_kq<D, BQ>(dpT, sV + wg * 64 * 128, sdO);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T may still fly
      reg_fence(sT);
      DKV_STAMP(2);
      // p^T = bf16(exp2(s^T - lse log2 e)), exp2 as the forward's p; the
      // causal mask only on a tile that straddles the diagonal (rows past
      // sk are never stored)
      const int q0 = qt * BQ;
      const bool masked = causal && kvw + 63 > q0 + off;
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 nl =
            *reinterpret_cast<const float2*>(sNL + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = sT[nt][e];
          if (masked && kvw + rw + (e >> 1) * 8 >
                            q0 + nt * 8 + 2 * t + (e & 1) + off)
            sv = kNegInf;
          sT[nt][e] = ex2_ftz(sv + ((e & 1) ? nl.y : nl.x));
        }
      }
      // P^T's A fragments, each pair of p rounded to bf16 by one packed
      // conversion; dS^T takes the rounded p back from them by bit moves
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        c_to_a(pa[kk], sT, kk);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          sT[2 * kk + (r >> 1)][2 * (r & 1)] =
              __uint_as_float(pa[kk][r] << 16);
          sT[2 * kk + (r >> 1)][2 * (r & 1) + 1] =
              __uint_as_float(pa[kk][r] & 0xffff0000u);
        }
      }
      DKV_STAMP(3);
      wgmma_wait<0>();  // dP^T is in
      reg_fence(dpT);
      reg_fence(dv);
      DKV_STAMP(4);
      wgmma_fence();
      issue_acc<D, BQ>(dv, pa, sdO);
      wgmma_commit();
      // dS^T = p^T (dP^T - delta) sm_scale while dV += P^T dO flies
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const float2 dl =
            *reinterpret_cast<const float2*>(sNL + BQ + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sT[nt][e] =
              sT[nt][e] * (dpT[nt][e] - ((e & 1) ? dl.y : dl.x)) * sm_scale;
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) c_to_a(da[kk], sT, kk);
      reg_fence(dk);
      wgmma_fence();
      issue_acc<D, BQ>(dk, da, sQ);
      wgmma_commit();
      DKV_STAMP(5);
      wgmma_wait<0>();  // both in: the stage is free
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pa);
      reg_fence(da);
      DKV_STAMP(6);
      release(&empty[s]);
      free_pending();
    }
    free_pending();  // an item with no q tile of this warpgroup's

    // dK and dV as bf16 into this warpgroup's rows of the K and V tiles
    // (its products are done with them), 16-byte chunks XOR-swizzled by row
    // as TMA expects, then one TMA store per slab, which drops rows past sk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + rw + h * 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int o = (dt / 8) * kKSlab + r * 128 +
                      (((dt % 8) ^ (r & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(sK + o) =
            pack_bf16(dk[dt][2 * h], dk[dt][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(sV + o) =
            pack_bf16(dv[dt][2 * h], dv[dt][2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (leader && kvw < sk) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_store_3d(&tmdK, sK + c * kKSlab + wg * 64 * 128, 64 * c, kvw, bh);
        tma_store_3d(&tmdV, sV + c * kKSlab + wg * 64 * 128, 64 * c, kvw, bh);
      }
    }
    pend = b;
    DKV_STAMP(7);
  }
  if (leader) tma_store_wait();
  DKV_CLOCKS_END;
}

// ------------------------------------------------------------- backward: dq
// Hopper's dq kernel (the source note above): a persistent block per SM
// walks (head, 128-row q tile) items.  Warpgroup 2 feeds: its thread 256
// issues every TMA load, each item's Q and dO into one of two item buffers
// and each kv tile's K and V into a ring of stages.  Warpgroups 0 and 1
// own 64 q rows each and issue the three products of every kv tile with
// wgmma.

constexpr int kDqThreads = 384;
constexpr int kDqBQ = 128;  // q rows of an item, 64 per consumer warpgroup
constexpr int kDqProducerRegs = 24;
constexpr int kDqConsumerRegs = 240;

// Hooks for fa_bwd_variants.py's timed build, which sums a consumer
// warpgroup's SM clocks between the stamps of its kv tiles' phases; empty
// here
#define DQ_CLOCKS_BEGIN
#define DQ_STAMP(k)
#define DQ_CLOCKS_END

// The dq kernel's shapes: kv tiles of BK rows (128 at D = 64, where S and
// dP then take 64 floats a thread each; 64 at D = 128) in a ring of kRing
// stages, each a K then a V tile; two item buffers of a Q then a dO tile
// (128 rows); all in 64-column slabs of the 128-byte swizzle.
template <int D>
struct Dq {
  static constexpr int BK = D == 64 ? 128 : 64;
  static constexpr int kRing = D == 64 ? 4 : 2;
  static constexpr int kItem = kDqBQ * D * 2;    // a Q or dO tile
  static constexpr int kStage = 2 * BK * D * 2;  // a K and a V tile
  static constexpr size_t smem =  // + 1024: align the tiles
      1024 + 4 * kItem + kRing * kStage + (2 * kRing + 4) * sizeof(uint64_t);
};
static_assert(Dq<64>::smem <= 232448 && Dq<128>::smem <= 232448,
              "the dq kernel's shared memory exceeds a block's");

// The work items of the dq kernel are the (bh, 128-row q tile) pairs.
// Under the causal mask q tile t sees about t + 1 kv tiles, so the items
// go in pairs of one head's tiles nqt - 1 - p and p, whose work is about
// the same for every p (an odd nqt's middle tile alone), the heavier
// first.  Block b takes pairs b, b + G, b + 2G, ...: every block gets
// nearly the same work, and a round of G pairs spans G / npairs
// consecutive heads, whose K and V stay in L2.
struct DqItems {
  int nqt, npairs, total;  // total: pairs
  __device__ DqItems(int nbh, int nqt_)
      : nqt(nqt_), npairs((nqt_ + 1) / 2), total(nbh * ((nqt_ + 1) / 2)) {}
  // item i of this block: false past the last one, else its head and
  // first q row
  __device__ bool get(int i, int& bh, int& q0) const {
    for (int pair = blockIdx.x; pair < total; pair += gridDim.x) {
      const int head = pair / npairs, p = pair - head * npairs;
      const int n = 2 * p + 1 == nqt ? 1 : 2;
      if (i < n) {
        bh = head;
        q0 = (i == 0 ? nqt - 1 - p : p) * kDqBQ;
        return true;
      }
      i -= n;
    }
    return false;
  }
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmQ,
                 const __grid_constant__ CUtensorMap tmdO,
                 const __grid_constant__ CUtensorMap tmK,
                 const __grid_constant__ CUtensorMap tmV,
                 const __grid_constant__ CUtensorMap tmdQ,
                 const float* __restrict__ LSE,
                 const float* __restrict__ DELTA, int nbh, int sq, int sk,
                 int causal, float scale_log2, float sm_scale) {
  using P = Dq<D>;
  constexpr int BK = P::BK, S = P::kRing;
  constexpr int kSlab = BK * 128;      // a 64-column slab of K or V
  constexpr int kQSlab = kDqBQ * 128;  // ... of Q, dO or dQ
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =  // stage s: K at ring + s kStage, V after it
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qbuf = ring + S * P::kStage;  // buffer b: Q, then dO
  uint64_t* full = reinterpret_cast<uint64_t*>(qbuf + 4 * P::kItem);
  uint64_t* empty = full + S;
  uint64_t* q_full = empty + S;  // per item buffer
  uint64_t* q_empty = q_full + 2;  // the buffer's dQ stores read

  const DqItems items(nbh, (sq + kDqBQ - 1) / kDqBQ);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer; no wait counts on a loop's length
    regs_dec<kDqProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      tma_prefetch(&tmQ);
      tma_prefetch(&tmdO);
      tma_prefetch(&tmK);
      tma_prefetch(&tmV);
      int it = 0;  // kv tiles issued so far: the ring position
      int bh, q0, bh_next, q0_next;
      auto load_item = [&](int i, int h, int r) {
        const int b = i & 1;
        if (i >= 2) mbar_wait(&q_empty[b], ((i >> 1) - 1) & 1);
        unsigned char* dst = qbuf + b * 2 * P::kItem;
        mbar_arrive_expect_tx(&q_full[b], 2 * P::kItem);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(dst + c * kQSlab, &tmQ, &q_full[b], 64 * c, r, h);
          tma_load_3d(dst + P::kItem + c * kQSlab, &tmdO, &q_full[b], 64 * c,
                      r, h);
        }
      };
      auto load_kv = [&](int j) {
        const int st = it % S;
        if (it >= S) mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
        unsigned char* dst = ring + st * P::kStage;
        mbar_arrive_expect_tx(&full[st], P::kStage);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_3d(dst + c * kSlab, &tmK, &full[st], 64 * c, j * BK, bh);
          tma_load_3d(dst + P::kStage / 2 + c * kSlab, &tmV, &full[st],
                      64 * c, j * BK, bh);
        }
        ++it;
      };
      bool more = items.get(0, bh, q0);
      if (more) load_item(0, bh, q0);
      for (int i = 0; more; ++i, bh = bh_next, q0 = q0_next) {
        // item i + 1's Q and dO go out after item i's kv tiles, so the
        // wait for item i - 1's buffer (freed by the consumers at item i's
        // first tile) never holds back the ring
        const int nkv = max(fwd_num_kv(q0, sq, sk, causal, BK),
                            fwd_num_kv(q0 + 64, sq, sk, causal, BK));
        for (int j = 0; j < nkv; ++j) load_kv(j);
        more = items.get(i + 1, bh_next, q0_next);
        if (more) load_item(i + 1, bh_next, q0_next);
      }
    }
    return;
  }
  regs_inc<kDqConsumerRegs>();

  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const int rw = wg * 64 + warp * 16 + g;  // this thread's rows of an item
  const bool leader = (threadIdx.x & 127) == 0;  // issues the dQ stores
  uint32_t qa[D / 16][4], oa[D / 16][4], da[BK / 16][4];
  float dq[D / 8][4], s[BK / 8][4], dp[BK / 8][4];
  int it = 0, bh, q0;  // it: kv tiles consumed so far, the ring position
  DQ_CLOCKS_BEGIN;
  int pend = -1;  // item buffer whose stores this warpgroup has not seen read
  // the stores of the previous item have read buffer `pend`: the producer
  // may load the next item but one into it
  auto free_pending = [&]() {
    if (pend >= 0) {
      if (leader) tma_store_wait_read();
      mbar_arrive_if(&q_empty[pend], leader);
      pend = -1;
    }
  };
  for (int i = 0; items.get(i, bh, q0); ++i) {
    const int b = i & 1;
    unsigned char* sQ = qbuf + b * 2 * P::kItem;
    const unsigned char* sdO = sQ + P::kItem;
    const int r0 = q0 + wg * 64;  // this warpgroup's first row
    const int row_a = q0 + rw;    // this thread's rows: row_a, +8
    const int nkv = max(fwd_num_kv(q0, sq, sk, causal, BK),
                        fwd_num_kv(q0 + 64, sq, sk, causal, BK));
    const int nw = fwd_num_kv(r0, sq, sk, causal, BK);  // this one's
    // the rows' -lse * log2 e (-inf past sq or where lse is -inf, so p = 0
    // there) and delta (0 past sq), loaded before the wait
    float nl[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + h * 8;
      const size_t at = static_cast<size_t>(bh) * sq + row;
      const float L = row < sq ? LSE[at] : -INFINITY;
      nl[h] = isfinite(L) ? -(L * kLog2e) : -INFINITY;
      dl[h] = row < sq ? DELTA[at] : 0.f;
    }
    zero(dq);
    mbar_wait(&q_full[b], (i >> 1) & 1);
    read_q<D>(qa, sQ, wg * 64 + warp * 16, scale_log2);
    read_q<D>(oa, sdO, wg * 64 + warp * 16, 1.f);  // dO, as it is
    // S = Q_s K^T, then dP = dO V^T, of one kv tile: two wgmma groups
    auto issue_s_dp = [&](float (&sx)[BK / 8][4], float (&dpx)[BK / 8][4],
                          const unsigned char* sK) {
      issue_qk<D, BK>(sx, qa, sK);
      wgmma_commit();
      issue_qk<D, BK>(dpx, oa, sK + P::kStage / 2);
      wgmma_commit();
    };
    // p = exp2(s - lse log2 e) in place, exp2 as the forward's p; the mask
    // only on a tile that straddles the diagonal or the ragged kv edge
    auto tile_p = [&](float (&sx)[BK / 8][4], int kv0) {
      const bool masked =
          kv0 + BK > sk || (causal && kv0 + BK - 1 > r0 + off);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = sx[nt][e];
          if (masked) {
            const int col = kv0 + nt * 8 + 2 * t + (e & 1);
            if (col >= sk || (causal && col > row_a + (e >> 1) * 8 + off))
              sv = kNegInf;
          }
          sx[nt][e] = ex2_ftz(sv + nl[e >> 1]);
        }
    };
    // dS = p (dP - delta) sm_scale in float32, rounded to bf16 only by the
    // packing that builds dQ's A fragments
    auto tile_ds = [&](float (&sx)[BK / 8][4], const float (&dpx)[BK / 8][4],
                       uint32_t (&dax)[BK / 16][4]) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sx[nt][e] = sx[nt][e] * (dpx[nt][e] - dl[e >> 1]) * sm_scale;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) c_to_a(dax[kk], sx, kk);
    };
    for (int j = 0; j < nw; ++j, ++it) {
      const int st = it % S;
      const unsigned char* sK = ring + st * P::kStage;
      DQ_STAMP(0);
      mbar_wait(&full[st], (it / S) & 1);
      DQ_STAMP(1);
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
      issue_s_dp(s, dp, sK);
      wgmma_wait<1>();  // S is in; dP may still fly
      reg_fence(s);
      DQ_STAMP(2);
      tile_p(s, j * BK);
      DQ_STAMP(3);
      wgmma_wait<0>();  // dP is in
      reg_fence(dp);
      DQ_STAMP(4);
      tile_ds(s, dp, da);
      DQ_STAMP(5);
      reg_fence(dq);
      wgmma_fence();
      issue_pv<D, BK>(dq, da, sK);  // dQ += dS K, K MN-major
      wgmma_commit();
      wgmma_wait<0>();  // dQ is in: the stage is free
      reg_fence(dq);
      reg_fence(da);
      DQ_STAMP(6);
      release(&empty[st]);
      free_pending();
    }
    // kv tiles only the other warpgroup's rows see: let them through
    for (int j = nw; j < nkv; ++j, ++it) {
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      release(&empty[st]);
      free_pending();
    }
    free_pending();  // an item with no kv tile

    // dQ as bf16 into this warpgroup's rows of the Q tile (read into
    // registers at the item's start), 16-byte chunks XOR-swizzled by row as
    // TMA expects, then one TMA store per slab, which drops rows past sq
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + h * 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(sQ + (dt / 8) * kQSlab + r * 128 +
                                     (((dt % 8) ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16(dq[dt][2 * h], dq[dt][2 * h + 1]);
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (leader && r0 < sq) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_3d(&tmdQ, sQ + c * kQSlab + wg * 64 * 128, 64 * c, r0, bh);
    }
    pend = b;
    DQ_STAMP(7);
  }
  if (leader) tma_store_wait();
  DQ_CLOCKS_END;
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
// next tile's copies in flight while this one computes.
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
    kv_tile_step<D, BQ>(sK, sV, sQ, sQ + 2 * BQ * LD, sQ + BQ * LD,
                        l_of(cur), l_of(cur) + BQ, kv0, i * BQ, sk, off,
                        causal, sm_scale, dk, dv, st);
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

// cuTensorMapEncodeTiled, a driver API function, reached through the
// runtime's entry-point query: the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// TMA map of a (bh, s, D) bf16 tensor as 3-D (D, s, bh), boxes of 64
// columns x `rows` rows x 1 head in the 128-byte swizzle: a load's rows
// past s come back zero, never the next head's, and a store's are dropped
int encode_map(CUtensorMap* map, const void* base, int bh, int s, int D,
               int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(s) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int sq, int sk, int causal,
               float scale_log2, cudaStream_t stream) {
  // TMA moves q, k, v and o from and to 16-byte aligned addresses
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
      15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tmQ, tmK, tmV, tmO;
  memset(&tmK, 0, sizeof(tmK));
  memset(&tmV, 0, sizeof(tmV));
  if (int rc = encode_map(&tmQ, q, bh, sq, D, kFwdBQ)) return rc;
  if (int rc = encode_map(&tmO, o, bh, sq, D, 64)) return rc;
  if (sk > 0) {  // with no keys no block loads a kv tile
    if (int rc = encode_map(&tmK, k, bh, sk, D, fwd_bk<D>())) return rc;
    if (int rc = encode_map(&tmV, v, bh, sk, D, fwd_bk<D>())) return rc;
  }
  constexpr size_t smem = fwd_smem<D>();
  auto kern = fa_fwd_kernel<D>;
  if (int rc = prepare(kern, smem)) return rc;
  const long long items =
      static_cast<long long>((sq + kFwdBQ - 1) / kFwdBQ) * bh;
  if (items > 0x7fff0000LL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  if (int rc = static_cast<int>(cudaGetDevice(&dev))) return rc;
  if (int rc = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev)))
    return rc;
  const int grid = static_cast<int>(items < sms ? items : sms);
  kern<<<grid, kFwdThreads, smem, stream>>>(tmQ, tmK, tmV, tmO, lse, bh, sq,
                                            sk, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int bh, int sq,
              int sk, int causal, float scale_log2, float sm_scale,
              cudaStream_t stream) {
  using P = Dq<D>;
  // TMA moves q, k, v, dO and dq from and to 16-byte aligned addresses
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq)) &
      15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tmQ, tmdO, tmK, tmV, tmdQ;
  memset(&tmK, 0, sizeof(tmK));
  memset(&tmV, 0, sizeof(tmV));
  if (int rc = encode_map(&tmQ, q, bh, sq, D, kDqBQ)) return rc;
  if (int rc = encode_map(&tmdO, dout, bh, sq, D, kDqBQ)) return rc;
  if (int rc = encode_map(&tmdQ, dq, bh, sq, D, 64)) return rc;
  if (sk > 0) {  // with no keys no block loads a kv tile
    if (int rc = encode_map(&tmK, k, bh, sk, D, P::BK)) return rc;
    if (int rc = encode_map(&tmV, v, bh, sk, D, P::BK)) return rc;
  }
  constexpr size_t smem = P::smem;
  auto kern = fa_bwd_dq_kernel<D>;
  if (int rc = prepare(kern, smem)) return rc;
  const long long pairs =
      static_cast<long long>((sq + kDqBQ - 1) / kDqBQ + 1) / 2 * bh;
  if (pairs > 0x3fff0000LL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  if (int rc = static_cast<int>(cudaGetDevice(&dev))) return rc;
  if (int rc = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev)))
    return rc;
  const int grid = static_cast<int>(pairs < sms ? pairs : sms);
  kern<<<grid, kDqThreads, smem, stream>>>(tmQ, tmdO, tmK, tmV, tmdQ, lse,
                                           delta, bh, sq, sk, causal,
                                           scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// q tile of the fused kernel: 64 rows at D = 64, 32 at D = 128 (keeps dk,
// dv, S^T and dP^T in registers)
template <int D>
constexpr int bwd_bq() { return D == 64 ? 64 : 32; }

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int bh, int sq, int sk, int causal, float scale_log2,
               float sm_scale, cudaStream_t stream) {
  using P = Dkv<D>;
  // TMA moves q, k, v, dO, dk and dv from and to 16-byte aligned addresses
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) &
      15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tmQ, tmdO, tmK, tmV, tmdK, tmdV;
  if (int rc = encode_map(&tmQ, q, bh, sq, D, P::BQ)) return rc;
  if (int rc = encode_map(&tmdO, dout, bh, sq, D, P::BQ)) return rc;
  if (int rc = encode_map(&tmK, k, bh, sk, D, kDkvBK)) return rc;
  if (int rc = encode_map(&tmV, v, bh, sk, D, kDkvBK)) return rc;
  if (int rc = encode_map(&tmdK, dk, bh, sk, D, 64)) return rc;
  if (int rc = encode_map(&tmdV, dv, bh, sk, D, 64)) return rc;
  constexpr size_t smem = P::smem;
  auto kern = fa_bwd_dkv_kernel<D>;
  if (int rc = prepare(kern, smem)) return rc;
  const long long pairs =
      static_cast<long long>((sk + kDkvBK - 1) / kDkvBK + 1) / 2 * bh;
  if (pairs > 0x3fff0000LL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  if (int rc = static_cast<int>(cudaGetDevice(&dev))) return rc;
  if (int rc = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev)))
    return rc;
  const int grid = static_cast<int>(pairs > sms ? sms : pairs);
  kern<<<grid, kDkvThreads, smem, stream>>>(tmQ, tmdO, tmK, tmV, tmdK, tmdV,
                                            lse, delta, bh, sq, sk, causal,
                                            scale_log2, sm_scale);
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
