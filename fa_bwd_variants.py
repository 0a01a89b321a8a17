#!/usr/bin/env python3
"""A/B of the flash-attention backward's design choices on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 fa_bwd_variants.py [--baseline OTHER/flash_attention.cu]

Builds the committed ``dlrover_wuqiong_tpu_torch/csrc/flash_attention.cu``
and variants of it made by text substitution, one nvcc each, all started
together, into the git-ignored ``dlrover_wuqiong_tpu_torch/_build/``:

- ``committed``: the source as it is;
- the fused backward's: ``uncapped`` (no ``__launch_bounds__`` block
  count, so the compiler takes the registers it wants and fewer blocks fit
  an SM), ``dq_role_only`` / ``dkv_role_only`` (every block of the other
  role returns at once, so each role's share of the launch is timed alone);
- the dk/dv kernel's: ``dkv_stages2`` (a ring of 2 q-tile stages at
  D = 64 in place of 3), ``dkv_bq64`` (q tiles of 64 rows at D = 64 in
  place of 128), ``dkv_per_item`` (one block per work item, the card's
  block scheduler placing them, in place of a persistent block per SM
  over pairs of items), ``dkv_exp2f`` (p^T by the accurate ``exp2f`` in
  place of ``ex2.approx.ftz``), ``dkv_pingpong`` (the two consumer
  warpgroups issue their S^T and dP^T in strict turns by named barriers,
  as FlashAttention-3's forward, so one's p^T runs under the other's
  products), ``dkv_timed`` (the committed kernel summing each consumer
  warpgroup's SM clocks between the stamps of its q tiles' phases);
- the dq kernel's: ``dq_stages2`` / ``dq_stages3`` (a ring of 2 / 3 kv
  tile stages at both head dims, in place of 4 at D = 64 and 2 at
  D = 128), ``dq_bk64`` (kv tiles of 64 rows at D = 64 in place of 128),
  ``dq_pairs`` (64-row kv tiles two a step at D = 64, one's p and dS
  under the other's products), ``dq_early_items`` (an item's Q and dO
  loaded after the previous item's first kv tile, in place of its last),
  ``dq_per_item`` (one block per work item in place of a persistent block
  per SM over pairs of items), ``dq_exp2f`` (p by ``exp2f`` in place of
  ``ex2.approx.ftz``), ``dq_qs_smem`` (Q_s scaled in place in shared
  memory and read from there by S's wgmma, in place of A registers),
  ``dq_do_smem`` (dP's wgmma reading dO from shared memory, in place of A
  registers), ``dq_timed`` (the committed kernel summing each consumer
  warpgroup's SM clocks between the stamps of its kv tiles' phases: S
  and dP, p, dS, dQ);
- ``baseline``, with ``--baseline``: the parent commit's source of the
  same C interface, built as it is to check and time its kernels beside
  these in one process.

Prints each build's registers and spills for the fused, dk/dv and dq
kernels at D = 64 and 128 (``-Xptxas -v``) and any wgmma serialisation
note.  Checks, on seeded inputs: ``committed`` and ``uncapped`` give
bitwise equal dq, dk and dv at GPT-2's shape; every dk/dv or dq variant
that computes the same arithmetic in the same order gives outputs bitwise
equal to ``committed``'s (at both shapes); every dk/dv and dq build lies
within ``chip_smoke.FA_TOL`` of the plain backward per row, and whether
each dq build equals ``committed``'s bitwise is printed; ``baseline``'s
fused dq, dk, dv and split dk/dv equal ``committed``'s bitwise (the
fused and dk/dv kernels unchanged), its split dq within ``FA_TOL`` of
the plain backward.  Then times, by CUDA events, in the order A B C ...
C B A: the fused builds beside ``scaled_dot_product_attention`` forward
+ backward at GPT-2's training shape (288, 1024, 1024, 64) causal, and
the dk/dv and dq builds at that shape and at Llama-3 8B's (32, 4096,
4096, 128) causal; then the ``dkv_timed`` and ``dq_timed`` builds' mean
clocks of a tile's phases at both shapes.  The last lines are the card's
``nvidia-smi`` line and one JSON object of the times.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "dlrover_wuqiong_tpu_torch", "csrc",
                   "flash_attention.cu")
BOUNDS = re.compile(r"__launch_bounds__\(kThreads, [^)]*\)\n"
                    r"fa_bwd_fused_kernel")
DISPATCH = "  if (dkv)\n    dkv_role<D, BQ>("
DKV_STAGES = "  static constexpr int S = D == 64 ? 3 : 2;\n"
DKV_BQ = "  static constexpr int BQ = D == 64 ? 128 : 64;\n"
# one block per item: block 2w + h takes item h of pair w alone
DKV_ITEMS = "    for (int w = blockIdx.x; w < total; w += gridDim.x) {\n"
DKV_GRID = "  const int grid = static_cast<int>(pairs > sms ? sms : pairs);\n"
DKV_HOOKS = ("#define DKV_CLOCKS_BEGIN\n#define DKV_STAMP(k)\n"
             "#define DKV_CLOCKS_END\n")
DQ_RING = "  static constexpr int kRing = D == 64 ? 4 : 2;\n"
DQ_BK = "  static constexpr int BK = D == 64 ? 128 : 64;\n"
# one block per item: block 2w + h takes item h of pair w alone
DQ_ITEMS = ("    for (int pair = blockIdx.x; pair < total; pair += gridDim.x)"
            " {\n")
DQ_GRID = "  const int grid = static_cast<int>(pairs < sms ? pairs : sms);\n"
DQ_HOOKS = ("#define DQ_CLOCKS_BEGIN\n#define DQ_STAMP(k)\n"
            "#define DQ_CLOCKS_END\n")
DQ_EXP = "sx[nt][e] = ex2_ftz(sv + nl[e >> 1]);"
DQ_READ_Q = "    read_q<D>(qa, sQ, wg * 64 + warp * 16, scale_log2);\n"
DQ_READ_DO = ("    read_q<D>(oa, sdO, wg * 64 + warp * 16, 1.f);  // dO, as it "
              "is\n")
DQ_ISSUE_S = "      issue_qk<D, BK>(sx, qa, sK);\n"
DQ_ISSUE_DP = "      issue_qk<D, BK>(dpx, oa, sK + P::kStage / 2);\n"
# Q_s in shared memory: each consumer warpgroup scales its own 64 rows of
# the landed Q tile in place, publishes them to the async proxy, and S
# reads A from there (issue_kq: A in 128-row slabs)
DQ_QS_SMEM = """    for (int c = threadIdx.x & 127; c < D * 8; c += 128) {
      uint4* u = reinterpret_cast<uint4*>(sQ + (c / 512) * kQSlab +
                                          wg * 64 * 128 + (c % 512) * 16);
      uint4 v = *u;
      v.x = scale_pair(v.x, scale_log2);
      v.y = scale_pair(v.y, scale_log2);
      v.z = scale_pair(v.z, scale_log2);
      v.w = scale_pair(v.w, scale_log2);
      *u = v;
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
"""
# item i + 1's Q and dO loaded after item i's first kv tile (the first
# design): the producer then waits for item i - 1's buffer, freed by the
# consumers at item i's first tile, before it loads item i's other tiles
DQ_ITEM_LOADS = """        for (int j = 0; j < nkv; ++j) load_kv(j);
        more = items.get(i + 1, bh_next, q0_next);
        if (more) load_item(i + 1, bh_next, q0_next);
"""
DQ_EARLY_ITEMS = """        if (nkv > 0) load_kv(0);
        more = items.get(i + 1, bh_next, q0_next);
        if (more) load_item(i + 1, bh_next, q0_next);
        for (int j = 1; j < nkv; ++j) load_kv(j);
"""
# two 64-row kv tiles a step at D = 64 (a design measured and dropped):
# tile a's p and dS run while tile b's S and dP fly, tile b's while tile
# a's dQ flies
DQ_LOOP = "    for (int j = 0; j < nw; ++j, ++it) {\n"
DQ_PAIRS_LOOP = """    int j = 0;
    if constexpr (D == 64) {
      for (; j + 1 < nw; j += 2, it += 2) {
        const int sa = it % S, sb = (it + 1) % S;
        const unsigned char* sKa = ring + sa * P::kStage;
        const unsigned char* sKb = ring + sb * P::kStage;
        mbar_wait(&full[sa], (it / S) & 1);
        mbar_wait(&full[sb], ((it + 1) / S) & 1);
        reg_fence(s);
        reg_fence(dp);
        reg_fence(s2);
        reg_fence(dp2);
        wgmma_fence();
        issue_s_dp(s, dp, sKa);
        issue_s_dp(s2, dp2, sKb);
        wgmma_wait<3>();
        reg_fence(s);
        tile_p(s, j * BK);
        wgmma_wait<2>();
        reg_fence(dp);
        tile_ds(s, dp, da);
        reg_fence(dq);
        wgmma_fence();
        issue_pv<D, BK>(dq, da, sKa);
        wgmma_commit();
        wgmma_wait<2>();
        reg_fence(s2);
        tile_p(s2, (j + 1) * BK);
        wgmma_wait<1>();
        reg_fence(dp2);
        tile_ds(s2, dp2, da2);
        wgmma_fence();
        issue_pv<D, BK>(dq, da2, sKb);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
        reg_fence(da);
        reg_fence(da2);
        release(&empty[sa]);
        release(&empty[sb]);
        free_pending();
      }
    }
    for (; j < nw; ++j, ++it) {
"""
DQ_REGS = ("  uint32_t qa[D / 16][4], oa[D / 16][4], da[BK / 16][4];\n"
           "  float dq[D / 8][4], s[BK / 8][4], dp[BK / 8][4];\n")
DQ_PAIRS_REGS = ("  uint32_t qa[D / 16][4], oa[D / 16][4], da[BK / 16][4], "
                 "da2[BK / 16][4];\n  float dq[D / 8][4], s[BK / 8][4], "
                 "dp[BK / 8][4], s2[BK / 8][4], dp2[BK / 8][4];\n")
# the timed builds' hooks: per block and consumer warpgroup, 8 clock sums
# (stamp k adds the clocks since the previous stamp) and the tiles
CLOCK_BLOCKS = 1024


def timed_hooks(prefix: str, sym: str) -> str:
    return f'''__device__ unsigned long long {sym}[{CLOCK_BLOCKS} * 2 * 9];
#define {prefix}_CLOCKS_BEGIN \\
  unsigned long long sum_[8] = {{}}, last_ = clock64(), tiles_ = 0
#define {prefix}_STAMP(k)                                 \\
  do {{                                               \\
    const unsigned long long t_ = clock64();          \\
    sum_[k] += t_ - last_;                            \\
    last_ = t_;                                       \\
    if (k == 6) ++tiles_;                             \\
  }} while (0)
#define {prefix}_CLOCKS_END                                                   \\
  do {{                                                                  \\
    if ((threadIdx.x & 127) == 0 && blockIdx.x < {CLOCK_BLOCKS}) {{       \\
      unsigned long long* o_ = {sym} + (blockIdx.x * 2 + wg) * 9;  \\
      for (int k_ = 0; k_ < 8; ++k_) o_[k_] = sum_[k_];                  \\
      o_[8] = tiles_;                                                    \\
    }}                                                                   \\
  }} while (0)
'''


def clock_read(fn: str, sym: str) -> str:
    return (f'\nextern "C" int {fn}(void* host, int n) {{\n  return '
            f'static_cast<int>(cudaMemcpyFromSymbol(host, {sym}, '
            f'static_cast<size_t>(n) * 8));\n}}\n')


TIMED_HOOKS = timed_hooks("DKV", "g_dkv_clock")
CLOCK_READ = clock_read("fa_dkv_clock", "g_dkv_clock")
DQ_TIMED_HOOKS = timed_hooks("DQ", "g_dq_clock")
DQ_CLOCK_READ = clock_read("fa_dq_clock", "g_dq_clock")
PHASES = ("gap before the tile (release, item start, skipped tiles)",
          "wait for Q, dO and Q_s", "issue S^T, dP^T; wait S^T", "p^T",
          "wait dP^T", "issue dV; dS^T; issue dK", "wait dV and dK",
          "dK, dV stores (all items)")
DQ_PHASES = ("gap before the tile (release, item start, let-through tiles)",
             "wait for K and V", "issue S, dP; wait S", "p", "wait dP",
             "dS and its packing", "issue dQ; wait dQ",
             "dQ stores (all items)")
DKV_EXP = "sT[nt][e] = ex2_ftz(sv + ((e & 1) ? nl.y : nl.x));"
# dk/dv builds whose arithmetic is the committed one's: bitwise equal
DKV_SAME = ("dkv_stages2", "dkv_bq64", "dkv_per_item", "dkv_pingpong",
            "dkv_timed")
# dq builds whose arithmetic and order of sums are the committed one's:
# bitwise equal (wgmma sums each k16 slice in turn, whatever the tile
# widths; the others' bitwise equality is reported, not required)
DQ_SAME = ("dq_stages2", "dq_stages3", "dq_per_item", "dq_timed",
           "dq_bk64", "dq_pairs", "dq_early_items")
SHAPES = {"gpt2": (288, 1024, 64), "llama3_8b": (32, 4096, 128)}


def fail(msg: str):
    print(f"fa_bwd_variants: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        fail(f"the backward's source moved: {old.strip()[:60]!r} found "
             f"{src.count(old)} times, expected once")
    return src.replace(old, new)


def pingpong(src: str) -> str:
    """Turns by named barriers 3 and 4 around each q tile's S^T and dP^T
    issue; a tile only the other warpgroup computes takes its turn too, so
    both take one a tile."""
    arrive = ('__device__ __forceinline__ void named_arrive(int id, int n) {'
              '\n  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(n) : '
              '"memory");\n}\n\n')
    src = sub(src, "// move registers between warpgroups",
              arrive + "// move registers between warpgroups")
    turn = "      named_sync(3 + wg, 256);\n"
    give = "      named_arrive(4 - wg, 256);\n"
    src = sub(src, "  DKV_CLOCKS_BEGIN;\n",
              "  DKV_CLOCKS_BEGIN;\n  if (wg == 1) named_arrive(3, 256);\n")
    src = sub(src, "      mbar_wait(&full[s], (it / S) & 1);\n"
              "      release(&empty[s]);\n",
              "      mbar_wait(&full[s], (it / S) & 1);\n" + turn + give
              + "      release(&empty[s]);\n")
    src = sub(src, "      DKV_STAMP(1);\n", "      DKV_STAMP(1);\n" + turn)
    return sub(src, "      issue_kq<D, BQ>(dpT, sV + wg * 64 * 128, sdO);\n"
               "      wgmma_commit();\n",
               "      issue_kq<D, BQ>(dpT, sV + wg * 64 * 128, sdO);\n"
               "      wgmma_commit();\n" + give)


def variants(src: str) -> dict:
    if len(BOUNDS.findall(src)) != 1 or src.count(DISPATCH) != 1:
        fail("the fused kernel's launch bounds or role dispatch moved")
    return {
        "committed": src,
        "uncapped": BOUNDS.sub("__launch_bounds__(kThreads)\n"
                               "fa_bwd_fused_kernel", src),
        "dq_role_only": src.replace(DISPATCH, "  if (dkv) return;\n"
                                    + DISPATCH),
        "dkv_role_only": src.replace(DISPATCH, "  if (!dkv) return;\n"
                                     + DISPATCH),
        "dkv_stages2": sub(src, DKV_STAGES,
                           "  static constexpr int S = 2;\n"),
        "dkv_bq64": sub(src, DKV_BQ, "  static constexpr int BQ = 64;\n"),
        "dkv_per_item": sub(sub(src, DKV_ITEMS,
                                "    if (i > 0) return false;\n"
                                "    i = blockIdx.x % 2;\n"
                                "    for (int w = blockIdx.x / 2; w < total;"
                                " w += total) {\n"),
                            DKV_GRID, "  const int grid = static_cast<int>("
                            "2 * pairs);\n"),
        "dkv_pingpong": pingpong(src),
        "dkv_timed": sub(src, DKV_HOOKS, TIMED_HOOKS) + CLOCK_READ,
        "dkv_exp2f": sub(src, DKV_EXP,
                         "sT[nt][e] = exp2f(sv + ((e & 1) ? nl.y : nl.x));"),
        "dq_stages2": sub(src, DQ_RING, "  static constexpr int kRing = 2;\n"),
        "dq_stages3": sub(src, DQ_RING, "  static constexpr int kRing = 3;\n"),
        "dq_bk64": sub(src, DQ_BK, "  static constexpr int BK = 64;\n"),
        "dq_pairs": sub(sub(sub(src, DQ_BK,
                                "  static constexpr int BK = 64;\n"),
                            DQ_LOOP, DQ_PAIRS_LOOP), DQ_REGS, DQ_PAIRS_REGS),
        "dq_early_items": sub(src, DQ_ITEM_LOADS, DQ_EARLY_ITEMS),
        "dq_per_item": sub(sub(src, DQ_ITEMS,
                               "    if (i > 0) return false;\n"
                               "    i = blockIdx.x % 2;\n"
                               "    for (int pair = blockIdx.x / 2; pair < "
                               "total; pair += total) {\n"),
                           DQ_GRID, "  const int grid = static_cast<int>("
                           "2 * pairs);\n"),
        "dq_exp2f": sub(src, DQ_EXP, "sx[nt][e] = exp2f(sv + nl[e >> 1]);"),
        "dq_qs_smem": sub(sub(src, DQ_READ_Q, DQ_QS_SMEM), DQ_ISSUE_S,
                          "      issue_kq<D, BK>(sx, sQ + wg * 64 * 128, "
                          "sK);\n"),
        "dq_do_smem": sub(sub(src, DQ_READ_DO, ""), DQ_ISSUE_DP,
                          "      issue_kq<D, BK>(dpx, sdO + wg * 64 * 128, "
                          "sK + P::kStage / 2);\n"),
        "dq_timed": sub(src, DQ_HOOKS, DQ_TIMED_HOOKS) + DQ_CLOCK_READ,
    }


def build(tfa, _build, baseline):
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(SRC) as f:
        srcs = variants(f.read())
    if baseline:
        with open(baseline) as f:
            srcs["baseline"] = f.read()
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", os.path.join(out_dir, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            # entry line, then its properties: stack and spills, registers
            m = re.search(r"(fa_bwd_fused_kernel|fa_bwd_dkv_kernel|"
                          r"fa_bwd_dq_kernel)ILi(\d+)", line)
            if "Compiling entry" in line and m:
                regs[f"{name}, {m.group(1)}, D = {m.group(2)}"] = " ".join(
                    x.strip() for x in lines[i + 2:i + 4])
        notes = [x.split("ptxas info    : ")[-1][:100] for x in lines
                 if "(C75" in x and "fa_bwd" in x]
        if notes:
            regs[f"{name} (ptxas C75xx)"] = "; ".join(notes)
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, args in tfa._SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def inputs(torch, tfa, chip_smoke, bh, s, d):
    q, k, v, do = chip_smoke.fa_inputs(torch, bh, s, s, d, 11)
    scale = 1.0 / d ** 0.5
    o, lse = tfa._fa_forward_kernel(q, k, v, True, scale)
    delta = tfa._delta(o, do, None)
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    tail = [bh, s, s, d, 1, scale * tfa.LOG2E, scale,
            torch.cuda.current_stream().cuda_stream]
    # delta is returned to stay alive while `ins` points at it
    return (q, k, v, o, lse, do, scale, delta), ins, tail


def clocks(torch, tfa, lib, fn: str, phases) -> dict:
    """A timed build's clock sums after one launch (read by its C entry
    `fn`), averaged over its blocks' consumer warpgroups: each phase's
    clocks per tile (the stores' per warpgroup), the tiles and all clocks
    per warpgroup."""
    n = CLOCK_BLOCKS * 2 * 9
    buf = (ctypes.c_ulonglong * n)()
    getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    getattr(lib, fn).restype = ctypes.c_int
    torch.cuda.synchronize()
    tfa._check_rc(getattr(lib, fn)(ctypes.addressof(buf), n), fn)
    rows = [buf[r * 9:(r + 1) * 9] for r in range(CLOCK_BLOCKS * 2)]
    out = {}
    for wg in (0, 1):
        mine = [r for i, r in enumerate(rows) if i % 2 == wg and r[8]]
        tiles = sum(r[8] for r in mine)
        per = {ph: round(sum(r[k] for r in mine) / tiles, 1)
               for k, ph in enumerate(phases[:7])}
        per[phases[7]] = round(sum(r[7] for r in mine) / len(mine))
        per["tiles per warpgroup"] = round(tiles / max(1, len(mine)), 1)
        per["total clocks per warpgroup"] = round(
            sum(sum(r[:8]) for r in mine) / max(1, len(mine)))
        out[f"warpgroup {wg}"] = per
    return out


def main():
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="",
                    help="the parent commit's flash_attention.cu, to build, "
                         "check and time beside these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    import chip_smoke
    from dlrover_wuqiong_tpu_torch import _build
    from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    libs, regs = build(tfa, _build, args.baseline)
    for name, line in sorted(regs.items()):
        print(f"{name}: {line}")
    base = ["baseline"] if "baseline" in libs else []
    fused = [n for n in ("committed", "uncapped", "dq_role_only",
                         "dkv_role_only") if n in libs] + base
    dkv = [n for n in libs if n.startswith("dkv_") and n != "dkv_role_only"]
    dkv = ["committed"] + dkv + base
    dq = [n for n in libs if n.startswith("dq_") and n != "dq_role_only"]
    dq = ["committed"] + dq + base

    def launch(lib, fn, ins, tail, outs):
        return lambda: tfa._check_rc(
            getattr(lib, fn)(*ins, *(t.data_ptr() for t in outs), *tail),
            fn)

    times, errs, same = {}, {}, {}
    for shape, (bh, s, d) in SHAPES.items():
        args_, ins, tail = inputs(torch, tfa, chip_smoke, bh, s, d)
        q, k, v, o, lse, do, scale, _ = args_
        fns = {}
        if shape == "gpt2":
            outs = {n: [torch.empty_like(q) for _ in range(3)] for n in fused}
            for n in fused:
                launch(libs[n], "fa_backward_fused_bf16", ins, tail,
                       outs[n])()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(
                    outs["committed"], outs["uncapped"])):
                fail("committed and uncapped builds differ")
            if base and not all(torch.equal(a, b) for a, b in zip(
                    outs["committed"], outs["baseline"])):
                fail("the baseline's fused dq, dk or dv differs from the "
                     "committed build's bitwise")
            fns = {n: launch(libs[n], "fa_backward_fused_bf16", ins, tail,
                             outs[n]) for n in fused}
            q4, k4, v4 = (t.reshape(24, 12, s, d).clone().requires_grad_()
                          for t in (q, k, v))
            do4 = do.reshape(24, 12, s, d)

            def sdpa():
                out = F.scaled_dot_product_attention(q4, k4, v4,
                                                     is_causal=True)
                return torch.autograd.grad(out, (q4, k4, v4), do4)

            fns["sdpa_fwd_bwd"] = sdpa
        # the split builds, each held against the committed one or the plain
        # backward
        kv_outs = {n: [torch.empty_like(k) for _ in range(2)] for n in dkv}
        for n in dkv:
            launch(libs[n], "fa_backward_dkv_bf16", ins, tail, kv_outs[n])()
        q_outs = {n: [torch.empty_like(q)] for n in dq}
        for n in dq:
            launch(libs[n], "fa_backward_dq_bf16", ins, tail, q_outs[n])()
        torch.cuda.synchronize()
        rq, rk, rv = tfa._fa_backward_plain(q, k, v, o, lse, do, True, scale)
        for n in dkv:
            got = kv_outs[n]
            if n in DKV_SAME + tuple(base) and not all(
                    torch.equal(a, b) for a, b in zip(
                        got, kv_outs["committed"])):
                fail(f"{n} at {shape}: dk/dv differ from committed bitwise")
            errs[f"dkv {n}, {shape}"] = e = max(
                chip_smoke._row_err(torch, got[0], rk),
                chip_smoke._row_err(torch, got[1], rv))
            if e > chip_smoke.FA_TOL:
                fail(f"{n} at {shape}: dk/dv row err {e}")
        for n in dq:
            got = q_outs[n][0]
            same[f"dq {n}, {shape}"] = eq = torch.equal(
                got, q_outs["committed"][0])
            if n in DQ_SAME and not eq:
                fail(f"{n} at {shape}: dq differs from committed bitwise")
            errs[f"dq {n}, {shape}"] = e = chip_smoke._row_err(torch, got, rq)
            if e > chip_smoke.FA_TOL:
                fail(f"{n} at {shape}: dq row err {e}")
        del rq, rk, rv
        for n in dkv:
            if n != "dkv_timed":
                fns[f"dkv {n}"] = launch(libs[n], "fa_backward_dkv_bf16",
                                         ins, tail, kv_outs[n])
        for n in dq:
            if n != "dq_timed":
                fns[f"dq {n}"] = launch(libs[n], "fa_backward_dq_bf16",
                                        ins, tail, q_outs[n])
        order = list(fns) + list(fns)[::-1]
        shape_times = {n: [] for n in fns}
        for n in order:
            shape_times[n].append(chip_smoke.cuda_ms(torch, fns[n], 20))
        times[shape] = {"shape": [bh, s, s, d], "causal": True,
                        "ms": shape_times}
        print(f"{shape} {[bh, s, s, d]}: " + json.dumps(shape_times),
              flush=True)
        for kind, fn, outs_, reader, phases in (
                ("dkv", "fa_backward_dkv_bf16", kv_outs, "fa_dkv_clock",
                 PHASES),
                ("dq", "fa_backward_dq_bf16", q_outs, "fa_dq_clock",
                 DQ_PHASES)):
            timed = libs[f"{kind}_timed"]
            launch(timed, fn, ins, tail, outs_[f"{kind}_timed"])()
            times[shape][f"{kind}_timed_clocks"] = c = clocks(
                torch, tfa, timed, reader, phases)
            print(f"{shape}: {kind}_timed, mean SM clocks a tile (per "
                  f"warpgroup for the stores): " + json.dumps(c), flush=True)
        del fns, kv_outs, q_outs, args_, q, k, v, o, lse, do
        torch.cuda.empty_cache()
    if base:
        print("baseline: fused dq, dk, dv and split dk/dv equal the "
              "committed build's bitwise; its split dq within FA_TOL of the "
              "plain backward")
    print("row err against the plain backward (tolerance "
          f"{chip_smoke.FA_TOL}): "
          + json.dumps({n: f"{e:.2e}" for n, e in errs.items()}))
    print("dq bitwise equal to the committed build's: " + json.dumps(same))
    print(card)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
