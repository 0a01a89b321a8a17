#!/usr/bin/env python3
"""A/B of the flash-attention forward's design choices on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 fa_fwd_variants.py

Builds the committed ``dlrover_wuqiong_tpu_torch/csrc/flash_attention.cu``
and variants of it made by text substitution, one nvcc each, all started
together, into the git-ignored ``dlrover_wuqiong_tpu_torch/_build/``:

- ``committed``: the source as it is;
- ``exp2f``: p by the accurate ``exp2f`` in place of ``ex2.approx.ftz``;
- ``stages2`` / ``stages4``: a K/V ring of 2 or 4 stages in place of 3;
- ``bk64``: kv tiles of 64 rows at D = 64 in place of 128;
- ``no_head_groups``: work items heaviest first over all heads, with no
  groups of heads small enough for L2;
- ``pingpong``: the two consumer warpgroups issue their products in strict
  turns (FlashAttention-3's named-barrier schedule);
- ``no_softmax`` / ``no_products``: the kv loop without its softmax, or
  without its two products (wrong results; they show what each part costs);
- ``timed``: the committed kernel writing SM clock stamps around each
  work item's phases (first tile, kv loop, last P V and store).

Prints each variant's registers and spills at D = 64 (``-Xptxas -v``) and
any wgmma serialisation ptxas reports, holds every variant that computes
the function against the plain version (`chip_smoke.FA_TOL` per row), and
times every variant at GPT-2's training shape (288, 1024, 1024, 64) causal
by CUDA events, in the order A B C ... C B A, beside
``scaled_dot_product_attention``'s forward.  Then the ``timed`` build's
mean phase lengths by the item's number of kv tiles.  The last lines are
the card's ``nvidia-smi`` line and one JSON object of the times.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "dlrover_wuqiong_tpu_torch", "csrc",
                   "flash_attention.cu")
LOOP_SOFTMAX = ("      softmax_tile<BK>(s, m, l, alpha, j * BK, r0, row_a, "
                "sk, off, causal);\n")
LOOP_QK = "      issue_qk<D, BK>(s, qa, ring + st * kStage);\n"
LOOP_PV = ("      issue_pv<D, BK>(acc, pa, ring + prev * kStage + "
           "kStage / 2);\n")
ITEM_NW = "    const int nw = fwd_num_kv(r0, sq, sk, causal, BK);\n"
# per work item of warpgroup 0: clocks at its start, after tile 0, after the
# kv loop, after the last P V, after the store; then its kv tiles
STAMPS = 6
BLOCKS = 1024  # stamps kept for the first 64 items of blocks below this
CLOCK = '''__device__ unsigned long long g_fa_clock[1024 * 64 * 6];
__device__ __forceinline__ void stamp(int i, int k) {
  if (threadIdx.x == 0 && i < 64 && blockIdx.x < 1024) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
    g_fa_clock[(blockIdx.x * 64 + i) * 6 + k] = t;
  }
}
'''


def fail(msg: str):
    print(f"fa_fwd_variants: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        fail(f"the forward's source moved: {old.strip()[:60]!r} found "
             f"{src.count(old)} times, expected {count}")
    return src.replace(old, new)


def pingpong(src: str) -> str:
    """Turns by named barriers 3 and 4: each warpgroup takes nkv + 1 a
    work item (one a kv tile, one for the last P V), whatever it
    computes, so both take the same number."""
    arrive = ('__device__ __forceinline__ void named_arrive(int id, int n) {'
              '\n  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(n) : '
              '"memory");\n}\n\n')
    src = sub(src, "// move registers between warpgroups",
              arrive + "// move registers between warpgroups")
    turn, give = "named_sync(my_turn, 256);\n", \
        "named_arrive(other_turn, 256);\n"
    src = sub(src, "  const int my_group = 1 + wg;",
              "  const int my_turn = 3 + wg, other_turn = 4 - wg;\n"
              "  if (wg == 1) named_arrive(3, 256);\n"
              "  const int my_group = 1 + wg;")
    src = sub(src, "      mbar_wait(&full[it % S], (it / S) & 1);\n",
              "      mbar_wait(&full[it % S], (it / S) & 1);\n      " + turn)
    src = sub(src, "      issue_qk<D, BK>(s, qa, ring + (it % S) * kStage);\n"
              "      wgmma_commit();\n",
              "      issue_qk<D, BK>(s, qa, ring + (it % S) * kStage);\n"
              "      wgmma_commit();\n      " + give)
    src = sub(src, "      mbar_wait(&full[st], ((it + j) / S) & 1);\n",
              "      mbar_wait(&full[st], ((it + j) / S) & 1);\n      " + turn)
    src = sub(src, LOOP_PV + "      wgmma_commit();\n",
              LOOP_PV + "      wgmma_commit();\n      " + give)
    src = sub(src, "    if (nw > 0) {  // P V of the last tile\n",
              "    " + turn + "    if (nw > 0) {  // P V of the last tile\n")
    src = sub(src, "      issue_pv<D, BK>(acc, pa, ring + st * kStage + "
              "kStage / 2);\n      wgmma_commit();\n",
              "      issue_pv<D, BK>(acc, pa, ring + st * kStage + "
              "kStage / 2);\n      wgmma_commit();\n      " + give)
    src = sub(src, "      release(&empty[st]);\n    }\n",
              "      release(&empty[st]);\n    } else {\n      " + give
              + "    }\n")
    return sub(src, "      release(&empty[(it + j) % S]);\n    }\n",
               "      release(&empty[(it + j) % S]);\n      " + turn
               + "      " + give + "    }\n")


def timed(src: str) -> str:
    src = sub(src, "// Online softmax", CLOCK + "// Online softmax")
    src = sub(src, ITEM_NW, ITEM_NW + "    stamp(i, 0);\n    if (threadIdx.x"
              " == 0 && i < 64 && blockIdx.x < 1024)\n      g_fa_clock["
              "(blockIdx.x * 64 + i) * 6 + 5] = nw;\n")
    src = sub(src, "    for (int j = 1; j < nw; ++j) {\n",
              "    stamp(i, 1);\n    for (int j = 1; j < nw; ++j) {\n")
    src = sub(src, "    if (nw > 0) {  // P V of the last tile\n",
              "    stamp(i, 2);\n    if (nw > 0) {  // P V of the last tile\n")
    src = sub(src, "    it += nkv;\n", "    it += nkv;\n    stamp(i, 3);\n")
    src = sub(src, "64 * c, r0, bh);\n    }\n  }\n",
              "64 * c, r0, bh);\n    }\n    stamp(i, 4);\n  }\n")
    return src + ('\nextern "C" int fa_clock(void* host, int n) {\n  return '
                  'static_cast<int>(cudaMemcpyFromSymbol(host, g_fa_clock, '
                  'static_cast<size_t>(n) * 8));\n}\n')


def variants(src: str) -> dict:
    stages = "constexpr int kFwdStages = 3;"
    return {
        "committed": src,
        "exp2f": sub(src, "      const float p = ex2_ftz(s[nt][e] - "
                     "base[e >> 1]);", "      const float p = exp2f(s[nt][e] "
                     "- base[e >> 1]);"),
        "stages2": sub(src, stages, "constexpr int kFwdStages = 2;"),
        "stages4": sub(src, stages, "constexpr int kFwdStages = 4;"),
        "bk64": sub(src, "constexpr int fwd_bk() { return D == 64 ? 128 : 64; "
                    "}", "constexpr int fwd_bk() { return 64; }"),
        "no_head_groups": sub(src, "gh(max(1, 2 * static_cast<int>(gridDim.x)"
                              " / nqt_))", "gh(nbh_)"),
        "pingpong": pingpong(src),
        "no_softmax": sub(src, LOOP_SOFTMAX,
                          "      alpha[0] = alpha[1] = 1.f;\n"),
        "no_products": sub(sub(src, LOOP_QK, ""), LOOP_PV, ""),
        "timed": timed(src),
    }


WRONG = ("no_softmax", "no_products")  # compute something else on purpose


def build(tfa, _build):
    out_dir = os.path.join(_build.BUILD_DIR, "fwd_variants")
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
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "fa_fwd_kernelILi64" in line:
                notes[name] = " ".join(x.strip() for x in lines[i + 2:i + 4])
        notes[name + " (ptxas C75xx)"] = [
            x.split("ptxas info    : ")[-1][:100] for x in lines
            if "(C75" in x and "fa_fwd_kernel" in x]
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, args in tfa._SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, notes


def phases(torch, tfa, lib, call) -> dict:
    """Mean SM clocks of each phase of warpgroup 0's work items, by the
    item's kv tiles."""
    n = BLOCKS * 64 * STAMPS
    buf = (ctypes.c_ulonglong * n)()
    lib.fa_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fa_clock.restype = ctypes.c_int
    call()
    torch.cuda.synchronize()
    tfa._check_rc(lib.fa_clock(ctypes.addressof(buf), n), "fa_clock")
    names = ("q and tile 0", "kv loop", "last P V", "store")
    groups = {}
    for x in range(BLOCKS * 64):
        r = buf[x * STAMPS:(x + 1) * STAMPS]
        if r[4]:  # an item this block ran
            groups.setdefault(r[5], []).append(
                [r[k + 1] - r[k] for k in range(4)])
    return {f"{nw} kv tiles ({len(ps)} items)": {
        nm: round(sum(p[k] for p in ps) / len(ps))
        for k, nm in enumerate(names)} for nw, ps in sorted(groups.items())}


def main():
    import torch
    import torch.nn.functional as F

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
    libs, notes = build(tfa, _build)
    for name, line in notes.items():
        print(f"{name}: forward, D = 64: {line}")

    bh, sq, d, scale = 288, 1024, 64, 0.125
    q, k, v, _ = chip_smoke.fa_inputs(torch, bh, sq, sq, d, 11)
    ref, _ = tfa._fa_forward_plain(q, k, v, True, scale)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {n: (torch.empty_like(q), torch.empty((bh, sq), device="cuda"))
            for n in libs}

    def launch(n):
        o, lse = outs[n]
        return lambda: tfa._check_rc(libs[n].fa_forward_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq, sq, d, 1, scale * tfa.LOG2E, stream),
            n)

    errs = {}
    for n in libs:
        launch(n)()
        torch.cuda.synchronize()
        errs[n] = chip_smoke._row_err(torch, outs[n][0], ref)
        if n not in WRONG and errs[n] > chip_smoke.FA_TOL:
            fail(f"{n}: row err {errs[n]} against the plain forward")
    print("row err against the plain forward: " + json.dumps(
        {n: f"{e:.2e}" for n, e in errs.items()}))

    fns = {n: launch(n) for n in libs if n != "timed"}
    q4, k4, v4 = (t.reshape(24, 12, sq, d) for t in (q, k, v))
    fns["sdpa_fwd"] = lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True)
    times = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        times[n].append(chip_smoke.cuda_ms(torch, fns[n], 20))
    clocks = phases(torch, tfa, libs["timed"], launch("timed"))
    print("timed: mean SM clocks of a work item's phases, by kv tiles: "
          + json.dumps(clocks))
    print(card)
    print(json.dumps({"shape": [bh, sq, sq, d], "causal": True,
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
