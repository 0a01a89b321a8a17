#!/usr/bin/env python3
"""A/B of the fused flash-attention backward's design choices on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 fa_bwd_variants.py

Builds the committed ``dlrover_wuqiong_tpu_torch/csrc/flash_attention.cu``
and variants of it made by text substitution, one nvcc each, all started
together, into the git-ignored ``dlrover_wuqiong_tpu_torch/_build/``:

- ``committed``: the source as it is;
- ``uncapped``: the fused kernel without its ``__launch_bounds__`` block
  count, so the compiler takes the registers it wants (fewer blocks an SM);
- ``dq_role_only`` / ``dkv_role_only``: every block of the other role
  returns at once, so each role's share of the launch is timed alone.

Prints each variant's registers and spills for the fused kernel at D = 64
and 128 (``-Xptxas -v``), checks that ``committed`` and ``uncapped`` give bitwise
equal dq, dk and dv, and times every variant's fused launch at GPT-2's
training shape (288, 1024, 1024, 64) causal, by CUDA events, in the order
A B C D D C B A, beside the split dq and dk/dv kernels of the committed
build and ``scaled_dot_product_attention`` forward + backward.  The last
lines are the card's ``nvidia-smi`` line and one JSON object of the times.
"""

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


def fail(msg: str):
    print(f"fa_bwd_variants: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


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
    }


def build(tfa, _build):
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
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
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            # entry line, then its properties: stack and spills, registers
            m = re.search(r"fa_bwd_fused_kernelILi(\d+)", line)
            if "Compiling entry" in line and m:
                regs[f"{name}, D = {m.group(1)}"] = " ".join(
                    x.strip() for x in lines[i + 2:i + 4])
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, args in tfa._SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Mean time of fn() by CUDA events, the card asleep while the host
    enqueues, so the launches run back to back."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    from dlrover_wuqiong_tpu_torch import _build
    from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    libs, regs = build(tfa, _build)
    for name, line in sorted(regs.items()):
        print(f"{name}: fused kernel: {line}")

    bh, sq, d, scale = 288, 1024, 64, 0.125
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn((bh, sq, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = tfa._fa_forward_kernel(q, k, v, True, scale)
    delta = tfa._delta(o, do, None)
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    tail = [bh, sq, sq, d, 1, scale * tfa.LOG2E, scale,
            torch.cuda.current_stream().cuda_stream]

    def launch(fn, outs):
        return lambda: tfa._check_rc(
            fn(*ins, *(t.data_ptr() for t in outs), *tail), "flash backward")

    outs = {n: [torch.empty_like(q) for _ in range(3)] for n in libs}
    for n, lib in libs.items():
        launch(lib.fa_backward_fused_bf16, outs[n])()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs["committed"],
                                                  outs["uncapped"])):
        fail("committed and uncapped builds differ")

    fns = {n: launch(lib.fa_backward_fused_bf16, outs[n])
           for n, lib in libs.items()}
    lib = libs["committed"]
    fns["split_dq"] = launch(lib.fa_backward_dq_bf16, outs["committed"][:1])
    fns["split_dkv"] = launch(lib.fa_backward_dkv_bf16,
                              outs["committed"][1:])
    q4, k4, v4 = (t.reshape(24, 12, sq, d).clone().requires_grad_()
                  for t in (q, k, v))
    do4 = do.reshape(24, 12, sq, d)

    def sdpa():
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        return torch.autograd.grad(out, (q4, k4, v4), do4)

    fns["sdpa_fwd_bwd"] = sdpa
    times = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        times[n].append(cuda_ms(torch, fns[n]))
    print(card)
    print(json.dumps({"shape": [bh, sq, sq, d], "causal": True,
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
