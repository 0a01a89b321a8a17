#!/usr/bin/env python3
"""On-card smoke run of dlrover_wuqiong_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; a failure in any of them exits non-zero:

1. torch and CUDA versions, the card's name and power limit (nvidia-smi).
2. Build every CUDA kernel of the package from ``csrc/`` with nvcc
   (sm_90a), timed.
3. Each kernel against its plain PyTorch version on the card: GPT-2's
   ``wte`` (50304x768) and ``c_fc`` (768x3072), in float32 and bfloat16,
   a ragged size and an all-zero block.  q must match exactly, scales and
   dequantized values bitwise.  Then each kernel's time, its plain
   version's time and its bound, at the serving path's shapes: all 50
   weight matrices of GPT-2 124M, as one engine build (quantize) and one
   dispatch (dequantize) need them.
4. The serving path: GPT-2 124M at full width, bf16 compute, seeded
   random weights, ``ServeSpec(max_slots=8, max_len=512,
   max_prompt_len=128, fused_tokens=8, quant="int8")``; 16 requests
   (prompts of 16-128 tokens, 64 new tokens, half greedy, half at
   temperature 0.8) through ``LocalServer``, with the kernels' launch
   counts set to 0 just before the engine is built and read just after
   the drain.  Checks: every request has 64 in-vocabulary tokens, both
   kernels ran (dequantize 50 times per dispatch), and one greedy
   request decoded alone on the same engine gives its busy-batch tokens.
   A profiled pass gives the device's busy share and launches per step.
   The same traffic with ``quant=""`` runs beside it, in turns with
   int8 (int8, bf16, bf16, int8).
5. A small-input reference check: GPT nano in float32 with int8 weights,
   greedy serving and one prefill's logits, on the card against the CPU
   (plain versions).
6. One JSON line of the kernels, the card line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero without printing a result when CUDA is absent or when
the package is not beside this script.  A profiler summary is written to
``chiprun_out/chip_smoke_profile.txt``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG_DIR = os.path.join(HERE, "dlrover_wuqiong_tpu_torch")

# H100 SXM data sheet: HBM3 rate, and the float32 rate outside the tensor
# cores (the int8 pair does scalar float32 arithmetic)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_REQUESTS = 16
NEW_TOKENS = 64
SPEC = dict(max_slots=8, max_len=512, max_prompt_len=128, fused_tokens=8)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters: int, device_paced: bool = True,
            warmup: int = 2) -> float:
    """Mean time of fn() over `iters` runs, by CUDA events.

    device_paced: the card first sleeps (~0.1 s) while the host enqueues
    all the launches, so the events time the kernels back to back and
    not the host's launch rate.  Otherwise the launches are timed as the
    host issues them, gaps included, as a serving dispatch pays them.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_paced:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: int, n_ops: int) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leaves(tree, out=None):
    out = [] if out is None else out
    for v in tree.values():
        if isinstance(v, dict):
            leaves(v, out)
        else:
            out.append(v)
    return out


# ------------------------------------------------------------ phase 3


def check_kernels(torch, tq):
    """Kernels vs plain versions on the card; returns max errors."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    zero = torch.randn(4 * 256, generator=gen, device=dev)
    zero[256:512] = 0.0
    cases = {
        "wte": torch.randn((50304, 768), generator=gen, device=dev) * 0.02,
        "c_fc": torch.randn((768, 3072), generator=gen, device=dev) * 0.036,
        "ragged": torch.randn(100_003, generator=gen, device=dev) * 3.0,
        "zero_block": zero,
    }
    err_q = err_d = 0.0
    for name, x32 in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            qk, sk = tq.quantize_int8_blockwise(x)
            qp, sp = tq._quantize_plain(x)
            torch.cuda.synchronize()
            tag = f"{name}/{str(dtype).split('.')[-1]}"
            check(qk.shape == qp.shape and sk.shape == sp.shape,
                  f"quantize shapes differ for {tag}")
            err_q = max(err_q, (qk.int() - qp.int()).abs().max().item(),
                        (sk - sp).abs().max().item())
            check(torch.equal(qk, qp), f"quantize q differs for {tag}")
            check(torch.equal(sk.view(torch.int32), sp.view(torch.int32)),
                  f"quantize scales differ bitwise for {tag}")
            if name == "zero_block":
                check(sk[1].item() == 1.0 and not qk[1].any(),
                      "all-zero block must have scale 1 and q 0")
            for out in (torch.float32, torch.bfloat16):
                dk = tq.dequantize_int8_blockwise(qk, sk, x.numel(),
                                                  tuple(x.shape), out)
                dp = tq._dequantize_plain(qp, sp, x.numel(), tuple(x.shape),
                                          out)
                torch.cuda.synchronize()
                err_d = max(err_d,
                            (dk.float() - dp.float()).abs().max().item())
                ints = torch.int32 if out == torch.float32 else torch.int16
                check(dk.dtype == out and dk.shape == x.shape,
                      f"dequantize dtype/shape wrong for {tag}")
                check(torch.equal(dk.view(ints), dp.view(ints)),
                      f"dequantize differs bitwise for {tag} -> {out}")
        print(f"kernels: {name} {tuple(x32.shape)} f32+bf16 match plain "
              f"bitwise")
    return err_q, err_d


def time_kernels(torch, tq, params):
    """Kernel, plain and bound times at the serving path's shapes: the 50
    matrices of GPT-2 124M, quantized from float32 masters (engine build)
    and dequantized to bf16 (one dispatch)."""
    mats = [t for t in leaves(params) if t.dim() >= 2]
    check(len(mats) == 50, f"expected 50 weight matrices, got {len(mats)}")
    stored = [tq.quantize_int8_blockwise(t) for t in mats]
    rows = sum(q.shape[0] for q, _ in stored)
    elems = sum(t.numel() for t in mats)

    def quant(fn):
        return lambda: [fn(t) for t in mats]

    def deq(fn):
        return lambda: [fn(q, s, t.numel(), tuple(t.shape), torch.bfloat16)
                        for (q, s), t in zip(stored, mats)]

    res = {}
    q_bytes = elems * 4 + rows * 256 + rows * 4
    d_bytes = rows * 256 + rows * 4 + elems * 2
    # per element: quantize abs, max, divide, round, clamp; dequantize
    # convert, multiply, round to bf16
    for name, kfn, pfn, nbytes, ops in (
            ("quantize_int8_blockwise", quant(tq.quantize_int8_blockwise),
             quant(tq._quantize_plain), q_bytes, 5 * rows * 256),
            ("dequantize_int8_blockwise", deq(tq.dequantize_int8_blockwise),
             deq(tq._dequantize_plain), d_bytes, 3 * elems)):
        b, by = bound_ms(nbytes, ops)
        res[name] = {"ms": cuda_ms(torch, kfn, 10),
                     "ms_host_paced": cuda_ms(torch, kfn, 10, False),
                     # one pass: ~600 launches, inside the launch queue
                     "plain_ms": cuda_ms(torch, pfn, 1),
                     "bound_ms": b, "bound_by": by, "bytes": nbytes}
    return res, elems


# ------------------------------------------------------------ phase 4


def make_requests(np, seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(N_REQUESTS):
        plen = int(rng.integers(16, 129))
        reqs.append(dict(
            request_id=f"r{i:02d}",
            prompt=rng.integers(0, vocab, plen).tolist(),
            max_new_tokens=NEW_TOKENS,
            seed=int(rng.integers(0, 2**31)),
            temperature=0.0 if i % 2 == 0 else 0.8))
    return reqs


def serve(torch, np, cfg, params, quant, reqs):
    """Build an engine and serve `reqs` through LocalServer's scheduler,
    all submitted at once; returns (engine, tokens, metrics, launches).
    Latency and time to first token count from submission, queueing for
    a slot included."""
    from dlrover_wuqiong_tpu_torch.ops import quantization as tq
    from dlrover_wuqiong_tpu_torch.serving import LocalServer, ServeSpec
    from dlrover_wuqiong_tpu_torch.serving import ServingEngine
    from dlrover_wuqiong_tpu_torch.telemetry.serving import (
        reset_serve_ledger,
    )

    reset_serve_ledger()
    torch.cuda.synchronize()
    tq.reset_launches()  # counts start at 0 just before the main path
    t0 = time.monotonic()
    engine = ServingEngine(cfg, params, ServeSpec(**SPEC, quant=quant))
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    server = LocalServer(engine)
    sch = server.scheduler
    for r in reqs:
        server.submit(**r)
    t1 = time.monotonic()
    done = {}
    while not sch.idle():
        sch.step()
        now = time.monotonic() - t1
        for res in sch.take_results():
            done[res.request_id] = (now, res)
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches = dict(tq.LAUNCHES)
    snap = sch.ledger.snapshot()
    windows = engine.dispatches - len(reqs)
    out = {rid: list(res.tokens) for rid, (_, res) in done.items()}
    n_tok = sum(len(v) for v in out.values())
    lat = np.array([t for t, _ in done.values()]) * 1e3
    # admitted at (finish - latency_s); first token ttft_s later
    ttft = np.array([t - res.latency_s + res.ttft_s
                     for t, res in done.values()]) * 1e3
    metrics = {
        "quant": quant,
        "requests": len(reqs),
        "finished": snap["counters"]["finished"],
        "tokens_out": n_tok,
        "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p99_ms": float(np.percentile(lat, 99)),
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "prefill_ms_p50": float(np.median(
            [res.ttft_s * 1e3 for _, res in done.values()])),
        "dispatches": engine.dispatches,
        "decode_windows": windows,
        "ms_per_decode_window": snap["states"]["decode"] / windows * 1e3,
        "ms_per_admit": snap["states"]["prefill"] / len(reqs) * 1e3,
        "engine_build_s": t_build,
    }
    return engine, out, metrics, launches


def profile_window(torch, engine, reqs):
    """Profile three decode windows over `max_slots` requests: the
    device's busy time per window and its kernel launches per decode
    step.  The profiler slows the host, so the busy share is taken
    against the unprofiled window time."""
    from torch.profiler import ProfilerActivity, profile

    from dlrover_wuqiong_tpu_torch.serving import LocalServer

    server = LocalServer(engine)
    for r in reqs[:SPEC["max_slots"]]:
        server.submit(**dict(r, request_id="p" + r["request_id"]))
    # the first step admits them all; profile decode-only steps after it
    server.scheduler.step()
    torch.cuda.synchronize()
    n_windows = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n_windows):
            server.scheduler.step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    server.drain()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    steps = n_windows * SPEC["fused_tokens"]
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           "chip_smoke_profile.txt"), "w") as f:
        f.write(table)
    if not kern:
        return {"device_busy_ms_per_window": "not measured",
                "kernels_per_decode_step": "not measured"}
    return {"device_busy_ms_per_window": busy_us / n_windows / 1e3,
            "profiled_wall_ms_per_window": wall_us / n_windows / 1e3,
            "kernels_per_decode_step": len(kern) / steps}


# ------------------------------------------------------------ phase 5


def reference_check(torch, np):
    """GPT nano, float32, int8 weights: the card (kernels) against the CPU
    (plain versions).  Greedy tokens equal; one prefill's logits within
    1e-4 (float32 sums in another order; TF32 is off)."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig, init_params
    from dlrover_wuqiong_tpu_torch.rl.generation import (
        forward_step,
        init_caches,
    )
    from dlrover_wuqiong_tpu_torch.serving import LocalServer, ServeSpec
    from dlrover_wuqiong_tpu_torch.serving import ServingEngine
    from dlrover_wuqiong_tpu_torch.serving.engine import (
        _materialize,
        _quantize_tree,
    )

    cfg = dataclasses.replace(GPTConfig.nano(), dtype=torch.float32)
    cpu = init_params(cfg, seed=1, device="cpu")
    gpu = tree_to(cpu, "cuda")
    spec = ServeSpec(max_slots=2, max_len=48, max_prompt_len=8,
                     fused_tokens=4, quant="int8")
    rng = np.random.default_rng(5)
    reqs = [dict(request_id=f"n{i}",
                 prompt=rng.integers(0, cfg.vocab_size, 1 + i).tolist(),
                 max_new_tokens=12, seed=i, temperature=0.0)
            for i in range(4)]
    outs = []
    for params, device in ((cpu, "cpu"), (gpu, "cuda")):
        server = LocalServer(ServingEngine(cfg, params, spec, device=device))
        for r in reqs:
            server.submit(**r)
        outs.append(server.drain())
    check(outs[0] == outs[1], "nano int8 greedy tokens differ card vs CPU")
    logits = []
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8)))
    for params, device in ((cpu, "cpu"), (gpu, "cuda")):
        store, meta = _quantize_tree(params, "int8", torch.device(device))
        p = _materialize(store, meta, cfg.dtype)
        caches = init_caches(cfg, 1, 16, device=device)
        out, _ = forward_step(cfg, p, prompt.to(device), caches, 0)
        logits.append(out.cpu())
    err = (logits[0] - logits[1]).abs().max().item()
    check(torch.allclose(logits[0], logits[1], atol=1e-4, rtol=1e-4),
          f"nano prefill logits differ card vs CPU: max |err| {err}")
    return err


def tree_to(tree, device):
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ------------------------------------------------------------ main


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"cannot import torch/numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not os.path.isfile(os.path.join(PKG_DIR, "__init__.py")):
        fail("dlrover_wuqiong_tpu_torch is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import dlrover_wuqiong_tpu_torch as port

    check(os.path.dirname(os.path.abspath(port.__file__)) == PKG_DIR,
          f"imported the package from {port.__file__}, not from {PKG_DIR}")
    from dlrover_wuqiong_tpu_torch import _build
    from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig, init_params
    from dlrover_wuqiong_tpu_torch.ops import quantization as tq

    # phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"versions: python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(card)

    # phase 2
    t0 = time.monotonic()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.2f} s")

    # phase 3
    err_q, err_d = check_kernels(torch, tq)
    cfg = GPTConfig.gpt2()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    times, elems = time_kernels(torch, tq, params)
    check(elems == 124_354_560, f"GPT-2 124M has {elems} matrix elements")
    for name, t in times.items():
        print(f"timing: {name} over 50 matrices: {t['ms']:.4f} ms on the "
              f"card ({t['ms_host_paced']:.4f} ms as the host issues it), "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['bytes']} B)")

    # phase 4 — warm-up (cuBLAS handles, allocator) on a throwaway engine
    reqs = make_requests(np, seed=0, vocab=50257)
    serve(torch, np, cfg, params, "int8", reqs[:2])
    engine, out, m_int8, launches = serve(torch, np, cfg, params, "int8",
                                          reqs)
    check(sorted(out) == sorted(r["request_id"] for r in reqs),
          "not every request finished")
    for rid, toks in out.items():
        check(len(toks) == NEW_TOKENS, f"{rid} has {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"{rid} has out-of-vocabulary tokens")
    n_layer_mats = 2 + 4 * cfg.n_layer
    check(launches["quantize_int8_blockwise"] == n_layer_mats,
          f"quantize launches {launches} != {n_layer_mats} at engine build")
    check(launches["dequantize_int8_blockwise"]
          == n_layer_mats * engine.dispatches,
          f"dequantize launches {launches} != 50 x {engine.dispatches}")
    greedy = next(r for r in reqs if r["temperature"] == 0.0)
    from dlrover_wuqiong_tpu_torch.serving import LocalServer

    alone = LocalServer(engine)
    alone.submit(**dict(greedy, request_id="alone"))
    check(alone.drain()["alone"] == out[greedy["request_id"]],
          "a greedy request alone differs from the busy batch")
    print("serving: 16 requests x 64 tokens; busy batch == alone; "
          f"launches {launches} over {engine.dispatches} dispatches")
    prof = profile_window(torch, engine, reqs)
    if isinstance(prof["device_busy_ms_per_window"], float):
        prof["device_busy_share"] = (prof["device_busy_ms_per_window"]
                                     / m_int8["ms_per_decode_window"])
    # the same traffic with bf16 weights beside it, in turns (int8 above,
    # then bf16, bf16, int8): host time varies from run to run
    runs = {"int8": [m_int8], "bf16": []}
    for quant in ("", "", "int8"):
        _, o, m, l = serve(torch, np, cfg, params, quant, reqs)
        check(len(o) == N_REQUESTS and all(
            len(v) == NEW_TOKENS for v in o.values()),
            f"quant={quant!r} run did not finish every request")
        check(quant or sum(l.values()) == 0, "quant='' launched kernels")
        runs[quant or "bf16"].append(m)
    print("serving: " + json.dumps({**runs, "int8_profile": prof}))

    # phase 5
    ref_err = reference_check(torch, np)
    print(f"reference: nano int8 card == CPU tokens; logits max |err| "
          f"{ref_err:.3g}")

    # phase 6
    src = "dlrover_wuqiong_tpu_torch/csrc/int8_blockwise.cu"
    kernels = []
    for name, replaces, err in (
            ("quantize_int8_blockwise",
             "dlrover_wuqiong_tpu/ops/quantization.py:69", err_q),
            ("dequantize_int8_blockwise",
             "dlrover_wuqiong_tpu/ops/quantization.py:78", err_d)):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": t["ms"],
            "ms_host_paced": t["ms_host_paced"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "timed_work": "the 50 weight matrices of GPT-2 124M",
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
