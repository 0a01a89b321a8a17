#!/usr/bin/env python3
"""On-card smoke run of dlrover_wuqiong_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; a failure in any of them exits non-zero:

1. torch and CUDA versions, the card's name and power limit (nvidia-smi).
2. Build every CUDA kernel of the package from ``csrc/`` with nvcc
   (sm_90a), one nvcc per source, all started together, timed.
3. The int8 pair against its plain PyTorch versions on the card: GPT-2's
   ``wte`` (50304x768) and ``c_fc`` (768x3072), in float32 and bfloat16,
   a ragged size and an all-zero block, one tensor a call (the quantize
   kernel's one-leaf case), and a dequantize of a q one byte off a
   16-byte boundary.  Then the grouped quantize in one launch over
   GPT-2 124M's 50 matrices plus a ragged leaf, an all-zero block and a
   leaf at storage offset 1, in float32 and bfloat16, against per-leaf
   plain quantizes, and the flat dequantize of its store against
   per-leaf plain dequantizes.  q must match exactly, scales and
   dequantized values bitwise.  Then each kernel's time, its plain
   version's time and its bound, at the serving path's shapes: all 50
   weight matrices of GPT-2 124M in one grouped quantize (engine build)
   and one flat dequantize (dispatch), in turns with the loop of 50
   one-leaf calls.
3b. The four flash-attention kernels against their plain versions on the
   card, bf16 inputs: GPT-2's training shape (288, 1024, 1024, 64)
   causal, a ragged causal case, non-causal, sq < sk, sq > sk (rows with
   no key), d = 128, d = 48 through the public API, two cases for the
   forward's 128-row q tiles (a tile whose upper 64 rows lie past sq; a
   tile whose rows see no key up to row 119), two at Llama-3's head
   dim 128 for the dk/dv kernel's 128-row kv items (several items with
   sq != sk; a ragged kv edge inside an item), and one for the dq
   kernel's pairs of 128-row q tiles (an odd count, 5, so one goes alone,
   with sk > sq); every row of every output within `FA_TOL` of its own
   norm, lse within `FA_LSE_TOL`.  Three faults planted into the plain
   version at GPT-2's shape must each break `FA_TOL`.  The fused route's
   dq lies within `FA_TOL` of the split route's per row (the two sum in
   other orders).  In the ragged, sq < sk, sq > sk, the two q-tile, the
   ragged d = 128 and the dq-pairs cases the forward, the fused backward,
   the dq kernel and the dk/dv kernel are launched once more into
   outputs filled with NaN: every value must come back bitwise equal to
   the wrapper's (each output row is written by some block).  Two runs
   of the forward and of each backward route are bitwise equal, and so
   are the outputs of q, k, v and dO at storage offset 1 (realigned by
   the wrapper) and of the aligned operands, for the forward and both
   backward routes at GPT-2's shape.  The forward's, the dk/dv kernel's
   and the dq kernel's registers, spills and shared memory, and any
   wgmma serialisation note (``nvcc -Xptxas -v`` on the committed
   source).  Then each kernel's time at GPT-2's shape beside its plain
   version, its bound and ``scaled_dot_product_attention`` (forward,
   timed in turns with the forward kernel; forward + backward for the
   backward kernels), a yardstick the port never calls; the forward and
   the split dq and dk/dv kernels also at Llama-3 8B's attention (32,
   4096, 4096, 128) causal (the forward in turns with SDPA's forward,
   beside the plain forward; the backward kernels beside the plain
   backward and SDPA forward + backward at (1, 32, 4096, 128)), with their
   bounds; and the host time of one forward, fused backward, dq and dk/dv
   call.
4. The serving path: GPT-2 124M at full width, bf16 compute, seeded
   random weights, ``ServeSpec(max_slots=8, max_len=512,
   max_prompt_len=128, fused_tokens=8, quant="int8")``; 16 requests
   (prompts of 16-128 tokens, 64 new tokens, half greedy, half at
   temperature 0.8) through ``LocalServer``, with the kernels' launch
   counts set to 0 just before the engine is built and read just after
   the drain.  Checks: every request has 64 in-vocabulary tokens, one
   quantize launch at the engine build and one dequantize launch per
   dispatch (the dispatches counted at the drain), and one greedy
   request decoded alone on the same engine gives its busy-batch tokens.
   A profiled pass gives the device's busy share and launches per step.
   The same traffic with ``quant=""`` runs beside it, in turns with
   int8 (int8, bf16, bf16, int8).
4d. The same int8 traffic through the master-backed worker: a port
   ``JobMaster`` hosted in this process on 127.0.0.1, the 16 requests
   submitted through a ``MasterClient``, ``ServingWorker(client,
   engine).run`` on a thread leasing them over loopback RPC, in turns
   with the direct route (direct, worker, worker, direct), timed from
   the first submit to the master holding the last result.  Checks:
   every request has 64 in-vocabulary tokens, the greedy ones equal
   phase 4's, one quantize launch at the worker's engine build and one
   dequantize launch per dispatch (counts set to 0 just before the
   build).  Prints tokens/s, latency and TTFT p50/p99 of both routes and
   the host ms of each RPC verb from the ``rpc:<verb>`` spans; then two
   diagnostics in turns: the worker on the main thread, and the worker
   beside a 2 ms poller of the master's queue.
4b. The training path: ``auto_accelerate(GPT(GPTConfig.gpt2() with
   remat=False), optimizer=adamw(3e-4))`` at full width and depth, bf16
   compute over float32 masters, B = 24, T = 1024, one fixed batch of
   seeded tokens.  After two warm-up steps, 20 steps with the launch
   counts set to 0 just before and read just after: every loss and grad
   norm finite, the last loss below the first, and exactly 12 forward
   and 12 fused-backward launches per step (no split ones).  A profile
   of 3 steps gives the device's busy share and its time by kind.  Then
   3 steps with ``DWT_FA_NO_FUSED=1`` (12 dq and 12 dk/dv launches per
   step, no fused), one ``fused_steps=4`` call with one readback, and 3
   steps with remat "full" (24 forward launches per step).
4c. Llama training: ``auto_accelerate(Llama(LlamaConfig.llama3_8b() with
   num_layers=4), optimizer=adamw(3e-4))`` at Llama-3 8B's full width
   (vocab 128256, hidden 4096, 32 heads over 8 kv heads of dim 128),
   4 of its 32 layers, bf16 compute over float32 masters, remat "full",
   B = 1, T = 4096, one fixed batch of seeded tokens.  After two warm-up
   steps, 5 steps with the launch counts set to 0 just before and read
   just after: every loss and grad norm finite, the mean loss of the last
   two steps below that of the first two (the loss alternates from step
   to step under this learning rate), and exactly 8 forward, 4 dq, 4
   dk/dv and 0 fused launches per step (T = 4096 takes the split pair;
   remat runs each forward twice).
   ms per step, tokens/s, model TFLOP/s, peak memory, and a profile of 3
   steps (busy share, device time by kind and by torch op).  Then the
   same model on the einsum branch (plain attention, no kernel) from the
   same seed and batch: its 7 losses within `LLAMA_LOSS_RTOL` of the
   flash route's, and its ms per step.
5. Small-input reference checks, the card (kernels) against the CPU
   (plain versions): GPT nano in float32 with int8 weights, greedy
   serving and one prefill's logits; and GPT nano in float32 training
   from the same params and batches: the first step's logits and every
   parameter's gradient within `NANO_GRAD_RTOL`, then the losses of 3
   adamw steps within `NANO_LOSS_RTOL`.
5c. The same for a small Llama in float32 (2 layers, hidden 256, 2 heads
   of dim 128 over 1 kv head, vocab 512) at B = 1, T = 2048, where the
   card takes the split dq and dk/dv kernels at D = 128 with GQA.
   Phase 3b also holds the forward, dq and dk/dv kernels against their
   plain versions at Llama-3 8B's attention shape, per row, through the
   C entries and through the wrappers the model launches
   (``_fa_forward_kernel``, ``_fa_backward_kernel`` on the split route).
6b. The drain drill (``chaos.serve_drain``, the JAX drill's parameters:
   GPT nano, 8 requests x 24 tokens at temperature 1.0, 2 slots, 2 fused
   tokens): an in-process master, a worker subprocess on the card
   SIGKILLed once 2 requests are done and others leased, its failure
   reported, a second worker draining.  Checks: zero dropped, requeues
   attributed, results bitwise an alone-decode's at the workers'
   geometry, one trace tree per request from both generations' flight
   dumps.  Prints the recovery time and how many requests differ at the
   JAX drill's other geometry (3 slots, 4 fused tokens).
7. The flash checkpoint of GPT-2 124M's training state (1,493,710,860
   bytes: float32 params, AdamW's mu and nu, the step and count).  First
   the host's sizes (``df`` of /dev/shm and of the checkpoint directory,
   free memory, the digest in use); the phase fails, naming the sizes,
   when they cannot hold the state.  Then this run's rates (pinned D2H
   and H2D, host memcpy, digest, disk write + fsync) and the bound of
   each stage at them.  7.1: ``auto_accelerate(GPT(GPTConfig.gpt2() with
   remat=False), optimizer=adamw(3e-4), seed=0)`` on phase 4b's batch,
   2 warm-up steps and 3, ``save_checkpoint(5, state.tree(),
   StorageType.DISK)``, steps 6-7; a model from seed 1 restored
   (``load_checkpoint(state.tree())``) from shm and then from storage: every
   leaf bitwise the saved one, each resumed pair of steps bitwise the
   uninterrupted losses and grad norms, with 12 forward and 12 fused
   backward launches a step (counts set to 0 just before, read just
   after); then bf16 wire staging: float32 leaves the bf16 round trip,
   int leaves exact.  7.2: 5 saves in turns with a step alone and a step
   during the drain (blocked seconds, the snapshot's device time as
   issued and back to back, drain, persist), one save chained behind
   another, 2 timed restores a tier (verified load and H2D apart).  7.3:
   the SIGKILL drill (``checkpoint.drill.sigkill_drill``): a trainer
   subprocess saves to shm at step 5, takes step 6 and is SIGKILLed; a
   second one restores from its segment (tier ``shm``) and runs steps
   6-7, bitwise this process's; the seconds from the kill to the
   restored state and the part of them that is the second process's
   start.  7.4 (run after 7.2): the replica ring on that state, with a
   ``ReplicaServer`` thread of this process as the peer holding rank 0's
   backups: `RING_REPEATS` timed ``backup``, ``fetch_peer`` with
   verification, ``restore`` into shm, and engine loads by tier
   ``"replica"`` (verified load and H2D apart), each beside its bound at
   this run's memcpy, digest and loopback-TCP rates; the step after the
   replica load bitwise the step after a shm restore.  Then one byte of
   the held blob is flipped: the load falls through to storage, lists
   the replica fallback, fires the health hook, and its step too is
   bitwise.  One ``checkpoint:`` JSON line.
8. The elastic trainer (``trainer.drill``).  8.1: ``Trainer(GPT(GPT-2
   124M), TrainingArgs(max_steps=30, warmup_steps=5, cosine,
   save_steps=10, flash_stage_steps=1, logging_steps=1), data_fn)`` in
   this process at B = 24, T = 1024, the data function drawing each
   step's tokens from (seed, step): every loss finite, the last below the
   first, step 30 committed, 12 forward and 12 fused-backward launches a
   step.  8.2: the same Trainer as the worker of ``python -m
   dlrover_wuqiong_tpu_torch.run --standalone --max_restarts=3``, a
   SIGKILL at each of 2 seeded steps in [10, 25] (the worker waits out
   its staging there).  Checks: the launcher exits 0 after exactly 2
   restarts, ``latest_checkpointed_iteration.txt`` reads 30, the killed
   generation's segment holds the step before its kill step and the next
   generation resumes there from tier ``shm`` and trains from the step
   after, every step's loss in every generation is bitwise 8.1's, and
   every worker launched 12 forward and 12 fused-backward kernels a step
   (its own counters, written to its marker directory) and no int8 one.
   Prints each kill's split (the agent noticing the exit, the persist,
   the failure report, the rendezvous, the worker's start, the restore,
   the first resumed step) and the goodput fractions.  Its directories
   and segments go whether it passes or fails.
9. The node-loss drill (``trainer.drill.node_loss_drill``): each rank's
   uninterrupted run in this process (GPT-2 124M at B = 8, T = 1024, 30
   steps, warmup 5, tokens from (seed, step, rank)), then two ``python
   -m dlrover_wuqiong_tpu_torch.run --nnodes=2`` launchers against an
   in-process port master with ``DWT_CTX_CHECKPOINT_REPLICA=1``, their
   workers the same Trainers on the card in a gloo world (NCCL refuses
   two ranks on one card), a shm stage every 5 steps and a disk save
   (persist, then the ring backup) every 10.  After step 20 is committed
   and node 0's ReplicaServer holds node 1's segment of it, node 1's
   agent and worker are SIGKILLed, its segment unlinked, and a fresh
   node-1 launcher started.  Checks (`node_loss_checks`): both launchers
   exit 0, step 30 committed, node 1's new agent spans and logs a ring
   restore of step 20 from rank 0's holder, node 1's new worker resumes
   from tier ``shm`` at step 20 with no storage read, node 0 from its own
   shm, every loss of both ranks bitwise its uninterrupted run's, 12 + 12
   flash launches a step in every worker.  Prints node 1's time from the
   loss to its first resumed step by part, each ring backup, each
   worker's peak memory and how long each of its stages waited on the
   segment's lock.
10. The journaled master (``chaos.master_kill``, GPT-2 124M at full
   width and depth, bf16 compute over float32 masters, B = 8, T = 1024).
   10.1: ``auto_accelerate(GPT(cfg with remat=False), optimizer=adamw(
   3e-4), seed=0)`` in this process over the sample ranges [0, 2048) in
   order, 8 samples a step (each sample a row of 1025 tokens from (seed,
   sample index)): 256 reference losses, every one finite, the last
   below the first, the median step, and 12 forward and 12
   fused-backward launches a step (counts set to 0 just before, read
   just after).  10.2: ``python -m dlrover_wuqiong_tpu_torch.master
   --journal-dir=...`` as a subprocess, ``python -m
   dlrover_wuqiong_tpu_torch.run --nnodes=1 --max_restarts=2`` dialing
   it, its worker the same trainer on the card fed by the master's
   dataset shards (2048 samples, 32 minibatches a shard: 8 shards of 32
   steps); after the 2nd fetch and 4 of its steps the master is
   SIGKILLed, and 1.5 s later a new one starts on the same journal and
   port.  Checks, every invariant of the drill: one worker generation,
   the launcher exits 0, the 2048 samples tiled once (fetched ==
   completed), steps inside the outage, heartbeats buffered and drained,
   the epoch at 2 and the node re-registered, the worker's ledger
   degraded and productive both > 0, goodput_wall >= 0.5 (the ideal step
   10.1's median), the restarted master on group commit; every one of
   the 256 losses bitwise 10.1's; and the worker's own counters at 12
   forward and 12 fused-backward launches a step and no int8 one.  Prints the outage,
   the restart gap, the frames and seconds of the replay, the journal's
   gauges, the steps in the outage, the degraded and productive seconds,
   the goodput, and the host ms p50 / p99 of the journaled ``get_task``
   and ``report_task_result`` before the kill and after the restart.
   Its directories and both masters go whether it passes or fails.
6. One JSON line of the six kernels, the card line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero without printing a result when CUDA is absent or when
the package is not beside this script.  Profiler tables are written to
``chiprun_out/chip_smoke_profile.txt`` (serving),
``chiprun_out/chip_smoke_train_profile.txt`` (GPT-2 training) and
``chiprun_out/chip_smoke_llama_profile.txt`` (Llama training).
"""

import contextlib
import json
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
PKG_DIR = os.path.join(HERE, "dlrover_wuqiong_tpu_torch")

# H100 SXM data sheet: HBM3 rate, the float32 rate outside the tensor
# cores (the int8 pair does scalar float32 arithmetic) and the dense bf16
# tensor-core rate (the flash kernels' products)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

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


def host_us(torch, fn, iters: int = 50) -> float:
    """Host time to enqueue one fn() (the card asleep meanwhile, so the
    queue never pushes back), microseconds."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bound_ms(n_bytes: int, n_ops: int,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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
                if name == "ragged":
                    # q one byte past a 16-byte boundary: the wrapper
                    # realigns it for the kernel's 16-byte loads
                    dm = tq.dequantize_int8_blockwise(
                        offset1(torch, qk), sk, x.numel(), tuple(x.shape),
                        out)
                    torch.cuda.synchronize()
                    check(torch.equal(dm.view(ints), dk.view(ints)),
                          f"dequantize of a misaligned q differs for {tag}")
        print(f"kernels: {name} {tuple(x32.shape)} f32+bf16 match plain "
              f"bitwise")
    return err_q, err_d


def offset1(torch, t):
    """t's values in a tensor that starts one element into its storage, so
    its address is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_grouped(torch, tq, mats):
    """The grouped quantize (one launch) and the flat dequantize against
    the per-leaf plain versions on the card, bitwise: GPT-2 124M's 50
    matrices plus a ragged leaf, an all-zero block and a float32 leaf at
    storage offset 1 (the scalar path), in float32 and bfloat16.  Returns
    the max errors of q and scales, and of dequantized values."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    zero = torch.randn(3 * 256, generator=gen, device="cuda")
    zero[256:512] = 0.0
    extra = [torch.randn(100_003, generator=gen, device="cuda") * 3.0, zero,
             offset1(torch, torch.randn((333, 77), generator=gen,
                                        device="cuda"))]
    check(extra[2].data_ptr() % 16 != 0, "the offset leaf is aligned")
    err_q = err_d = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        xs = [t.to(dtype) for t in mats + extra[:2]]
        xs.append(extra[2] if dtype == torch.float32
                  else offset1(torch, extra[2].to(dtype)))
        tag = f"grouped/{str(dtype).split('.')[-1]}"
        before = tq.LAUNCHES["quantize_int8_blockwise"]
        qk, sk, first = tq.quantize_int8_blockwise_grouped(xs)
        check(tq.LAUNCHES["quantize_int8_blockwise"] == before + 1,
              f"{tag}: the grouped quantize took more than one launch")
        qp, sp, first_p = tq._quantize_grouped_plain(xs)
        torch.cuda.synchronize()
        check(first == first_p and qk.shape == qp.shape
              and sk.shape == sp.shape, f"{tag}: store layouts differ")
        err_q = max(err_q, (qk.int() - qp.int()).abs().max().item(),
                    (sk - sp).abs().max().item())
        check(torch.equal(qk, qp), f"{tag}: q differs from per-leaf plain")
        check(torch.equal(sk.view(torch.int32), sp.view(torch.int32)),
              f"{tag}: scales differ bitwise from per-leaf plain")
        z = first[len(mats) + 1] + 1
        check(sk[z].item() == 1.0 and not qk[z].any(),
              f"{tag}: all-zero block must have scale 1 and q 0")
        ends = first[1:] + [qk.shape[0]]
        for out in (torch.float32, torch.bfloat16):
            flat = tq.dequantize_int8_blockwise(qk, sk, qk.numel(),
                                                (qk.numel(),), out)
            torch.cuda.synchronize()
            ints = torch.int32 if out == torch.float32 else torch.int16
            for x, r0, r1 in zip(xs, first, ends):
                got = flat[r0 * 256:r0 * 256 + x.numel()].view(x.shape)
                want = tq._dequantize_plain(qp[r0:r1], sp[r0:r1], x.numel(),
                                            tuple(x.shape), out)
                err_d = max(err_d,
                            (got.float() - want.float()).abs().max().item())
                check(torch.equal(got.view(ints), want.view(ints)),
                      f"{tag}: flat dequantize -> {out} differs bitwise "
                      f"from per-leaf plain at a leaf of {tuple(x.shape)}")
        print(f"kernels: {tag} quantize of {len(xs)} leaves in one launch "
              f"and the flat dequantize (f32 and bf16 out) match per-leaf "
              f"plain bitwise")
        del qk, sk, qp, sp, flat, xs
    return err_q, err_d


def time_kernels(torch, tq, mats):
    """Kernel, plain and bound times at the serving path's shapes: the 50
    matrices of GPT-2 124M, quantized from float32 masters in one grouped
    launch (engine build) and dequantized to bf16 in one flat launch (one
    dispatch).  Beside them, in turns (grouped, loop, loop, grouped), the
    loop of 50 one-leaf calls of the same kernels."""
    q, s, first = tq.quantize_int8_blockwise_grouped(mats)
    ends = first[1:] + [q.shape[0]]
    stored = [(q[a:b], s[a:b]) for a, b in zip(first, ends)]
    rows = q.shape[0]
    elems = sum(t.numel() for t in mats)

    def deq(fn):
        return lambda: [fn(qi, si, t.numel(), tuple(t.shape), torch.bfloat16)
                        for (qi, si), t in zip(stored, mats)]

    res = {}
    q_bytes = elems * 4 + rows * 256 + rows * 4
    d_bytes = rows * 256 + rows * 4 + elems * 2
    # per element: quantize abs, max, divide, round, clamp; dequantize
    # convert, multiply, round to bf16
    for name, kfn, loop, pfn, nbytes, ops in (
            ("quantize_int8_blockwise",
             lambda: tq.quantize_int8_blockwise_grouped(mats),
             lambda: [tq.quantize_int8_blockwise(t) for t in mats],
             lambda: tq._quantize_grouped_plain(mats), q_bytes,
             5 * rows * 256),
            ("dequantize_int8_blockwise",
             lambda: tq.dequantize_int8_blockwise(
                 q, s, q.numel(), (q.numel(),), torch.bfloat16),
             deq(tq.dequantize_int8_blockwise),
             lambda: tq._dequantize_plain(q, s, q.numel(), (q.numel(),),
                                          torch.bfloat16),
             d_bytes, 3 * elems)):
        b, by = bound_ms(nbytes, ops)
        turns = [cuda_ms(torch, f, 10) for f in (kfn, loop, loop, kfn)]
        paced = [cuda_ms(torch, f, 10, False) for f in (kfn, loop, loop, kfn)]
        res[name] = {"ms": (turns[0] + turns[3]) / 2,
                     "ms_host_paced": (paced[0] + paced[3]) / 2,
                     "loop_ms": (turns[1] + turns[2]) / 2,
                     "loop_ms_host_paced": (paced[1] + paced[2]) / 2,
                     "turns_ms": turns, "turns_ms_host_paced": paced,
                     "plain_ms": cuda_ms(torch, pfn, 1),
                     "bound_ms": b, "bound_by": by, "bytes": nbytes}
    return res, elems


# ------------------------------------------------------------ phase 3b

# GPT-2 124M's attention at the training step: B = 24, 12 heads, T = 1024
FA_SHAPE = dict(bh=24 * 12, sq=1024, sk=1024, d=64, causal=True)
FA_CASES = [  # name, bh, sq, sk, d, causal
    ("gpt2", 288, 1024, 1024, 64, True),
    ("ragged", 8, 200, 328, 64, True),
    ("non_causal", 16, 512, 512, 64, False),
    ("sq<sk", 16, 256, 512, 64, True),
    ("sq>sk", 16, 512, 256, 64, True),  # the first 256 rows see no key
    ("d128", 16, 256, 256, 128, True),
    ("ragged_d48", 12, 200, 200, 48, True),  # odd d, ragged tiles
    # the forward's 128-row q tiles, two warpgroups of 64 rows: the second
    # tile's upper warpgroup lies wholly past sq; rows 0-119 see no key, so
    # the first tile's second warpgroup mixes empty and live rows
    ("half_tile", 16, 192, 192, 64, True),
    ("sq>sk_mixed", 16, 320, 200, 64, True),
    # Llama-3's head dim: several 128-row kv tiles (the dk/dv kernel's
    # items) with sq != sk, and a ragged kv edge inside an item
    ("llama_d128", 8, 384, 256, 128, True),
    ("ragged_d128", 8, 320, 200, 128, True),
    # the dq kernel's items in pairs of 128-row q tiles (p, nqt - 1 - p):
    # an odd count of them (5), so one goes alone, with sk > sq
    ("dq_pairs", 8, 640, 704, 64, True),
]
# Tolerance of a flash kernel against its plain version on the same bf16
# inputs, per row: a head's row of o or dq, a key's row of dk or dv.
#     ||kernel_r - plain_r|| <= FA_TOL * max(||plain_r||, FA_FLOOR * rms)
# where rms is the root mean square of ||plain_r|| over the output's rows.
# Both sides round p and ds to bf16 before their products, but the
# kernel's forward rounds p against a running row max (the plain one
# against the final max) and sums in another order, and every output is
# rounded to bf16 (2^-9 relative), so a sound row reads a few bf16 ulps
# of its own norm.  The row scale matters: at GPT-2's causal shape the
# first rows average one key (|o| ~ 1) and the last ~1000 (|o| ~ 0.05), so
# a bound against the largest value would let a fault in most rows pass.
# The floor keeps rows that are zero in exact arithmetic (dq of a row
# that sees one key) from dividing noise by noise.  `planted_faults`
# holds the tolerance against three faults a kernel could make, every
# run.  On an H100 (PERF.md) sound rows read at most 9.3e-3 over all
# cases and the planted faults at least 0.82.  lse is float32 from
# float32 sums: FA_LSE_TOL absolute.
FA_TOL = 2e-2
FA_FLOOR = 1e-2
FA_LSE_TOL = 1e-3
# cases with edges a block could leave unwritten: ragged tiles, the causal
# diagonal offset both ways, queries that see no key (sq > sk), q tiles
# part past sq or part without keys
FA_NAN_CASES = ("ragged", "sq<sk", "sq>sk", "half_tile", "sq>sk_mixed",
                "ragged_d128", "dq_pairs")


def fwd_smem_bytes(d: int) -> int:
    """Dynamic shared memory the forward's launcher asks for (fwd_smem in
    csrc/flash_attention.cu): 1 KB of alignment, a ring of 3 stages of
    one K and one V tile (128 rows at d = 64, 64 at d = 128), two q and
    two output staging tiles of 128 rows, 10 mbarriers."""
    bk = 128 if d == 64 else 64
    return 1024 + 3 * 2 * bk * d * 2 + 4 * 128 * d * 2 + 10 * 8


def ptxas_start(_build):
    """nvcc -Xptxas -v over the committed flash source, beside the build;
    returns (process, the throwaway library's path)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"ptxas_report.{os.getpid()}.so")
    cmd = _build.nvcc_command("flash_attention", out)
    return subprocess.Popen(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def dkv_smem_bytes(d: int) -> int:
    """Dynamic shared memory the dk/dv kernel's launcher asks for
    (Dkv<D>::smem in csrc/flash_attention.cu): 1 KB of alignment, two kv
    buffers of a 128-row K and V tile, a ring of Q, dO and Q_s tiles and
    their rows' two floats (3 stages of 128 rows at d = 64, 2 of 64 at
    d = 128), 3 mbarriers a stage and 4 for the kv buffers."""
    stages, bq = (3, 128) if d == 64 else (2, 64)
    return (1024 + 4 * 128 * d * 2 + stages * (3 * bq * d * 2 + 2 * bq * 4)
            + (3 * stages + 4) * 8)


def dq_smem_bytes(d: int) -> int:
    """Dynamic shared memory the dq kernel's launcher asks for (Dq<D>::smem
    in csrc/flash_attention.cu): 1 KB of alignment, two item buffers of a
    128-row Q and dO tile, a ring of K and V tiles (4 stages of 128 rows
    at d = 64, 2 of 64 at d = 128), 2 mbarriers a stage and 4 for the
    item buffers."""
    stages, bk = (4, 128) if d == 64 else (2, 64)
    return 1024 + 4 * 128 * d * 2 + stages * 2 * bk * d * 2 \
        + (2 * stages + 4) * 8


# kernel (its mangled-name stem in the ptxas log) -> its shared memory
PTXAS_KERNELS = {"fa_fwd_kernel": fwd_smem_bytes,
                 "fa_bwd_dkv_kernel": dkv_smem_bytes,
                 "fa_bwd_dq_kernel": dq_smem_bytes}


def ptxas_report(started) -> dict:
    """The Hopper kernels' (forward, dk/dv, dq) registers, spills and
    shared memory at d = 64 and 128 from ptxas, and any wgmma
    serialisation it reports for them."""
    import re

    proc, path = started
    log, _ = proc.communicate()
    if os.path.exists(path):
        os.remove(path)
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n{log[-4000:]}")
    lines = log.splitlines()
    out = {}
    for kernel, smem in PTXAS_KERNELS.items():
        rep = {}
        for i, line in enumerate(lines):
            m = re.search(kernel + r"ILi(\d+)", line)
            if "Compiling entry" in line and m:
                props = " ".join(x.strip() for x in lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", props)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", props)
                d = int(m.group(1))
                rep[d] = {
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(spill.group(1)) if spill else None,
                    "spill_loads": int(spill.group(2)) if spill else None,
                    "dynamic_smem_bytes": smem(d)}
        rep["wgmma_notes"] = [ln.split("ptxas info    : ")[-1][:120]
                              for ln in lines if kernel in ln and "(C75" in ln]
        check(64 in rep and 128 in rep, f"ptxas printed no {kernel}")
        out[kernel] = rep
    return out


def fa_pairs(sq: int, sk: int, causal: bool) -> int:
    """Visible (query, key) pairs of one head: the work the kernels do."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(max(0, min(sk, i + off + 1)) for i in range(sq))


def fa_inputs(torch, bh, sq, sk, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda s: torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
    return mk(sq), mk(sk), mk(sk), mk(sq)


def _row_err(torch, a, b) -> float:
    """max over rows of ||a_r - b_r|| / max(||b_r||, FA_FLOOR * rms_r
    ||b_r||), rows along the last axis."""
    a, b = a.float(), b.float()
    ref = b.norm(dim=-1)
    floor = FA_FLOOR * ref.square().mean().sqrt()
    return ((a - b).norm(dim=-1)
            / torch.maximum(ref, floor).clamp_min(1e-30)).max().item()


def _max_rel(a, b) -> float:
    """max |a - b| / max |b|: the whole-output scale, printed beside the
    row error for the planted faults."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


# the tile a planted fault skips: the last q tile's rows lose the kv tile
# before their diagonal one (a causal loop bound one tile short)
FA_FAULT_TILE = (896, 960)


def planted_faults(torch, tfa, q, k, v, o, lse, do, scale, ref):
    """Plain outputs of three faults a kernel could make at a causal
    sq == sk shape, each beside the sound plain output it should have
    given (o and the plain backward `ref`): the forward, and the dq pass,
    skip one 64-key tile for every row past it; the dk/dv pass skips one
    64-query tile."""
    lo, hi = FA_FAULT_TILE
    s = tfa._scaled_scores(q, k, True, scale)
    s[:, hi:, lo:hi] = tfa.NEG_INF
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= tfa.NEG_INF, 0.0, torch.exp2(s - m))
    o_f = ((p.to(v.dtype).float() @ v.float())
           / p.sum(-1, keepdim=True)).to(q.dtype)
    p = torch.where(s <= tfa.NEG_INF, 0.0,
                    torch.exp2(s - (lse * tfa.LOG2E)[..., None]))
    del s
    dp = do.float() @ v.float().transpose(1, 2)
    ds = (p * (dp - tfa._delta(o, do, None)[..., None]) * scale).to(q.dtype)
    del p, dp
    dq_f = (ds.float() @ k.float()).to(q.dtype)
    del ds
    do_f = do.clone()
    do_f[:, lo:hi] = 0  # no dO and no delta: the tile adds nothing
    _, dk_f, dv_f = tfa._fa_backward_plain(q, k, v, o, lse, do_f, True,
                                           scale)
    return {"forward skips a key tile": [(o_f, o)],
            "dq skips a key tile": [(dq_f, ref[0])],
            "dk/dv skip a query tile": [(dk_f, ref[1]), (dv_f, ref[2])]}


def forward_into(torch, tfa, q, k, v, causal, scale, o, lse):
    """The forward launched into the given o and lse, as the wrapper
    launches it but not counted in its launches."""
    bh, sq, d = q.shape
    tfa._check_rc(tfa._lib().fa_forward_bf16(
        *(t.data_ptr() for t in (q, k, v, o, lse)), bh, sq, k.shape[1], d,
        int(causal), scale * tfa.LOG2E,
        torch.cuda.current_stream().cuda_stream), "flash forward")


def backward_into(torch, tfa, fn, q, k, v, o, lse, do, causal, scale,
                  outs):
    """A backward entry point (`fn`: the fused one into (dq, dk, dv), the
    dq one into (dq,), the dk/dv one into (dk, dv)) launched into the
    given outputs, as the wrapper launches it but not counted in its
    launches."""
    bh, sq, d = q.shape
    delta = tfa._delta(o, do, None)
    tfa._check_rc(fn(
        *(t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)), bh, sq,
        k.shape[1], d, int(causal), scale * tfa.LOG2E, scale,
        torch.cuda.current_stream().cuda_stream), "flash backward")


def check_flash(torch, tfa):
    """Each flash kernel against its plain version on the card; returns
    {kernel: max absolute error}, over all cases and outputs.  Ends with
    the determinism check."""
    errs = {k: 0.0 for k in tfa.LAUNCHES}

    def note(kernel, pairs, tag):
        rel = max(_row_err(torch, a, b) for a, b in pairs)
        check(rel <= FA_TOL, f"{tag}: {kernel} row err {rel}")
        errs[kernel] = max([errs[kernel]] + [
            (a.float() - b.float()).abs().max().item() for a, b in pairs])
        return f"{kernel.split('_')[-1]} {rel:.2e}"

    for name, bh, sq, sk, d, causal in FA_CASES:
        q, k, v, do = fa_inputs(torch, bh, sq, sk, d, seed=len(name))
        scale = 1.0 / (d ** 0.5)
        if d % 64:
            # odd head dim: through the public API (zero-padded to 64)
            b = bh // 4
            q4, k4, v4 = (t.reshape(b, 4, -1, d).clone().requires_grad_()
                          for t in (q, k, v))
            out, lse = tfa.flash_attention_with_lse(q4, k4, v4, causal)
            out.backward(do.reshape(b, 4, sq, d))
            o, lse = out.detach().reshape(bh, sq, d), lse.reshape(bh, sq)
            grads = {tfa.backward_route(sq, sk): [
                t.grad.reshape(bh, -1, d) for t in (q4, k4, v4)]}
        else:
            o, lse = tfa._fa_forward_kernel(q, k, v, causal, scale)
            grads = {r: tfa._fa_backward_kernel(q, k, v, o, lse, do, causal,
                                                scale, None, r)
                     for r in ("fused", "split")}
        torch.cuda.synchronize()
        ro, rl = tfa._fa_forward_plain(q, k, v, causal, scale)
        ref = tfa._fa_backward_plain(q, k, v, ro, rl, do, causal, scale)
        tag = f"flash {name} ({bh}, {sq}, {sk}, {d}) causal={causal}"
        check(torch.equal(torch.isneginf(lse), torch.isneginf(rl)),
              f"{tag}: rows without keys differ (lse -inf)")
        check(bool((o[torch.isneginf(rl)] == 0).all()),
              f"{tag}: rows without keys are not 0")
        fin = torch.isfinite(rl)
        lse_err = (lse[fin] - rl[fin]).abs().max().item() if fin.any() \
            else 0.0
        check(lse_err <= FA_LSE_TOL, f"{tag}: lse err {lse_err}")
        msg = [note("flash_attention_fwd", [(o, ro)], tag),
               f"lse {lse_err:.2e}"]
        if len(grads) == 2:
            # the two routes' dq come from different kernels (mma.sync
            # tiles of 64 keys, wgmma tiles of 128 or 64), which add the
            # same k16 slices in the same order: held per row
            rel = _row_err(torch, grads["fused"][0], grads["split"][0])
            check(rel <= FA_TOL, f"{tag}: fused dq differs from the dq "
                  f"kernel's, row err {rel}")
            msg.append(f"fused dq vs split dq {rel:.2e}")
        for route, g in grads.items():
            check(all(bool(torch.isfinite(t).all()) for t in g),
                  f"{tag}: non-finite {route} gradients")
            pairs = list(zip(g, ref))
            if route == "fused":
                msg.append(note("flash_attention_bwd_fused", pairs, tag))
            else:
                msg.append(note("flash_attention_bwd_dq", pairs[:1], tag))
                msg.append(note("flash_attention_bwd_dkv", pairs[1:], tag))
        if name in FA_NAN_CASES:
            o_n, lse_n = torch.full_like(o, float("nan")), \
                torch.full_like(lse, float("nan"))
            forward_into(torch, tfa, q, k, v, causal, scale, o_n, lse_n)
            torch.cuda.synchronize()
            check(torch.equal(o_n, o) and torch.equal(
                lse_n.view(torch.int32), lse.view(torch.int32)),
                f"{tag}: the forward into NaN-filled o and lse left values "
                f"unwritten or differs from the wrapper's")
            for route, fn, want in (
                    ("fused", tfa._lib().fa_backward_fused_bf16,
                     grads["fused"]),
                    ("dq", tfa._lib().fa_backward_dq_bf16,
                     grads["split"][:1]),
                    ("dk/dv", tfa._lib().fa_backward_dkv_bf16,
                     grads["split"][1:])):
                outs = [torch.full_like(t, float("nan")) for t in want]
                backward_into(torch, tfa, fn, q, k, v, o, lse, do, causal,
                              scale, outs)
                torch.cuda.synchronize()
                check(all(bool(torch.isfinite(t).all()) for t in outs),
                      f"{tag}: the {route} backward left NaN-filled values "
                      f"unwritten")
                check(all(torch.equal(a, b) for a, b in zip(outs, want)),
                      f"{tag}: the {route} backward into NaN-filled outputs "
                      f"differs from the wrapper's")
            msg.append("forward, fused, dq and dk/dv write every value")
        print(f"{tag}: " + ", ".join(msg) + f" (worst row ||kernel - "
              f"plain|| / ||plain||, tolerance {FA_TOL})")
        if name == "gpt2":
            # the tolerance must catch faults of a typical row's size
            for fault, pairs in planted_faults(torch, tfa, q, k, v, ro, rl,
                                               do, scale, ref).items():
                row = max(_row_err(torch, a, b) for a, b in pairs)
                whole = max(_max_rel(a, b) for a, b in pairs)
                print(f"{tag}: planted fault, {fault}: row err {row:.2e} "
                      f"(max|err| / max|plain| {whole:.2e})")
                check(row > FA_TOL, f"{tag}: the tolerance {FA_TOL} misses "
                      f"the planted fault '{fault}' (row err {row})")
        del grads, ref
    # determinism: equal inputs give bitwise equal gradients, both routes
    s = FA_SHAPE
    q, k, v, do = fa_inputs(torch, s["bh"], s["sq"], s["sk"], s["d"], 7)
    o, lse = tfa._fa_forward_kernel(q, k, v, True, 0.125)
    o2, lse2 = tfa._fa_forward_kernel(q, k, v, True, 0.125)
    check(torch.equal(o, o2) and torch.equal(lse, lse2),
          "flash forward differs between two runs")
    for route in ("fused", "split"):
        a = tfa._fa_backward_kernel(q, k, v, o, lse, do, True, 0.125, None,
                                    route)
        b = tfa._fa_backward_kernel(q, k, v, o, lse, do, True, 0.125, None,
                                    route)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"flash {route} backward differs between two runs")
    print("flash: forward and both backward routes bitwise deterministic")
    # q, k, v and dO each one element into their storage (2 bytes off a
    # 16-byte boundary): the wrapper realigns them, so every output equals
    # the aligned call's bitwise
    qm, km, vm, dom = (offset1(torch, t) for t in (q, k, v, do))
    check(all(t.data_ptr() % 16 for t in (qm, km, vm, dom)),
          "the offset operands are aligned")
    om, lsem = tfa._fa_forward_kernel(qm, km, vm, True, 0.125)
    torch.cuda.synchronize()
    check(torch.equal(om, o) and torch.equal(lsem, lse),
          "flash forward of misaligned operands differs from the aligned")
    for route in ("fused", "split"):
        a = tfa._fa_backward_kernel(q, k, v, o, lse, do, True, 0.125, None,
                                    route)
        b = tfa._fa_backward_kernel(qm, km, vm, o, lse, dom, True, 0.125,
                                    None, route)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"flash {route} backward of misaligned operands differs "
              f"from the aligned")
    print("flash: q, k, v and dO at storage offset 1: forward, fused and "
          "split backward equal the aligned calls bitwise")
    return errs


# Llama-3 8B's attention at B = 1, T = 4096: 32 heads of dim 128 (GQA's kv
# heads repeated before attention), causal; past one 1024-row block, so the
# route rule sends its backward to the split pair
LLAMA_SHAPE = dict(b=1, h=32, s=4096, d=128)


def time_llama_attention(torch, tfa, b, h, s, d) -> dict:
    """The forward's and the split pair's times at (b * h, s, s, d) causal:
    the forward in turns with SDPA's forward (kernel, SDPA, SDPA, kernel)
    beside the plain forward; each backward kernel alone (delta and
    outputs made once) beside the plain backward (one timed call) and
    SDPA forward + backward at (b, h, s, d); each with its bound.  Then
    the three kernels' outputs against the plain versions', per row
    within `FA_TOL` (lse within `FA_LSE_TOL`)."""
    import torch.nn.functional as F

    bh = b * h
    q, k, v, do = fa_inputs(torch, bh, s, s, d, 13)
    scale = 1.0 / d ** 0.5
    fwd = lambda: tfa._fa_forward_kernel(q, k, v, True, scale)
    q4, k4, v4 = (t.reshape(b, h, s, d) for t in (q, k, v))
    sdpa_fwd = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True)
    turns = [cuda_ms(torch, f, 10) for f in (fwd, sdpa_fwd, sdpa_fwd, fwd)]
    o, lse = fwd()
    delta = tfa._delta(o, do, None)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = tfa._lib()
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    tail = [bh, s, s, d, 1, scale * tfa.LOG2E, scale,
            torch.cuda.current_stream().cuda_stream]
    qg, kg, vg = (t.reshape(b, h, s, d).clone().requires_grad_()
                  for t in (q, k, v))
    do4 = do.reshape(b, h, s, d)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(out, (qg, kg, vg), do4)

    pairs = fa_pairs(s, s, True) * bh
    mat, row = bh * s * d * 2, bh * s * 4
    nbytes, ops = 4 * mat + row, 2 * 2 * d * pairs
    bnd, by = bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
    res = {"flash_attention_fwd": {
        "shape": [bh, s, s, d], "ms": (turns[0] + turns[3]) / 2,
        "ms_host_paced": cuda_ms(torch, fwd, 10, False),
        "plain_ms": cuda_ms(torch, lambda: tfa._fa_forward_plain(
            q, k, v, True, scale), 1, warmup=1),
        "bound_ms": bnd, "bound_by": by, "bytes": nbytes, "flop": ops,
        "library_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}}
    lib_ms = cuda_ms(torch, sdpa_fwd_bwd, 5)
    plain_ms = cuda_ms(torch, lambda: tfa._fa_backward_plain(
        q, k, v, o, lse, do, True, scale), 1, warmup=1)
    for name, fn, outs, nbytes, ops in (
            ("flash_attention_bwd_dq", lib.fa_backward_dq_bf16, (dq,),
             5 * mat + 2 * row, 3 * 2 * d * pairs),
            ("flash_attention_bwd_dkv", lib.fa_backward_dkv_bf16, (dk, dv),
             6 * mat + 2 * row, 4 * 2 * d * pairs)):
        call = (lambda fn=fn, outs=outs, name=name: tfa._check_rc(
            fn(*ins, *(t.data_ptr() for t in outs), *tail), name))
        bnd, by = bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
        res[name] = {"shape": [bh, s, s, d], "ms": cuda_ms(torch, call, 10),
                     "ms_host_paced": cuda_ms(torch, call, 10, False),
                     "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                     "bytes": nbytes, "flop": ops, "library_ms": lib_ms}
    # the timed calls left the kernels' outputs in o, lse, dq, dk and dv
    ro, rl = tfa._fa_forward_plain(q, k, v, True, scale)
    ref = tfa._fa_backward_plain(q, k, v, ro, rl, do, True, scale)
    lse_err = (lse - rl).abs().max().item()
    check(lse_err <= FA_LSE_TOL,
          f"flash forward at {[bh, s, s, d]}: lse err {lse_err}")
    for name, pairs in (("flash_attention_fwd", [(o, ro)]),
                        ("flash_attention_bwd_dq", [(dq, ref[0])]),
                        ("flash_attention_bwd_dkv", [(dk, ref[1]),
                                                     (dv, ref[2])])):
        rel = max(_row_err(torch, a, b_) for a, b_ in pairs)
        check(rel <= FA_TOL, f"{name} at {[bh, s, s, d]}: row err {rel}")
        res[name]["row_err"] = rel
        res[name]["max_abs_err"] = max(
            (a.float() - b_.float()).abs().max().item() for a, b_ in pairs)
    res["flash_attention_fwd"]["lse_err"] = lse_err
    # the backward again through the wrapper the model launches (its own
    # delta, operands through align16), from the forward wrapper's o and lse
    wdq, wdk, wdv = tfa._fa_backward_kernel(q, k, v, o, lse, do, True, scale,
                                            None, "split")
    for name, pairs in (("flash_attention_bwd_dq", [(wdq, ref[0])]),
                        ("flash_attention_bwd_dkv", [(wdk, ref[1]),
                                                     (wdv, ref[2])])):
        rel = max(_row_err(torch, a, b_) for a, b_ in pairs)
        check(rel <= FA_TOL, f"{name} through _fa_backward_kernel at "
              f"{[bh, s, s, d]}: row err {rel}")
        res[name]["wrapper_row_err"] = rel
    return res


def time_flash(torch, tfa):
    """Each flash kernel's time at GPT-2's training shape, beside its plain
    version, its bound and scaled_dot_product_attention (a yardstick the
    port never calls); the forward and the split pair also at Llama-3
    8B's shape."""
    import torch.nn.functional as F

    s = FA_SHAPE
    bh, sq, sk, d = s["bh"], s["sq"], s["sk"], s["d"]
    q, k, v, do = fa_inputs(torch, bh, sq, sk, d, 11)
    scale = 1.0 / d ** 0.5
    o, lse = tfa._fa_forward_kernel(q, k, v, True, scale)
    pairs = fa_pairs(sq, sk, True) * bh
    mat = bh * sq * d * 2  # bytes of one (bh, s, d) bf16 operand
    row = bh * sq * 4      # bytes of lse or delta
    q4, k4, v4, do4 = (t.reshape(24, 12, -1, d) for t in (q, k, v, do))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    qg, kg, vg = (t.clone().requires_grad_() for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(out, (qg, kg, vg), do4)

    # the backward kernels alone (delta and outputs made once), so the
    # split pair's two kernels are timed apart
    delta = tfa._delta(o, do, None)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = tfa._lib()
    ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    tail = [bh, sq, sk, d, 1, scale * tfa.LOG2E, scale,
            torch.cuda.current_stream().cuda_stream]

    def launch(fn, *outs):
        return lambda: tfa._check_rc(
            fn(*ins, *(t.data_ptr() for t in outs), *tail), "flash backward")

    plain_bwd = lambda: tfa._fa_backward_plain(q, k, v, o, lse, do, True,
                                                scale)
    # the forward and SDPA's forward in turns (kernel, SDPA, SDPA, kernel):
    # the claim on the forward is their ratio, so both share the card's
    # state
    fwd = lambda: tfa._fa_forward_kernel(q, k, v, True, scale)
    turns = [cuda_ms(torch, f, 20) for f in (fwd, sdpa_fwd, sdpa_fwd, fwd)]
    lib_fwd = (turns[1] + turns[2]) / 2
    lib_bwd = cuda_ms(torch, sdpa_fwd_bwd, 10)
    rows = (  # name, fn, plain, bytes, operations (matmuls x 2 d pairs)
        ("flash_attention_fwd", fwd,
         lambda: tfa._fa_forward_plain(q, k, v, True, scale),
         4 * mat + row, 2 * 2 * d * pairs, lib_fwd),
        ("flash_attention_bwd_fused",
         launch(lib.fa_backward_fused_bf16, dq, dk, dv), plain_bwd,
         7 * mat + 2 * row, 5 * 2 * d * pairs, lib_bwd),
        ("flash_attention_bwd_dq", launch(lib.fa_backward_dq_bf16, dq),
         plain_bwd, 5 * mat + 2 * row, 3 * 2 * d * pairs, lib_bwd),
        ("flash_attention_bwd_dkv",
         launch(lib.fa_backward_dkv_bf16, dk, dv), plain_bwd,
         6 * mat + 2 * row, 4 * 2 * d * pairs, lib_bwd),
    )
    res = {}
    for name, fn, plain, nbytes, ops, lib_ms in rows:
        b, by = bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
        res[name] = {"ms": ((turns[0] + turns[3]) / 2
                            if name == "flash_attention_fwd"
                            else cuda_ms(torch, fn, 20)),
                     "ms_host_paced": cuda_ms(torch, fn, 20, False),
                     "plain_ms": cuda_ms(torch, plain, 2),
                     "bound_ms": b, "bound_by": by, "bytes": nbytes,
                     "flop": ops, "library_ms": lib_ms}
    res["flash_attention_fwd"]["turns_ms"] = turns
    # host time of one C call: the forward's launcher encodes four tensor
    # maps and queries the device, the fused backward's does neither; and
    # the forward through its wrapper (checks, output allocation)
    o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
    fwd_c = lambda: tfa._check_rc(lib.fa_forward_bf16(
        *(t.data_ptr() for t in (q, k, v, o2, lse2)), bh, sq, sk, d, 1,
        scale * tfa.LOG2E, torch.cuda.current_stream().cuda_stream),
        "flash forward")
    res["flash_attention_fwd"]["host_us"] = {
        "c_call": host_us(torch, fwd_c), "wrapper": host_us(torch, fwd)}
    res["flash_attention_bwd_fused"]["host_us"] = {
        "c_call": host_us(torch, rows[1][1])}
    # the dq and dk/dv launchers encode five and six tensor maps and query
    # the device
    res["flash_attention_bwd_dq"]["host_us"] = {
        "c_call": host_us(torch, rows[2][1])}
    res["flash_attention_bwd_dkv"]["host_us"] = {
        "c_call": host_us(torch, rows[3][1])}
    del q, k, v, do, o, lse, delta, dq, dk, dv, qg, kg, vg
    for name, t in time_llama_attention(torch, tfa, **LLAMA_SHAPE).items():
        res[name]["llama3_8b"] = t
    return res


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
    kern = device_events(torch, prof)
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


# ------------------------------------------------------------ phase 4d


def serve_worker(torch, np, cfg, params, reqs, variant="thread"):
    """Serve `reqs` through the master-backed worker: a port JobMaster on
    127.0.0.1, the requests submitted at once through a MasterClient, and
    ``ServingWorker(client, engine).run`` leasing them over loopback RPC.
    Returns (engine, tokens, metrics, launches, rpc).  The run is timed
    from the first submit to the moment the master holds the last result;
    latency and time to first token count from the submit to the master
    holding each result, as phase 4's count from the submit to the
    drain's step that finished it.  The master's queue stamps each result
    as it takes it (its `complete` wrapped).

    `variant`: "thread" runs the worker on a thread of its own while this
    thread waits for the last stamp; two diagnostics of the host-bound
    decode loop beside it: "main" runs the worker on this thread, stopped
    by the master at the last stamp (as ``python -m
    dlrover_wuqiong_tpu_torch.serving`` runs it, on its main thread);
    "poll" has this thread read the master's queue every 2 ms instead of
    the stamps (a poller that shares the interpreter lock)."""
    import threading

    from dlrover_wuqiong_tpu_torch.agent.master_client import MasterClient
    from dlrover_wuqiong_tpu_torch.common import messages as msg
    from dlrover_wuqiong_tpu_torch.master.master import JobMaster
    from dlrover_wuqiong_tpu_torch.ops import quantization as tq
    from dlrover_wuqiong_tpu_torch.serving import (
        ServeSpec,
        ServingEngine,
        ServingWorker,
    )
    from dlrover_wuqiong_tpu_torch.telemetry import spans as tspans
    from dlrover_wuqiong_tpu_torch.telemetry.serving import (
        reset_serve_ledger,
    )

    reset_serve_ledger()
    master = JobMaster(port=0, host="127.0.0.1")
    master.start()
    sub = MasterClient(master.addr, node_id=90, node_type="client")
    cli = MasterClient(master.addr, node_id=1, node_type="serve-worker")
    worker = th = None
    try:
        torch.cuda.synchronize()
        tq.reset_launches()  # counts start at 0 just before the main path
        t0 = time.monotonic()
        engine = ServingEngine(cfg, params, ServeSpec(**SPEC, quant="int8"))
        torch.cuda.synchronize()
        t_build = time.monotonic() - t0
        worker = ServingWorker(cli, engine)
        tspans.clear_spans()
        t1 = time.monotonic()
        sub.submit_serve_requests([msg.ServeRequest(
            **r, submitted_at=time.time()) for r in reqs])
        arrived = {}
        all_in = threading.Event()
        complete = master.serve_queue.complete

        def stamped_complete(results):
            now = time.monotonic() - t1
            n = complete(results)
            for res in results:
                arrived.setdefault(res.request_id, now)
            if len(arrived) >= len(reqs):
                all_in.set()
                if variant == "main":
                    worker.stop()
            return n

        if variant != "poll":
            master.serve_queue.complete = stamped_complete
        if variant == "main":
            worker.run(max_seconds=300.0)
        else:
            th = threading.Thread(target=worker.run,
                                  kwargs={"max_seconds": 300.0},
                                  daemon=True)
            th.start()
        polls = 0
        while not all_in.is_set():
            check(variant != "main" and th.is_alive()
                  and time.monotonic() - t1 < 300.0,
                  f"the worker held back results: {len(arrived)} of "
                  f"{len(reqs)} at the master")
            if variant == "thread":
                all_in.wait(1.0)
                continue
            now = time.monotonic() - t1
            for rid in master.serve_queue.export_state()["done"]:
                arrived.setdefault(rid, now)
            polls += 1
            if len(arrived) >= len(reqs):
                all_in.set()
            time.sleep(0.002)
        wall = max(arrived.values())
        worker.stop()
        if th is not None:
            th.join(timeout=60)
            check(not th.is_alive(), "the worker did not stop")
        torch.cuda.synchronize()
        launches = dict(tq.LAUNCHES)
        spans = tspans.spans_snapshot()
        snap = worker.ledger.snapshot()
        got = sub.get_serve_results([r["request_id"] for r in reqs])
        summ = sub.get_serve_summary()
    finally:
        if worker is not None:
            worker.stop()
        if th is not None:
            th.join(timeout=60)
        sub.close()
        cli.close()
        master.stop()
    done = {res.request_id: res for res in got.results}
    out = {rid: list(res.tokens) for rid, res in done.items()}
    n_tok = sum(len(v) for v in out.values())
    lat = np.array([arrived[rid] for rid in done]) * 1e3
    ttft = np.array([arrived[rid] - res.latency_s + res.ttft_s
                     for rid, res in done.items()]) * 1e3
    rpc = {}
    for name, verb in (("ServeLeaseRequest", "lease"),
                       ("ServeResultReport", "results"),
                       ("ServeStatsReport", "stats"),
                       ("ServeSubmitRequest", "submit")):
        ms = [r["dur_s"] * 1e3 for r in spans
              if r["name"].startswith("rpc:")
              and r["attrs"].get("msg") == name]
        check(ms, f"no rpc span of {verb}")
        rpc[verb] = {"calls": len(ms), "median_ms": float(np.median(ms)),
                     "min_ms": min(ms), "max_ms": max(ms),
                     "total_ms": sum(ms)}
    metrics = {
        "route": "worker",
        "requests": len(reqs),
        "finished": summ.done_total,
        "tokens_out": n_tok,
        "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "latency_p50_ms": float(np.percentile(lat, 50)),
        "latency_p99_ms": float(np.percentile(lat, 99)),
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "dispatches": engine.dispatches,
        "decode_windows": engine.dispatches - len(reqs),
        "loop_turns": worker._windows,  # noqa: SLF001
        "ms_per_decode_window": snap["states"]["decode"]
        / (engine.dispatches - len(reqs)) * 1e3,
        "ms_per_admit": snap["states"]["prefill"] / len(reqs) * 1e3,
        "idle_ms": snap["states"]["idle"] * 1e3,
        "variant": variant,
        "polls": polls,
        "engine_build_s": t_build,
    }
    return engine, out, metrics, launches, rpc


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


# ------------------------------------------------------------ phase 4b

TRAIN_B, TRAIN_T, TRAIN_STEPS = 24, 1024, 20


def train_batch(torch, vocab: int, k: int = 0, seed: int = 0,
                b: int = TRAIN_B, t: int = TRAIN_T):
    """Seeded random tokens on the card: (b, t) ids and next-token labels
    (a leading axis of K for a fused batch)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = ((k,) if k else ()) + (b, t + 1)
    x = torch.randint(0, vocab, shape, generator=gen, device="cuda")
    return {"input_ids": x[..., :-1], "labels": x[..., 1:]}


def run_steps(torch, tfa, res, batch, n: int):
    """n train steps on one batch, the launch counts set to 0 just before
    and read just after; returns (losses, grad norms, ms per step,
    launches).  One host readback, after the last step."""
    torch.cuda.synchronize()
    tfa.reset_launches()
    t0 = time.monotonic()
    metrics = []
    for _ in range(n):
        res.state, m = res.train_step(res.state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(tfa.LAUNCHES)
    vals = torch.stack([torch.stack([m["loss"], m["grad_norm"]])
                        for m in metrics]).cpu()
    return (vals[:, 0].tolist(), vals[:, 1].tolist(), wall / n * 1e3,
            launches)


def expect_launches(launches, steps, layers, fwd_per_layer, route, tag):
    want = {"flash_attention_fwd": fwd_per_layer * layers * steps,
            "flash_attention_bwd_fused": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    if route == "fused":
        want["flash_attention_bwd_fused"] = layers * steps
    else:
        want["flash_attention_bwd_dq"] = layers * steps
        want["flash_attention_bwd_dkv"] = layers * steps
    check(launches == want, f"{tag}: launches {launches} != {want}")


def device_events(torch, prof) -> list:
    """The profiler's device activities (kernels, copies, sets).  A user
    annotation such as ``Optimizer.step#AdamW.step`` also has a device
    range, over kernels that are listed on their own: it is left out, or
    its span would count twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if e.device_type == cuda and not e.is_user_annotation]


def profile_steps(torch, res, batch, n: int, ms_per_step: float,
                  table: str = "chip_smoke_train_profile.txt"):
    """Profile n steps: the device's busy time per step, its share of the
    unprofiled step time, kernels per step, device time by kind and the
    torch ops that launched the most device time.  The table goes to
    chiprun_out/<table>."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            res.state, _ = res.train_step(res.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kern = device_events(torch, prof)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", table), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    if not kern:
        return {"device_busy_ms_per_step": "not measured"}
    kinds = {"flash_attention": 0.0, "matmul": 0.0, "optimizer": 0.0,
             "other": 0.0}
    for e in kern:
        name = e.name.lower()
        kind = ("flash_attention" if "fa_fwd" in name or "fa_bwd" in name
                else "matmul" if any(w in name for w in (
                    "gemm", "cutlass", "nvjet", "xmma", "sm90"))
                else "optimizer" if "multi_tensor" in name else "other")
        kinds[kind] += e.time_range.elapsed_us()
    busy_us = sum(kinds.values())
    # one stream: its kernels cannot be busy longer than the wall clock
    check(busy_us / 1e3 <= wall_ms * 1.001, f"profile: device busy "
          f"{busy_us / 1e3:.1f} ms in {wall_ms:.1f} ms of wall clock: "
          f"some device range counts twice")
    ops = sorted((a for a in prof.key_averages()
                  if a.key.startswith("aten::")),
                 key=lambda a: -a.self_device_time_total)[:12]
    return {"device_busy_ms_per_step": busy_us / n / 1e3,
            "device_busy_share": busy_us / n / 1e3 / ms_per_step,
            "kernels_per_step": len(kern) / n,
            "device_ms_per_step_by_kind": {k: v / n / 1e3
                                           for k, v in kinds.items()},
            "device_ms_per_step_by_op": {
                a.key: a.self_device_time_total / n / 1e3 for a in ops}}


def train_phase(torch, tfa):
    """GPT-2 124M training through auto_accelerate, as bench.py drives the
    JAX package: full width and depth, bf16 compute, f32 masters,
    adamw(3e-4), B = 24, T = 1024, one fixed batch of seeded tokens."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    L = cfg.n_layer
    res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0)
    batch = train_batch(torch, 50257)
    run_steps(torch, tfa, res, batch, 2)  # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms, launches = run_steps(torch, tfa, res, batch,
                                            TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check(all(map(lambda x: x == x and abs(x) < float("inf"),
                  losses + norms)), f"non-finite loss or grad norm: "
          f"{losses} {norms}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    expect_launches(launches, TRAIN_STEPS, L, 1, "fused", "training")
    out = {"steps": TRAIN_STEPS, "batch": TRAIN_B, "seq": TRAIN_T,
           "ms_per_step": ms,
           "tokens_per_s": TRAIN_B * TRAIN_T / ms * 1e3,
           "max_memory_allocated_bytes": peak,
           "loss_first": losses[0], "loss_last": losses[-1],
           "grad_norm_first": norms[0], "grad_norm_last": norms[-1],
           "launches": launches}
    out["profile"] = profile_steps(torch, res, batch, 3, ms)
    main_launches = launches

    # the split backward pair: DWT_FA_NO_FUSED, set in this script only
    os.environ["DWT_FA_NO_FUSED"] = "1"
    try:
        l_s, _, ms_s, launches_s = run_steps(torch, tfa, res, batch, 3)
    finally:
        del os.environ["DWT_FA_NO_FUSED"]
    expect_launches(launches_s, 3, L, 1, "split", "split backward")
    check(all(x == x for x in l_s), "split run: non-finite loss")
    out["split"] = {"ms_per_step": ms_s, "launches": launches_s}

    # one fused_steps=4 call, one host readback
    fused = res.fused_train_step(4)
    batches = train_batch(torch, 50257, k=4, seed=1)
    torch.cuda.synchronize()
    tfa.reset_launches()
    t0 = time.monotonic()
    res.state, m = fused(res.state, batches)
    vals = torch.stack([m["losses"], m["grad_norms"]]).cpu()
    ms_f = (time.monotonic() - t0) / 4 * 1e3
    check(tuple(vals.shape) == (2, 4) and bool(torch.isfinite(vals).all()),
          f"fused_steps=4: {vals}")
    expect_launches(dict(tfa.LAUNCHES), 4, L, 1, "fused", "fused_steps=4")
    out["fused_steps_4"] = {"ms_per_step": ms_f, "losses": vals[0].tolist()}

    # remat "full": every block's forward runs again in the backward
    del res, fused, m
    torch.cuda.empty_cache()
    res = auto_accelerate(GPT(dataclasses.replace(cfg, remat=True)),
                          optimizer=adamw(3e-4), seed=0)
    run_steps(torch, tfa, res, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    l_r, _, ms_r, launches_r = run_steps(torch, tfa, res, batch, 3)
    expect_launches(launches_r, 3, L, 2, "fused", "remat full")
    check(all(x == x for x in l_r), "remat run: non-finite loss")
    out["remat_full"] = {"ms_per_step": ms_r, "launches": launches_r,
                         "max_memory_allocated_bytes":
                         torch.cuda.max_memory_allocated()}
    del res
    torch.cuda.empty_cache()
    return out, main_launches, launches_s


# ------------------------------------------------------------ phase 4c

# Llama-3 8B at its published width, 4 of its 32 layers (one pipeline
# stage's share of 8), B = 1 at its 4096-token training length
LLAMA_LAYERS, LLAMA_B, LLAMA_T, LLAMA_STEPS = 4, 1, 4096, 5
# The flash route's 7 losses (2 warm-up steps, then the 5 counted) against
# the einsum branch's (plain torch attention, no kernel) from the same
# seed and batch, relative.  Both run bf16; they differ by where bf16
# rounds inside attention, and adamw(3e-4) at this width swings the loss
# by ~3 a step (Adam's sign-like first steps overshoot: the einsum branch
# swings the same way), which carries that rounding forward.  On an H100
# 80GB HBM3 at 700 W the two read 2.2e-3 apart at most over the 7 steps
# (PERF.md); a kernel that is wrong on most rows moves the first step's
# gradient, and the trajectory, by far more.
LLAMA_LOSS_RTOL = 1e-2


def llama_model_flop(cfg, n_dense: int, tokens: int) -> int:
    """Model FLOP of one training step, remat recompute not counted: 6 per
    dense parameter and token, and attention's two products per (query,
    key) pair in the forward, three times that with the backward."""
    pairs = fa_pairs(LLAMA_T, LLAMA_T, True) * (tokens // LLAMA_T)
    attn = 3 * 2 * 2 * cfg.head_dim * pairs * cfg.num_heads * cfg.num_layers
    return 6 * n_dense * tokens + attn


def llama_train_phase(torch, tfa):
    """Llama-3 8B (4 layers, full width) training through auto_accelerate:
    bf16 compute over float32 masters, remat "full", the flash route,
    adamw(3e-4), B = 1, T = 4096, one fixed batch of seeded tokens.  At T =
    4096 the route rule sends the backward to the split dq and dk/dv
    kernels; remat runs each block's forward twice."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_layers=LLAMA_LAYERS)
    check(cfg.remat and cfg.remat_policy == "full" and cfg.use_flash_attention
          and cfg.dtype == torch.bfloat16 and cfg.head_dim == 128,
          f"Llama-3 8B preset changed: {cfg}")
    check(tfa.backward_route(LLAMA_T, LLAMA_T) == "split",
          "the route rule does not send T = 4096 to the split pair")
    t0 = time.monotonic()
    res = auto_accelerate(Llama(cfg), optimizer=adamw(3e-4), seed=0)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    params = list(res.model.named_parameters())
    n_params = sum(p.numel() for _, p in params)
    check(n_params == cfg.num_params(),
          f"{n_params} parameters, num_params() says {cfg.num_params()}")
    n_dense = sum(p.numel() for n, p in params
                  if p.dim() == 2 and not n.startswith("embed_tokens"))
    batch = train_batch(torch, cfg.vocab_size, b=LLAMA_B, t=LLAMA_T)
    # warm-up: cuBLAS, allocator
    warm, _, _, _ = run_steps(torch, tfa, res, batch, 2)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms, launches = run_steps(torch, tfa, res, batch,
                                            LLAMA_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check(all(map(lambda x: x == x and abs(x) < float("inf"),
                  losses + norms)), f"Llama: non-finite loss or grad norm: "
          f"{losses} {norms}")
    # adamw(3e-4) with no warm-up overshoots at this width: the loss goes
    # up and down from one step to the next, so the last step against the
    # first would pass or fail with the window's parity.  Two neighbouring
    # steps hold one high and one low, so the mean of the last two against
    # the mean of the first two reads the trend whatever the length.
    head, tail = sum(losses[:2]) / 2, sum(losses[-2:]) / 2
    check(tail < head, f"Llama: the mean loss of the last two steps "
          f"{tail} is not below the first two's {head}: {losses}")
    expect_launches(launches, LLAMA_STEPS, LLAMA_LAYERS, 2, "split",
                    "Llama-3 8B training")
    tokens = LLAMA_B * LLAMA_T
    flop = llama_model_flop(cfg, n_dense, tokens)
    out = {"layers": LLAMA_LAYERS, "steps": LLAMA_STEPS, "batch": LLAMA_B,
           "seq": LLAMA_T, "params": n_params, "dense_params": n_dense,
           "init_s": init_s, "ms_per_step": ms,
           "tokens_per_s": tokens / ms * 1e3,
           "model_tflop_per_step": flop / 1e12,
           "model_tflop_per_s": flop / ms / 1e9,
           "max_memory_allocated_bytes": peak,
           "losses": losses, "grad_norms": norms, "launches": launches}
    out["profile"] = profile_steps(torch, res, batch, 3, ms,
                                   "chip_smoke_llama_profile.txt")
    del res, params
    torch.cuda.empty_cache()

    # the same model and steps on the einsum branch: no flash kernel
    res = auto_accelerate(Llama(dataclasses.replace(
        cfg, use_flash_attention=False)), optimizer=adamw(3e-4), seed=0)
    warm_e, _, _, _ = run_steps(torch, tfa, res, batch, 2)
    l_e, _, ms_e, launches_e = run_steps(torch, tfa, res, batch,
                                         LLAMA_STEPS)
    check(sum(launches_e.values()) == 0,
          f"the einsum branch launched flash kernels: {launches_e}")
    flash_l, einsum_l = warm + losses, warm_e + l_e
    rel = max(abs(a - b) / abs(b) for a, b in zip(flash_l, einsum_l))
    check(rel <= LLAMA_LOSS_RTOL, f"Llama: flash route losses {flash_l} "
          f"differ from the einsum branch's {einsum_l} by {rel} relative")
    out["einsum_reference"] = {"ms_per_step": ms_e, "losses": einsum_l,
                               "flash_losses": flash_l,
                               "max_relative_loss_difference": rel}
    del res
    torch.cuda.empty_cache()
    return out, launches


# ------------------------------------------------------------ phase 5b

# Tolerances of the nano training reference, card against CPU.  Both run
# float32 with TF32 off, except attention: by the dtype contract of
# models/attention.py the card rounds q, k and v to bf16 for the kernels,
# while the CPU's plain versions stay float32.  That rounding (2^-9
# relative per value) is the whole expected difference, so the limits are
# a few times its measured reading on an H100 (PERF.md: logits 3.1e-3,
# worst gradient 5.5e-3, losses 3.1e-5): the first step's logits and
# each parameter's gradient, as ||card - cpu|| / ||cpu|| of the worst
# leaf, within NANO_GRAD_RTOL; the losses of 3 adamw steps within
# NANO_LOSS_RTOL relative.  A kernel that is wrong on most rows moves the
# attention weights' gradients by far more.
NANO_GRAD_RTOL = 2e-2
NANO_LOSS_RTOL = 3e-4


def train_reference(torch, np, tfa):
    """GPT nano, float32 masters and compute, on the card (kernels)
    against the CPU (plain versions), from the same params and batches:
    the first step's logits and gradients, then 3 adamw steps.  Returns
    the worst relative differences and the losses."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.models.gpt import (
        GPT,
        GPTConfig,
        init_params,
    )

    cfg = dataclasses.replace(GPTConfig.nano(), dtype=torch.float32)
    params = init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 129)))
               for _ in range(3)]
    return card_vs_cpu(torch, tfa, lambda: GPT(cfg), params, batches,
                       "nano")


def card_vs_cpu(torch, tfa, make_model, params, batches, tag):
    """A float32 model from `params` on the card (kernels) against the CPU
    (plain versions), on the same batches: the first step's logits and
    gradients, then one adamw step a batch.  Returns the worst relative
    differences, the losses and the card's kernel launches."""
    from dlrover_wuqiong_tpu_torch.convert import load_params
    from dlrover_wuqiong_tpu_torch.trainer.train_step import (
        TrainState,
        adamw,
        make_lm_loss,
        make_train_step,
    )

    loss_fn = make_lm_loss()
    losses, launches, logits, grads = {}, {}, {}, {}
    for device in ("cpu", "cuda"):
        model = load_params(make_model(), params, device)
        tfa.reset_launches()
        b = batches[0].to(device)
        first = {"input_ids": b[:, :-1], "labels": b[:, 1:]}
        with torch.no_grad():
            logits[device] = model(first["input_ids"]).float().cpu()
        loss_fn(model, first).backward()
        grads[device] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        state = TrainState.create(model, adamw(3e-4))
        step = make_train_step(loss_fn)
        out = []
        for b in batches:
            b = b.to(device)
            state, m = step(state, {"input_ids": b[:, :-1],
                                    "labels": b[:, 1:]})
            out.append(m["loss"].item())
        losses[device], launches[device] = out, dict(tfa.LAUNCHES)
    check(sum(launches["cpu"].values()) == 0
          and sum(launches["cuda"].values()) > 0,
          f"{tag} reference launches {launches}")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    logit_err = rel(logits["cuda"], logits["cpu"])
    leaf, grad_err = max(((n, rel(g, grads["cpu"][n]))
                          for n, g in grads["cuda"].items()),
                         key=lambda x: x[1])
    check(max(logit_err, grad_err) <= NANO_GRAD_RTOL,
          f"{tag} first step differs card vs CPU: logits {logit_err}, "
          f"gradient of {leaf} {grad_err}")
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"],
                                                       losses["cuda"]))
    check(loss_err <= NANO_LOSS_RTOL, f"{tag} training losses differ card "
          f"vs CPU: {losses}")
    return {"logits": logit_err, "worst_grad": grad_err,
            "worst_grad_leaf": leaf, "loss": loss_err}, losses, \
        launches["cuda"]


# ------------------------------------------------------------ phase 5c


def llama_reference(torch, np, tfa):
    """A small Llama in float32 on the card against the CPU, as
    `train_reference` holds GPT nano: 2 layers, hidden 256, 2 heads of
    Llama-3's dim 128 over 1 kv head (GQA), vocab 512, B = 1 and T = 2048,
    so the card takes the split dq and dk/dv kernels at D = 128 (checked
    by their launches; no fused launch)."""
    from dlrover_wuqiong_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        init_params,
    )

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=2, num_kv_heads=1,
                      max_seq_len=2048, dtype=torch.float32)
    params = init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2049)))
               for _ in range(3)]
    errs, losses, launches = card_vs_cpu(torch, tfa, lambda: Llama(cfg),
                                         params, batches, "small Llama")
    check(launches["flash_attention_bwd_dq"] > 0
          and launches["flash_attention_bwd_dkv"] > 0
          and launches["flash_attention_bwd_fused"] == 0,
          f"small Llama did not take the split route: {launches}")
    return errs, losses


# ------------------------------------------------------------ phase 7

CKPT_SAVES = 5      # timed saves, each drained and committed before the next
CKPT_RESTORES = 2   # timed restores a tier, beside phase 7.1's one
RATE_BYTES = 256 << 20  # the rate probes' buffer


def stats(xs) -> dict:
    """p50 and [min, max] of a list of numbers."""
    s = sorted(xs)
    mid = len(s) // 2
    p50 = s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2
    return {"p50": p50, "min": s[0], "max": s[-1], "n": len(s)}


@contextlib.contextmanager
def ckpt_workspace(prefix: str):
    """A checkpoint directory and a socket directory of the run's own,
    yielded as (ckpt_dir, checkpointers) and torn down on the way out,
    whatever happened: each checkpointer put in the list is closed, the
    in-process saver reset (which unlinks its segments) and both
    directories removed.  The saver queue's and the shm locks' sockets go
    under DWT_SOCKET_DIR, which common/multi_process reads when it is
    first imported, so enter this before anything imports checkpoint/."""
    import shutil
    import tempfile

    check("dlrover_wuqiong_tpu_torch.common.multi_process"
          not in sys.modules,
          "the checkpoint was imported before its socket directory was set")
    prev = os.environ.get("DWT_SOCKET_DIR")
    sock_dir = tempfile.mkdtemp(prefix=prefix + "sock-")
    os.environ["DWT_SOCKET_DIR"] = sock_dir
    ckpt_dir = tempfile.mkdtemp(prefix=prefix)
    opened = []
    try:
        yield ckpt_dir, opened
    finally:
        try:
            from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
                AsyncCheckpointSaver,
            )

            for ck in opened:
                ck.close()
            AsyncCheckpointSaver.reset()
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            shutil.rmtree(sock_dir, ignore_errors=True)
            if prev is None:
                os.environ.pop("DWT_SOCKET_DIR", None)
            else:
                os.environ["DWT_SOCKET_DIR"] = prev


def ckpt_host(ckpt_dir: str) -> dict:
    """What the phase depends on: /dev/shm and the checkpoint directory's
    filesystem (``df``), the host's memory, and the digest in use (crc32c
    where ``google_crc32c`` imports, else zlib crc32)."""
    import shutil

    from dlrover_wuqiong_tpu_torch.checkpoint.integrity import DIGEST_ALGO

    df = subprocess.run(["df", "-h", "/dev/shm", ckpt_dir],
                        capture_output=True, text=True, timeout=60)
    with open("/proc/meminfo") as f:
        mem = dict(line.split(":", 1) for line in f)
    return {
        "df": df.stdout.strip().splitlines(),
        "dev_shm_free_bytes": shutil.disk_usage("/dev/shm").free,
        "ckpt_dir_free_bytes": shutil.disk_usage(ckpt_dir).free,
        "mem_total_bytes": int(mem["MemTotal"].split()[0]) << 10,
        "mem_available_bytes": int(mem["MemAvailable"].split()[0]) << 10,
        "digest_algo": DIGEST_ALGO, "host_cpus": os.cpu_count()}


def ckpt_fits(host: dict, state_bytes: int, tag: str):
    """Fail, naming the sizes, when the host cannot hold the staged state:
    its shm segment, its pinned drain buffer, and two generations on
    disk.  The state is never shrunk to fit."""
    seg = state_bytes + (1 << 20)
    check(host["dev_shm_free_bytes"] >= seg,
          f"{tag}: /dev/shm has {host['dev_shm_free_bytes']} bytes free; "
          f"the segment needs {seg}")
    check(host["mem_available_bytes"] >= 3 * seg,
          f"{tag}: the host has {host['mem_available_bytes']} bytes "
          f"available; the segment, the pinned drain buffer and a restore "
          f"need {3 * seg}")
    check(host["ckpt_dir_free_bytes"] >= 2 * seg,
          f"{tag}: the checkpoint directory has "
          f"{host['ckpt_dir_free_bytes']} bytes free; two generations "
          f"(the one kept and the one written) need {2 * seg}")


def loopback_rate(buf) -> float:
    """Bytes/s of one loopback TCP transfer of `buf` (``sendall`` into a
    receiving thread's ``recv_into`` of a buffer of its size), as the
    replica ring moves a segment."""
    import socket
    import threading

    n = len(buf)
    srv = socket.create_server(("127.0.0.1", 0))
    dst = bytearray(n)

    def recv():
        conn, _ = srv.accept()
        with conn:
            view, got = memoryview(dst), 0
            while got < n:
                k = conn.recv_into(view[got:], min(1 << 20, n - got))
                check(k > 0, "loopback probe: the peer closed early")
                got += k

    t = threading.Thread(target=recv)
    t.start()
    t0 = time.perf_counter()
    with socket.create_connection(srv.getsockname()) as c:
        c.sendall(memoryview(buf))
        t.join()
    elapsed = time.perf_counter() - t0
    srv.close()
    return n / elapsed


def ckpt_rates(torch, ckpt_dir: str, n: int = RATE_BYTES) -> dict:
    """This host's rates, bytes/s, on one n-byte buffer: pinned D2H and
    H2D copies (CUDA events, best of 3), a host memcpy, the checkpoint
    digest (`digest_bytes`, as staging and persist call it), a write +
    fsync into the checkpoint directory and a loopback TCP transfer
    (best of 3)."""
    import numpy as np

    from dlrover_wuqiong_tpu_torch.checkpoint.integrity import digest_bytes

    dev = torch.randint(0, 255, (n,), dtype=torch.uint8, device="cuda")
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)

    def copy_rate(dst, src):
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return n / best

    out = {"bytes": n, "d2h_pinned": copy_rate(pinned, dev),
           "h2d_pinned": copy_rate(dev, pinned)}
    src = pinned.numpy()
    dst = np.ones(n, np.uint8)  # touched: no page faults in the copy
    t0 = time.perf_counter()
    np.copyto(dst, src)
    out["host_memcpy"] = n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    digest_bytes(src)
    out["digest"] = n / (time.perf_counter() - t0)
    path = os.path.join(ckpt_dir, "rate.bin")
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(memoryview(src))
        f.flush()
        os.fsync(f.fileno())
    out["disk_write_fsync"] = n / (time.perf_counter() - t0)
    os.remove(path)
    out["loopback_tcp"] = max(loopback_rate(src) for _ in range(3))
    return out


def ckpt_bounds(state_bytes: int, rates: dict) -> dict:
    """Least seconds for each stage at this run's rates, the stage's work
    done one pass after another as the code does it: the snapshot reads
    and writes the state in HBM; the drain copies it to the host, into
    the segment and digests it; the persist digests it and writes it;
    a shm restore copies it out of the segment and digests it; the H2D
    fills the pinned buffer and copies it to the card."""
    b = state_bytes
    return {
        "snapshot_ms": 2 * b / HBM_BYTES_PER_S * 1e3,
        "drain_s": b / rates["d2h_pinned"] + b / rates["host_memcpy"]
        + b / rates["digest"],
        "persist_s": b / rates["digest"] + b / rates["disk_write_fsync"],
        "restore_shm_verify_s": b / rates["host_memcpy"] + b / rates["digest"],
        "restore_h2d_s": b / rates["host_memcpy"] + b / rates["h2d_pinned"],
        "d2h_s": b / rates["d2h_pinned"], "h2d_s": b / rates["h2d_pinned"],
        "digest_s": b / rates["digest"],
        "disk_write_s": b / rates["disk_write_fsync"],
        # the replica ring (checkpoint/replica.py): a backup copies the
        # segment out, digests it and sends it; a fetch receives and
        # digests; a restore also copies into the segment; the engine's
        # load by tier "replica" is a restore, then the shm tier's verify
        "loopback_s": b / rates["loopback_tcp"],
        "ring_backup_s": b / rates["host_memcpy"] + b / rates["digest"]
        + b / rates["loopback_tcp"],
        "ring_fetch_s": b / rates["loopback_tcp"] + b / rates["digest"],
        "ring_restore_s": b / rates["loopback_tcp"] + b / rates["digest"]
        + b / rates["host_memcpy"],
        "restore_replica_verify_s": b / rates["loopback_tcp"]
        + b / rates["digest"] + 2 * b / rates["host_memcpy"]
        + b / rates["digest"]}


def tree_bytes(torch, tree) -> int:
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        flatten_state_dict,
    )

    return sum(t.numel() * t.element_size()
               for t in flatten_state_dict(tree).values())


def timed_step(torch, res, batch) -> float:
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res.state, _ = res.train_step(res.state, batch)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3


def prune_generations(ckpt_dir: str, keep: int):
    """Drop committed generations older than `keep`, so that at most two
    lie on disk at once (the measuring machine caps a run's disk writes;
    freed blocks are written again; the saver itself keeps every one)."""
    import shutil

    for name in os.listdir(ckpt_dir):
        if name.startswith("checkpoint-") and int(name.split("-")[1]) < keep:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def time_saves(torch, ck, res, batch, saves: int) -> list:
    """`saves` rounds, in turns: a step alone; a step followed by a save
    (the saving step, ending in a synchronise, so the snapshot's copy is
    in it); a step while that save's drain is in flight.  Then the drain
    (save call to `wait_staging`) and the persist (save call to the step
    committed) are timed, and the older generations pruned, so no save
    meets the chain bound."""
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import StorageType

    rows = []
    for _ in range(saves):
        plain_ms = timed_step(torch, res, batch)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res.state, _ = res.train_step(res.state, batch)
        t_save = time.monotonic()
        step = int(res.state.step)
        blocked = ck.save_checkpoint(step, res.state.tree(),
                                     StorageType.DISK)
        torch.cuda.synchronize()
        saving_ms = (time.monotonic() - t0) * 1e3
        drain_step_ms = timed_step(torch, res, batch)
        # the drain records its stage time when it ends
        in_flight = "stage_s" not in ck.engine.last_snapshot.timing
        ck.wait_staging()
        drain_s = time.monotonic() - t_save
        check(ck.wait_latest_checkpoint(600), f"step {step} not committed")
        persist_s = time.monotonic() - t_save
        snap = ck.engine.last_snapshot
        rows.append({"step": step, "blocked_s": blocked,
                     "snapshot_device_ms": snap.device_ms(),
                     "drain_s": drain_s, "persist_s": persist_s,
                     "plain_step_ms": plain_ms, "saving_step_ms": saving_ms,
                     "drain_step_ms": drain_step_ms,
                     "drain_in_flight_after_step": in_flight, **snap.timing})
        prune_generations(ck.checkpoint_dir, step)
    return rows


def time_chain(torch, ck, res, batch) -> dict:
    """One save made while the previous one still drains: the second
    blocks only for its snapshot (the chain holds two), and its drain
    waits out the first.  Both stage to shm only (the chain is the
    drains'; a persist each would put three generations on disk)."""
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import StorageType

    res.state, _ = res.train_step(res.state, batch)
    b1 = ck.save_checkpoint(int(res.state.step), res.state.tree(),
                            StorageType.MEMORY)
    first = ck.engine.last_snapshot
    res.state, _ = res.train_step(res.state, batch)
    check("stage_s" not in first.timing,
          "the first save's drain ended within one step: no chain")
    t0 = time.monotonic()
    b2 = ck.save_checkpoint(int(res.state.step), res.state.tree(),
                            StorageType.MEMORY)
    snap = ck.engine.last_snapshot
    ck.wait_staging()
    out = {"first_blocked_s": b1, "second_blocked_s": b2,
           "second_to_staged_s": time.monotonic() - t0, **snap.timing}
    check(out.get("chain_wait_s", 0.0) > 0,
          f"the second drain did not wait for the first: {out}")
    return out


def time_snapshot(torch, engine, tree, n: int) -> list:
    """The snapshot's device time back to back, ms: the card sleeps while
    the host allocates the slabs and enqueues their copies (a saving
    step's events time the copies as the host issues them)."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        snap = engine._device_snapshot(tree)
        out.append(snap.device_ms())
        del snap
    return out


def timed_restore(torch, ck, state, tier: str) -> dict:
    """One restore through the checkpointer's two halves: the verified
    load (read, digest, assemble; for storage also the self-heal restage
    into shm) and the copy into the state's tensors (pinned fill + H2D)."""
    from dlrover_wuqiong_tpu_torch.checkpoint.engine import restore_tree

    ck.set_preferred_tier("" if tier == "shm" else tier)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    flat = ck.engine.load()
    t1 = time.monotonic()
    restore_tree(state, flat)
    t2 = time.monotonic()
    rep = ck.last_restore_report
    check(rep.get("tier") == tier, f"restore from {tier}: report {rep}")
    return {"verify_s": t1 - t0, "h2d_s": t2 - t1, "step": rep["step"]}


RING_REPEATS = 3    # timed calls of each replica-ring stage


def ring_run(torch, ck, mgr, srv, res, batch, health) -> dict:
    """Phase 7.4: the replica ring on the state in the segment (the last
    committed step, re-staged by 7.2's storage restores), with `srv` (a
    ReplicaServer thread of this process) as rank 1, the holder of rank
    0's backups.  A restore from shm and one step give the reference;
    then `RING_REPEATS` timed backups, verified fetches, restores into
    shm and engine loads by tier "replica" (verified load and H2D apart),
    and one step from the last, which must be bitwise the reference's.
    Then one byte of the held blob is flipped: the load must fall through
    to storage, list the replica fallback, fire the health hook, and its
    step too must be bitwise."""
    from dlrover_wuqiong_tpu_torch.checkpoint.engine import restore_tree

    def one_step():
        res.state, m = res.train_step(res.state, batch)
        return torch.stack([m["loss"], m["grad_norm"]]).cpu()

    ref = timed_restore(torch, ck, res.state, "shm")
    step = ref["step"]
    want = one_step()
    out = {"step": step, "backup_s": [], "backup_parts": [], "fetch_s": [],
           "restore_s": []}
    for _ in range(RING_REPEATS):
        t0 = time.monotonic()
        copies = mgr.backup()
        out["backup_s"].append(time.monotonic() - t0)
        out["backup_parts"].append(dict(mgr.last_backup))
        check(copies == 1, f"ring: backup landed {copies} copies")
    for _ in range(RING_REPEATS):
        t0 = time.monotonic()
        got = mgr.fetch_peer(0)
        out["fetch_s"].append(time.monotonic() - t0)
        check(got is not None and got[0] == step,
              f"ring: fetch_peer gave {got and got[0]}, not step {step}")
        out["blob_bytes"] = len(got[1])
        del got
    for _ in range(RING_REPEATS):
        t0 = time.monotonic()
        got = mgr.restore()
        out["restore_s"].append(time.monotonic() - t0)
        check(got == step, f"ring: restore gave step {got}, not {step}")
    loads = [timed_restore(torch, ck, res.state, "replica")
             for _ in range(RING_REPEATS)]
    out["load_verify_s"] = [r["verify_s"] for r in loads]
    out["load_h2d_s"] = [r["h2d_s"] for r in loads]
    check(all(r["step"] == step for r in loads),
          f"ring: replica loads at steps {[r['step'] for r in loads]}")
    got = one_step()
    check(torch.equal(got, want), f"ring: the step after the replica "
          f"load {got.tolist()} != {want.tolist()}")
    out["resumed_bitwise"] = True

    with srv._lock:
        held_step, blob = srv._store[0]
        bad = bytearray(blob)
        bad[1 << 20] ^= 0xFF
        srv._store[0] = (held_step, bytes(bad))
    del blob, bad
    n_health = len(health)
    ck.set_preferred_tier("replica")
    t0 = time.monotonic()
    flat = ck.engine.load()
    restore_tree(res.state, flat)
    out["corrupt_load_s"] = time.monotonic() - t0
    del flat
    rep = ck.last_restore_report
    ck.set_preferred_tier("")
    out["corrupt_report"] = {k: rep.get(k) for k in ("tier", "step",
                                                      "fallbacks", "healed")}
    check((rep["tier"], rep["step"]) == ("storage", step),
          f"ring: the corrupt blob's load came from {rep['tier']} step "
          f"{rep['step']}")
    check(any(f["tier"] == "replica" for f in rep["fallbacks"]),
          f"ring: no replica fallback listed: {rep['fallbacks']}")
    check(len(health) > n_health, "ring: the health hook did not fire")
    out["health"] = health[n_health:]
    got = one_step()
    check(torch.equal(got, want), f"ring: the step after the storage "
          f"fallback {got.tolist()} != {want.tolist()}")
    return out


def summarize(rows, restores, snapshot_ms) -> dict:
    """p50 and [min, max] of every timed quantity."""
    out = {k: stats([r[k] for r in rows]) for k in (
        "blocked_s", "snapshot_device_ms", "drain_s", "d2h_s", "stage_s",
        "persist_s", "plain_step_ms", "saving_step_ms", "drain_step_ms")}
    out["snapshot_back_to_back_ms"] = stats(snapshot_ms)
    for t, rs in restores.items():
        for k in ("verify_s", "h2d_s"):
            out[f"restore_{t}_{k}"] = stats([r[k] for r in rs])
    return out


def ckpt_phase(torch, tfa) -> tuple:
    """Phase 7: GPT-2 124M's training state through the flash checkpoint.
    Returns (report, launches of the resumed steps)."""
    with ckpt_workspace("dwt-ckpt-smoke-") as (ckpt_dir, opened):
        return ckpt_run(torch, tfa, ckpt_dir, opened)


def ckpt_run(torch, tfa, ckpt_dir: str, opened: list) -> tuple:
    """Phase 7's body in its workspace (`ckpt_workspace`)."""
    import dataclasses
    import shutil

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.checkpoint import drill
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
        FlashCheckpointer,
        StorageType,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        AsyncCheckpointSaver,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.replica import (
        CkptReplicaManager,
        ReplicaServer,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        flatten_state_dict,
    )
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    L = cfg.n_layer
    job = f"dwt-smoke-{os.getpid()}"
    out = {"host": ckpt_host(ckpt_dir)}
    print("checkpoint host: " + json.dumps(out["host"]))
    res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0)
    batch = drill.fixed_batch(drill.VOCAB["gpt2"], TRAIN_B, TRAIN_T, "cuda")
    check(torch.equal(batch["input_ids"],
                      train_batch(torch, 50257)["input_ids"]),
          "the checkpoint batch is not phase 4b's")
    nbytes = tree_bytes(torch, res.state.tree())
    check(nbytes == cfg.num_params() * 12 + 8 + 4,
          f"GPT-2 124M's training state is {nbytes} bytes")
    ckpt_fits(out["host"], nbytes, "GPT-2 124M")
    out["state_bytes"] = nbytes
    rates = ckpt_rates(torch, ckpt_dir)
    out["rates_bytes_per_s"] = rates
    out["bounds"] = bounds = ckpt_bounds(nbytes, rates)

    # 7.1: 2 warm-up steps and 3, a save, steps 6-7; restore into a model
    # from seed 1 from each tier and run steps 6-7 again
    AsyncCheckpointSaver.reset()
    # the replica ring of 7.4: this process is rank 0, a ReplicaServer
    # thread rank 1 (the holder of its backups)
    srv = ReplicaServer(host="127.0.0.1")
    srv.start()
    opened.append(types.SimpleNamespace(close=srv.stop))
    health = []
    mgr = CkptReplicaManager(
        rank=0, peers={1: f"127.0.0.1:{srv.port}"}, job_name=job,
        replica_count=1, health_hook=health.append,
        quarantine_dir=os.path.join(ckpt_dir, "replica-quarantine"))
    opened.append(mgr)
    ck = FlashCheckpointer(ckpt_dir, job_name=job, standalone=True,
                           replica_fetch=mgr.restore)
    opened.append(ck)
    metrics = []
    for _ in range(5):
        res.state, m = res.train_step(res.state, batch)
        metrics.append(m)
    blocked = ck.save_checkpoint(5, res.state.tree(), StorageType.DISK)
    saved = {n: t.detach().clone()
             for n, t in flatten_state_dict(res.state.tree()).items()}
    for _ in range(2):
        res.state, m = res.train_step(res.state, batch)
        metrics.append(m)
    run = torch.stack([torch.stack([m["loss"], m["grad_norm"]])
                       for m in metrics]).cpu()
    check(ck.wait_latest_checkpoint(600), "step 5 was not committed")
    out["uninterrupted"] = {"losses": run[:, 0].tolist(),
                            "grad_norms": run[:, 1].tolist(),
                            "save_blocked_s": blocked}
    res2 = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=1)
    launches = {}
    for tier in ("shm", "storage"):
        ck.set_preferred_tier("" if tier == "shm" else "storage")
        t0 = time.monotonic()
        tree = res2.state.tree()
        check(ck.load_checkpoint(tree) is tree, f"{tier}: no checkpoint")
        load_s = time.monotonic() - t0
        rep = ck.last_restore_report
        check((rep["tier"], rep["step"]) == (tier, 5),
              f"restore from {tier}: report {rep}")
        got = flatten_state_dict(res2.state.tree())
        bad = [n for n, t in saved.items() if not torch.equal(got[n], t)]
        check(not bad, f"{tier}: {len(bad)} leaves differ from the saved "
              f"state, first {bad[:3]}")
        check(all(float(s["step"]) == 5.0
                  for s in res2.state.opt_state.state.values()),
              f"{tier}: AdamW's step counts were not restored")
        torch.cuda.synchronize()
        tfa.reset_launches()
        resumed = []
        for _ in range(2):
            res2.state, m = res2.train_step(res2.state, batch)
            resumed.append(torch.stack([m["loss"], m["grad_norm"]]))
        torch.cuda.synchronize()
        launches[tier] = dict(tfa.LAUNCHES)
        resumed = torch.stack(resumed).cpu()
        check(torch.equal(resumed, run[5:]),
              f"{tier}: resumed steps 6-7 {resumed.tolist()} != the "
              f"uninterrupted {run[5:].tolist()}")
        expect_launches(launches[tier], 2, L, 1, "fused",
                        f"resumed from {tier}")
        out[f"resumed_{tier}"] = {"load_checkpoint_s": load_s,
                                  "losses": resumed[:, 0].tolist()}
    del saved

    # 7.2: the card's own times, each beside its bound
    rows = time_saves(torch, ck, res, batch, CKPT_SAVES)
    out["saves"] = rows
    out["snapshot_back_to_back_ms"] = time_snapshot(
        torch, ck.engine, res.state.tree(), CKPT_SAVES)
    out["chain"] = time_chain(torch, ck, res, batch)
    restores = {t: [timed_restore(torch, ck, res2.state, t)
                    for _ in range(CKPT_RESTORES)]
                for t in ("shm", "storage")}
    out["restores"] = restores
    out["summary"] = summarize(rows, restores, out[
        "snapshot_back_to_back_ms"])

    # 7.4: the replica ring (the server holds a copy of the state, a
    # fetch another: the host must hold both beside the segment)
    check(ckpt_host(ckpt_dir)["mem_available_bytes"] >= 4 * nbytes,
          f"ring: the host has not 4 x {nbytes} bytes available")
    out["ring"] = ring = ring_run(torch, ck, mgr, srv, res2, batch, health)
    for k in ("backup_s", "fetch_s", "restore_s", "load_verify_s",
              "load_h2d_s"):
        out["summary"][f"ring_{k}"] = stats(ring[k])
    for k in ("copy_s", "verify_s", "send_s"):
        out["summary"][f"ring_backup_{k}"] = stats(
            [p[k] for p in ring["backup_parts"]])
    ck.close()
    AsyncCheckpointSaver.reset()
    mgr.close()
    srv.stop()

    # 7.1, bf16 wire (to shm: the CPU tests pin the files): float32
    # leaves come back as their bf16 round trip, int leaves exactly
    ckb = FlashCheckpointer(os.path.join(ckpt_dir, "wire"),
                            job_name=f"{job}-wire", standalone=True,
                            wire_dtype="bf16")
    opened.append(ckb)
    ckb.save_checkpoint(int(res.state.step), res.state.tree(),
                        StorageType.MEMORY)
    ckb.load_checkpoint(res2.state)
    src = flatten_state_dict(res.state.tree())
    got = flatten_state_dict(res2.state.tree())
    bad = [n for n, t in src.items() if not torch.equal(
        got[n], t.bfloat16().float() if t.dtype == torch.float32 else t)]
    check(not bad, f"bf16 wire: {len(bad)} leaves are not the bf16 round "
          f"trip (floats) or exact (ints), first {bad[:3]}")
    out["bf16_wire"] = {"leaves": len(src), "tier": ckb.last_restore_report[
        "tier"]}
    ckb.close()
    AsyncCheckpointSaver.reset()
    del res, res2, src, got, metrics
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # 7.3: the SIGKILL drill, GPT-2 124M on the card
    d = drill.sigkill_drill(model="gpt2", device="cuda", batch=TRAIN_B,
                            seq=TRAIN_T)
    out["sigkill_drill"] = d
    check(d["tier"] == "shm" and d["restored_step"] == 5,
          f"drill: restored from {d['tier']} step {d['restored_step']}")
    check(d["saved_losses"][:5] == out["uninterrupted"]["losses"][:5],
          f"drill: the saver's steps 1-5 {d['saved_losses'][:5]} differ "
          f"from this process's")
    check(d["resumed_losses"] == out["uninterrupted"]["losses"][5:],
          f"drill: resumed steps 6-7 {d['resumed_losses']} != "
          f"{out['uninterrupted']['losses'][5:]}")
    check(not os.path.exists(f"/dev/shm/{d['job']}_ckpt_shm_0"),
          "drill: the segment was not unlinked")
    return out, launches


# ------------------------------------------------------------ phase 8

#: the elastic drill's run: GPT-2 124M at phase 4b's batch, warmup then
#: cosine, a disk save every 10 steps (and a shm stage every step), the
#: SIGKILLs at seeded steps in [10, 25]
ELASTIC = dict(batch=TRAIN_B, seq=TRAIN_T, max_steps=30, warmup=5,
               save_steps=10, kill_range=(10, 25))


@contextlib.contextmanager
def elastic_workspace(prefix: str):
    """An output directory, a job name and a socket directory of the
    phase's own for the in-process Trainer, torn down on the way out,
    whatever happened: the trainer's checkpointer closed, the in-process
    saver reset (which unlinks its segments), the socket directory (set
    on common/multi_process, which phase 7 imported) restored and both
    directories removed."""
    import shutil
    import tempfile

    from dlrover_wuqiong_tpu_torch.common import multi_process

    out_dir = tempfile.mkdtemp(prefix=prefix)
    sock_dir = tempfile.mkdtemp(prefix=prefix + "sock-")
    saved = {k: os.environ.get(k) for k in ("DWT_JOB_NAME",
                                            "DWT_MASTER_ADDR")}
    prev_sock = multi_process.SOCKET_DIR
    multi_process.SOCKET_DIR = sock_dir
    os.environ["DWT_JOB_NAME"] = f"{prefix}{os.getpid()}"
    os.environ.pop("DWT_MASTER_ADDR", None)
    opened = []
    try:
        yield out_dir, opened
    finally:
        try:
            from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
                AsyncCheckpointSaver,
            )

            for ck in opened:
                ck.close()
            AsyncCheckpointSaver.reset()
        finally:
            multi_process.SOCKET_DIR = prev_sock
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            shutil.rmtree(out_dir, ignore_errors=True)
            shutil.rmtree(sock_dir, ignore_errors=True)


def uninterrupted_run(torch, tfa) -> tuple:
    """Phase 8.1: the drill's Trainer in this process, uninterrupted.
    Returns ({step: loss}, launches, seconds a step)."""
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger
    from dlrover_wuqiong_tpu_torch.trainer import drill
    from dlrover_wuqiong_tpu_torch.trainer.trainer import Trainer

    e = ELASTIC
    losses, stamps = {}, {}

    def on_step(step, m):
        losses[step] = m["loss"]
        stamps[step] = time.monotonic()

    with elastic_workspace("dwt-elastic-ref-") as (out_dir, opened):
        tr = Trainer(GPT(drill.gpt_config("gpt2")), drill.training_args(
            out_dir, e["max_steps"], e["warmup"], e["save_steps"],
            e["batch"], e["seq"]),
            drill.data_fn(drill.VOCAB["gpt2"], e["batch"], e["seq"]),
            callbacks=[on_step])
        opened.append(tr.ckpt)
        torch.cuda.synchronize()
        tfa.reset_launches()
        tr.train()
        torch.cuda.synchronize()
        launches = dict(tfa.LAUNCHES)
        tracker = os.path.join(out_dir, "checkpoints",
                               "latest_checkpointed_iteration.txt")
        with open(tracker) as f:
            check(f.read().strip() == str(e["max_steps"]),
                  "uninterrupted run: the last step was not committed")
        del tr
    reset_ledger()
    n = e["max_steps"]
    check(sorted(losses) == list(range(1, n + 1)),
          f"uninterrupted run: losses at steps {sorted(losses)}")
    check(all(l == l and abs(l) < float("inf") for l in losses.values()),
          "uninterrupted run: a loss is not finite")
    check(losses[n] < losses[1], f"uninterrupted run: loss {losses[1]} -> "
          f"{losses[n]} did not fall")
    expect_launches(launches, n, 12, 1, "fused", "uninterrupted run")
    step_s = (stamps[n] - stamps[e["warmup"]]) / (n - e["warmup"])
    return losses, launches, step_s


def elastic_phase(torch, tfa) -> tuple:
    """Phase 8: the uninterrupted run, then the drill under ``run
    --standalone`` with 2 SIGKILLs; every check of the drill.  Returns
    (report, the workers' summed launches)."""
    import gc

    from dlrover_wuqiong_tpu_torch.trainer import drill

    losses, ref_launches, ref_step_s = uninterrupted_run(torch, tfa)
    gc.collect()
    torch.cuda.empty_cache()
    e = ELASTIC
    r = drill.elastic_drill(model="gpt2", device="cuda", timeout_s=600, **e)
    gens = r["generations"]
    check(r["rc"] == 0 and len(gens) == drill.KILLS + 1,
          f"drill: launcher exit {r['rc']} after {len(gens) - 1} restarts")
    check(r["committed_step"] == str(e["max_steps"]),
          f"drill: latest_checkpointed_iteration.txt reads "
          f"{r['committed_step']!r}")
    check(gens[-1]["steps"] and gens[-1]["steps"][-1] == e["max_steps"],
          "drill: the last generation did not reach max_steps")
    for kill, prev, gen in zip(r["kills"], gens, gens[1:]):
        staged = kill["staged_step"]
        check(staged == kill["step"] - 1 and prev["steps"][-1] ==
              kill["step"], f"drill: killed at {kill['step']}, staged "
              f"{staged}, last step {prev['steps'][-1]}")
        check((gen["start_step"], gen["tier"]) == (staged, "shm"),
              f"drill: generation {gen['gen']} resumed at "
              f"{gen['start_step']} from {gen['tier']}, not at {staged} "
              f"from shm")
        check(gen["steps"][0] == staged + 1,
              f"drill: generation {gen['gen']} first step "
              f"{gen['steps'][0]} != {staged + 1}")
    summed = {}
    for gen in gens:
        want = [losses[s] for s in gen["steps"]]
        check(gen["losses"] == want,
              f"drill: generation {gen['gen']} losses {gen['losses']} != "
              f"the uninterrupted {want}")
        expect_launches({k: v for k, v in gen["launches"].items()
                         if k.startswith("flash_")}, len(gen["steps"]), 12,
                        1, "fused", f"drill generation {gen['gen']}")
        check(gen["launches"]["quantize_int8_blockwise"] == 0 and
              gen["launches"]["dequantize_int8_blockwise"] == 0,
              f"drill generation {gen['gen']}: int8 launches")
        for k, v in gen["launches"].items():
            summed[k] = summed.get(k, 0) + v
    check(len(r["splits"]) == drill.KILLS, f"drill: {len(r['splits'])} "
          f"kill splits")
    check(not os.path.exists(f"/dev/shm/{r['job']}_ckpt_shm_0"),
          "drill: the segment was not unlinked")
    r["uninterrupted"] = {"losses": [losses[s] for s in sorted(losses)],
                          "launches": ref_launches,
                          "step_s_after_warmup": ref_step_s}
    return r, summed



# ------------------------------------------------------------ phase 9

#: the node-loss drill's batch: two GPT-2 124M trainers share the card
NODE_LOSS_B = 8


def node_loss_phase(torch, tfa) -> tuple:
    """Phase 9: each rank's uninterrupted run in this process, then the
    node-loss drill (`trainer.drill.node_loss_drill`) on the card, and
    every check of `trainer.drill.node_loss_checks`.  Returns (report,
    the workers' summed launches)."""
    import gc

    from dlrover_wuqiong_tpu_torch.trainer import drill

    knobs = dict(model="gpt2", device="cuda", batch=NODE_LOSS_B,
                 seq=TRAIN_T, **drill.NODE_LOSS)
    ref = {}
    for rank in (0, 1):
        with elastic_workspace(f"dwt-nl-ref{rank}-") as (out_dir, _):
            ref[rank] = drill.uninterrupted_losses(rank, out_dir, **knobs)
        gc.collect()
        torch.cuda.empty_cache()
        n = knobs["max_steps"]
        check(sorted(ref[rank]) == list(range(1, n + 1)) and all(
            abs(v) < float("inf") for v in ref[rank].values()),
            f"node-loss reference of rank {rank}: losses {ref[rank]}")
    r = drill.node_loss_drill(timeout_s=300, **knobs)
    r["checks"] = checks = drill.node_loss_checks(r, ref, 12)
    failed = [k for k, ok in checks.items() if not ok]
    check(not failed, f"node-loss drill: {failed} failed: "
          f"{json.dumps(r)[:6000]}")
    for job in r["jobs"]:
        check(not os.path.exists(f"/dev/shm/{job}_ckpt_shm_0"),
              f"node-loss drill: the segment of {job} was not unlinked")
    summed = {}
    for v in r["launches"].values():
        for k, c in v["launches"].items():
            summed[k] = summed.get(k, 0) + c
    r["reference"] = {rank: [ref[rank][s] for s in sorted(ref[rank])]
                      for rank in ref}
    return r, summed



# ------------------------------------------------------------ phase 10


def master_kill_phase(torch, tfa) -> tuple:
    """Phase 10: the uninterrupted run in this process (10.1), then the
    master-kill drill (`chaos.master_kill`) against it (10.2), with
    every check of the drill.  Returns (report, the reference, the
    worker's launches)."""
    import gc

    from dlrover_wuqiong_tpu_torch import chaos

    geo = chaos.MASTER_KILL["gpt2"]
    n = geo["dataset_size"] // geo["batch"]
    torch.cuda.synchronize()
    tfa.reset_launches()
    ref = chaos.master_kill_reference(model="gpt2", device="cuda")
    torch.cuda.synchronize()
    ref_launches = dict(tfa.LAUNCHES)
    losses = [float.fromhex(h) for h in ref["losses"]]
    check(len(losses) == n, f"master-kill reference: {len(losses)} losses")
    check(all(abs(v) < float("inf") for v in losses),
          "master-kill reference: a loss is not finite")
    check(losses[-1] < losses[0], f"master-kill reference: loss "
          f"{losses[0]} -> {losses[-1]} did not fall")
    expect_launches(ref_launches, n, 12, 1, "fused",
                    "master-kill reference")
    gc.collect()
    torch.cuda.empty_cache()
    r = chaos.master_kill(model="gpt2", device="cuda", reference=ref,
                          timeout=300.0)
    check(r["ok"], "master-kill drill failed: " + json.dumps(r)[:8000])
    check(r["steps"] == n and r["losses_bitwise"],
          f"master-kill: {r['steps']} steps, losses bitwise "
          f"{r['losses_bitwise']}")
    launches = {k: v for k, v in r["launches"].items()
                if k.startswith("flash_")}
    expect_launches(launches, n, 12, 1, "fused", "master-kill worker")
    check(r["launches"]["quantize_int8_blockwise"] == 0 and
          r["launches"]["dequantize_int8_blockwise"] == 0,
          f"master-kill worker: int8 launches {r['launches']}")
    ref["launches"] = ref_launches
    return r, ref, r["launches"]



def print_master_kill(mk: dict, mk_ref: dict):
    """Phase 10's lines: the report as JSON, then its numbers."""
    print("master-kill: " + json.dumps(
        {**mk, "reference": {"step_s": mk_ref["step_s"],
                             "launches": mk_ref["launches"]}}))
    js, rp, lg = mk["journal_group_commit"], mk["replay"], mk["ledger"]
    print(f"master-kill: GPT-2 124M, {mk['steps']} steps at B = "
          f"{mk['batch']}, T = {mk['seq']} from {mk['shards_completed']} "
          f"master-dispatched shards; uninterrupted in this process "
          f"{mk_ref['step_s'] * 1e3:.2f} ms a step (median); master "
          f"SIGKILLed after fetch 2 and 4 of its steps; outage "
          f"{mk['measured_outage_s']:.3f} s, restart gap (spawn, imports, "
          f"replay until it answers) {mk['restart_gap_s']:.3f} s; replay "
          f"{rp.get('frames')} frames in {rp.get('seconds')} s; journal "
          f"batches {js['batches']}, frames {js['frames']}, batch mean "
          f"{js['batch_mean']:.3f}, max {js['batch_max']}, durable seq "
          f"{js['durable_seq']}, epoch {js['epoch']}; steps in the outage "
          f"{mk['steps_in_outage']}; heartbeats buffered "
          f"{mk['heartbeats_buffered']}, drained {mk['buffer_drained']}; "
          f"ledger degraded {lg['degraded_s']:.3f} s, productive "
          f"{lg['productive_s']:.3f} s; goodput_wall "
          f"{mk['goodput_wall']:.4f}; one worker generation, launcher exit "
          f"{mk['cli_rc']}, {mk['dataset_size']} samples tiled once, all "
          f"{mk['steps']} "
          f"losses bitwise the uninterrupted run's")
    for verb, label in (("TaskRequest", "get_task"),
                        ("TaskResult", "report_task_result")):
        parts = []
        for when in ("before_kill", "after_restart", "across_outage"):
            st = mk["rpc_ms"].get(f"{verb}:{when}")
            if st:
                parts.append(f"{when.replace('_', ' ')} p50 "
                             f"{st['p50']:.3f} / p99 {st['p99']:.3f} ms "
                             f"(max {st['max']:.3f}) x{st['calls']}")
        print(f"master-kill: journaled {label}, host ms: " + "; ".join(parts))


# ------------------------------------------------------------ main


def main():
    t_start = time.monotonic()
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
    from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa
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
    ptxas = ptxas_start(_build)
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.2f} s")

    # phase 3
    err_q, err_d = check_kernels(torch, tq)
    cfg = GPTConfig.gpt2()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    mats = [t for t in leaves(params) if t.dim() >= 2]
    check(len(mats) == 50, f"expected 50 weight matrices, got {len(mats)}")
    grouped_err = check_grouped(torch, tq, mats)
    err_q, err_d = max(err_q, grouped_err[0]), max(err_d, grouped_err[1])
    times, elems = time_kernels(torch, tq, mats)
    del mats
    check(elems == 124_354_560, f"GPT-2 124M has {elems} matrix elements")
    for name, t in times.items():
        print(f"timing: {name} over 50 matrices in one launch: "
              f"{t['ms']:.4f} ms on the card ({t['ms_host_paced']:.4f} ms "
              f"as the host issues it); the loop of 50 one-leaf calls "
              f"{t['loop_ms']:.4f} ms ({t['loop_ms_host_paced']:.4f} ms as "
              f"issued); turns (grouped, loop, loop, grouped) "
              f"{', '.join(f'{x:.4f}' for x in t['turns_ms'])} ms; plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {t['bytes']} B)")

    # phase 3b
    hopper_ptxas = ptxas_report(ptxas)
    print("ptxas: flash forward (registers at launch; setmaxnreg gives the "
          "consumers 240, the producer 24): "
          + json.dumps(hopper_ptxas["fa_fwd_kernel"]))
    print("ptxas: flash dk/dv (registers at launch; setmaxnreg gives the "
          "consumers 232, the producer 40): "
          + json.dumps(hopper_ptxas["fa_bwd_dkv_kernel"]))
    print("ptxas: flash dq (registers at launch; setmaxnreg gives the "
          "consumers 240, the producer 24): "
          + json.dumps(hopper_ptxas["fa_bwd_dq_kernel"]))
    fa_err = check_flash(torch, tfa)
    fa_times = time_flash(torch, tfa)
    turns = fa_times["flash_attention_fwd"]["turns_ms"]
    print(f"timing: forward vs scaled_dot_product_attention's forward in "
          f"turns (kernel, SDPA, SDPA, kernel): "
          f"{', '.join(f'{x:.4f}' for x in turns)} ms; ratio "
          f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.3f}")
    print("timing: host us to issue one call: forward " + json.dumps(
        fa_times["flash_attention_fwd"]["host_us"]) + ", fused backward "
        + json.dumps(fa_times["flash_attention_bwd_fused"]["host_us"])
        + ", dq " + json.dumps(fa_times["flash_attention_bwd_dq"]["host_us"])
        + ", dk/dv " + json.dumps(
            fa_times["flash_attention_bwd_dkv"]["host_us"]))
    for name, t in fa_times.items():
        for shape, tt in (("(288, 1024, 1024, 64)", t),
                          ("Llama-3 8B's (32, 4096, 4096, 128)",
                           t.get("llama3_8b"))):
            if tt is None:
                continue
            print(f"timing: {name} at {shape} causal: "
                  f"{tt['ms']:.4f} ms on the card ({tt['ms_host_paced']:.4f} "
                  f"ms as issued), plain {tt['plain_ms']:.4f} ms, bound "
                  f"{tt['bound_ms']:.4f} ms ({tt['bound_by']}; {tt['bytes']} "
                  f"B, {tt['flop']} FLOP, "
                  f"{tt['flop'] / tt['ms'] / 1e9:.1f} TFLOP/s), "
                  f"scaled_dot_product_attention {tt['library_ms']:.4f} ms"
                  + (f"; worst row ||kernel - plain|| / ||plain|| "
                     f"{tt['row_err']:.2e} (tolerance {FA_TOL})"
                     if "row_err" in tt else "")
                  + (f", lse {tt['lse_err']:.2e} (tolerance {FA_LSE_TOL})"
                     if "lse_err" in tt else "")
                  + (f", through the wrapper {tt['wrapper_row_err']:.2e}"
                     if "wrapper_row_err" in tt else ""))

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
    # one grouped quantize at the engine build, one flat dequantize per
    # dispatch; the dispatches counted at the drain, before the lone
    # request below adds its own
    dispatches = m_int8["dispatches"]
    check(launches["quantize_int8_blockwise"] == 1,
          f"quantize launches {launches} != 1 at engine build")
    check(launches["dequantize_int8_blockwise"] == dispatches,
          f"dequantize launches {launches} != {dispatches} dispatches")
    greedy = next(r for r in reqs if r["temperature"] == 0.0)
    from dlrover_wuqiong_tpu_torch.serving import LocalServer

    alone = LocalServer(engine)
    alone.submit(**dict(greedy, request_id="alone"))
    check(alone.drain()["alone"] == out[greedy["request_id"]],
          "a greedy request alone differs from the busy batch")
    print("serving: 16 requests x 64 tokens; busy batch == alone; "
          f"launches {launches} over {dispatches} dispatches")
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

    # phase 4d — the same traffic through the master-backed worker, in
    # turns with the direct route (direct, worker, worker, direct)
    turns = {"direct": [], "worker": []}
    rpc_turns = []
    greedy_ids = [r["request_id"] for r in reqs if r["temperature"] == 0.0]
    for route in ("direct", "worker", "worker", "direct"):
        if route == "direct":
            _, o, m, l = serve(torch, np, cfg, params, "int8", reqs)
        else:
            _, o, m, l, rpc = serve_worker(torch, np, cfg, params, reqs)
            rpc_turns.append(rpc)
            worker_launches = l
        check(sorted(o) == sorted(r["request_id"] for r in reqs),
              f"{route}: not every request finished")
        for rid, toks in o.items():
            check(len(toks) == NEW_TOKENS and all(
                0 <= t < cfg.vocab_size for t in toks),
                f"{route}: {rid} has {len(toks)} tokens or tokens out of "
                f"the vocabulary")
        check(all(o[rid] == out[rid] for rid in greedy_ids),
              f"{route}: greedy tokens differ from phase 4's direct run")
        m["same_as_phase4"] = sum(o[rid] == out[rid] for rid in out)
        if route == "worker":
            check(l["quantize_int8_blockwise"] == 1,
                  f"worker: quantize launches {l} != 1 at engine build")
            check(l["dequantize_int8_blockwise"] == m["dispatches"],
                  f"worker: dequantize launches {l} != "
                  f"{m['dispatches']} dispatches")
        turns[route].append(m)
    # diagnostics in turns: the worker on this thread, and on its own
    # thread beside a 2 ms poller of the master's queue
    diag = {"main": [], "poll": []}
    for variant in ("main", "poll", "poll", "main"):
        _, o, m, _, _ = serve_worker(torch, np, cfg, params, reqs,
                                     variant=variant)
        check(all(o[rid] == out[rid] for rid in greedy_ids),
              f"worker ({variant}): greedy tokens differ from phase 4's")
        diag[variant].append(m)
    print("serving through the worker: " + json.dumps(
        {**turns, "diagnostics": diag, "rpc": rpc_turns}))
    for route, ms in list(turns.items()) + [
            ("worker on the main thread", diag["main"]),
            ("worker beside a 2 ms poller", diag["poll"])]:
        tps = ", ".join(f"{m['tokens_per_s']:.1f}" for m in ms)
        win = ", ".join(f"{m['ms_per_decode_window']:.2f}" for m in ms)
        lat = ", ".join(f"{m['latency_p50_ms']:.1f}/{m['latency_p99_ms']:.1f}"
                        for m in ms)
        ttft = ", ".join(f"{m['ttft_p50_ms']:.1f}/{m['ttft_p99_ms']:.1f}"
                         for m in ms)
        print(f"serving: {route}, in turns: tokens/s {tps}; ms per decode "
              f"window {win}; latency p50/p99 ms {lat}; TTFT p50/p99 ms "
              f"{ttft}")
    for verb in ("lease", "results", "stats"):
        print(f"serving: rpc {verb}, host ms (median [min, max] over "
              f"calls) per worker turn: " + "; ".join(
                  f"{r[verb]['median_ms']:.3f} [{r[verb]['min_ms']:.3f}, "
                  f"{r[verb]['max_ms']:.3f}] x{r[verb]['calls']}"
                  for r in rpc_turns))
    del engine, alone, params
    torch.cuda.empty_cache()

    # phase 4b
    train, fa_launches, split_launches = train_phase(torch, tfa)
    print("training: " + json.dumps(train))

    # phase 4c
    llama, llama_launches = llama_train_phase(torch, tfa)
    print("llama training: " + json.dumps(llama))

    # phase 5
    ref_err = reference_check(torch, np)
    print(f"reference: nano int8 card == CPU tokens; logits max |err| "
          f"{ref_err:.3g}")
    nano_err, nano_losses, _ = train_reference(torch, np, tfa)
    print(f"reference: nano training card vs CPU: first step logits "
          f"{nano_err['logits']:.3g}, worst gradient "
          f"{nano_err['worst_grad']:.3g} ({nano_err['worst_grad_leaf']}) "
          f"relative (tolerance {NANO_GRAD_RTOL}); 3 adamw steps, losses "
          f"{nano_losses}, max relative difference {nano_err['loss']:.3g} "
          f"(tolerance {NANO_LOSS_RTOL})")

    # phase 5c
    llama_err, llama_losses = llama_reference(torch, np, tfa)
    print(f"reference: small Llama (D = 128, GQA, T = 2048, split route) "
          f"training card vs CPU: first step logits "
          f"{llama_err['logits']:.3g}, worst gradient "
          f"{llama_err['worst_grad']:.3g} ({llama_err['worst_grad_leaf']}) "
          f"relative (tolerance {NANO_GRAD_RTOL}); 3 adamw steps, losses "
          f"{llama_losses}, max relative difference "
          f"{llama_err['loss']:.3g} (tolerance {NANO_LOSS_RTOL})")

    # phase 6b — the drain drill: decode workers as subprocesses on the
    # card, each with its own CUDA context, so the training phases'
    # memory goes back first
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    from dlrover_wuqiong_tpu_torch import chaos

    drill = chaos.serve_drain(device="cuda")
    print("serve-drain: " + json.dumps(drill))
    check(drill["ok"], "serve-drain failed: " + json.dumps(drill))
    print(f"serve-drain: {drill['requests']} requests x "
          f"{drill['max_new_tokens']} tokens, SIGKILL at "
          f"{drill['done_at_kill']} done; recovery (SIGKILL to the master "
          f"holding the last result) {drill['recovery_s']:.3f} s, of "
          f"which {drill.get('replacement_start_s', float('nan')):.3f} s "
          f"until the second worker's first span; "
          f"requeued {drill['requeued_total']}; bit-identical at the "
          f"workers' geometry (2 slots, 2 fused tokens); "
          f"{drill['mismatched_jax_geometry']} of {drill['requests']} "
          f"requests differ at the JAX drill's (3 slots, 4 fused tokens)")

    # phase 7 — the flash checkpoint of GPT-2 124M's training state
    gc.collect()
    torch.cuda.empty_cache()
    ckpt, ckpt_launches = ckpt_phase(torch, tfa)
    print("checkpoint: " + json.dumps(ckpt))
    sm, b = ckpt["summary"], ckpt["bounds"]

    def pm(st, scale=1.0, unit="s"):
        return (f"{st['p50'] * scale:.4f} [{st['min'] * scale:.4f}, "
                f"{st['max'] * scale:.4f}] {unit}")

    print(f"checkpoint: GPT-2 124M state {ckpt['state_bytes']} bytes; "
          f"digest {ckpt['host']['digest_algo']}; p50 [min, max] over "
          f"{CKPT_SAVES} saves: blocked in save_checkpoint "
          f"{pm(sm['blocked_s'], 1e3, 'ms')}; snapshot on the device "
          f"back to back {pm(sm['snapshot_back_to_back_ms'], 1, 'ms')}, "
          f"as issued in the saving step "
          f"{pm(sm['snapshot_device_ms'], 1, 'ms')} (bound "
          f"{b['snapshot_ms']:.4f} ms); drain to wait_staging "
          f"{pm(sm['drain_s'])} (of it D2H {pm(sm['d2h_s'])}, shm write + "
          f"digest {pm(sm['stage_s'])}; bound {b['drain_s']:.4f} s); "
          f"persist to committed {pm(sm['persist_s'])} (bound "
          f"{b['persist_s']:.4f} s)")
    for tier in ("shm", "storage"):
        print(f"checkpoint: restore from {tier}: verified load "
              f"{pm(sm[f'restore_{tier}_verify_s'])}, copy into the state "
              f"{pm(sm[f'restore_{tier}_h2d_s'])} (bounds: verify "
              f"{b['restore_shm_verify_s']:.4f} s, H2D "
              f"{b['restore_h2d_s']:.4f} s)")
    print(f"checkpoint: steps in turns, ms: alone "
          f"{pm(sm['plain_step_ms'], 1, 'ms')}; with the save "
          f"{pm(sm['saving_step_ms'], 1, 'ms')}; with a drain in flight "
          f"{pm(sm['drain_step_ms'], 1, 'ms')}; chained save blocked "
          f"{ckpt['chain']['second_blocked_s'] * 1e3:.4f} ms, its drain "
          f"waited {ckpt['chain']['chain_wait_s']:.4f} s for the first")
    rg = ckpt["ring"]
    print(f"checkpoint: replica ring, {rg['blob_bytes']} bytes a blob, "
          f"loopback {ckpt['rates_bytes_per_s']['loopback_tcp'] / 1e9:.3f} "
          f"GB/s; p50 [min, max] over {RING_REPEATS}: backup "
          f"{pm(sm['ring_backup_s'])} (bound {b['ring_backup_s']:.4f} s; "
          f"of it the copy under the segment's lock "
          f"{pm(sm['ring_backup_copy_s'])}, digests "
          f"{pm(sm['ring_backup_verify_s'])}, send "
          f"{pm(sm['ring_backup_send_s'])}); "
          f"fetch_peer with verification {pm(sm['ring_fetch_s'])} (bound "
          f"{b['ring_fetch_s']:.4f} s); restore into shm "
          f"{pm(sm['ring_restore_s'])} (bound {b['ring_restore_s']:.4f} s); "
          f"engine load by tier replica {pm(sm['ring_load_verify_s'])} "
          f"(bound {b['restore_replica_verify_s']:.4f} s) + H2D "
          f"{pm(sm['ring_load_h2d_s'])} (bound {b['restore_h2d_s']:.4f} s);"
          f" the step after it bitwise; a flipped byte in the held blob: "
          f"{rg['corrupt_report']['tier']} step "
          f"{rg['corrupt_report']['step']} in {rg['corrupt_load_s']:.3f} s, "
          f"fallbacks {rg['corrupt_report']['fallbacks']}, health hook "
          f"{rg['health']}, the step after it bitwise")
    d = ckpt["sigkill_drill"]
    print(f"checkpoint: SIGKILL drill: restored from {d['tier']} step "
          f"{d['restored_step']}; resumed steps 6-7 bitwise the "
          f"uninterrupted run; SIGKILL to restored state "
          f"{d['kill_to_restored_s']:.3f} s, of which "
          f"{d['start_s']:.3f} s the second process's start (python, "
          f"imports, CUDA context, model build) and {d['restore_s']:.3f} s "
          f"the restore")

    # phase 8 — the elastic drill: run --standalone, 2 SIGKILLs
    gc.collect()
    torch.cuda.empty_cache()
    el, el_launches = elastic_phase(torch, tfa)
    print("elastic: " + json.dumps(el))
    print(f"elastic: GPT-2 124M, {ELASTIC['max_steps']} steps at B = "
          f"{TRAIN_B}, T = {TRAIN_T}, shm stage every step, disk save "
          f"every {ELASTIC['save_steps']}; uninterrupted in this process "
          f"{el['uninterrupted']['step_s_after_warmup'] * 1e3:.1f} ms a "
          f"step after warmup; SIGKILLs at steps {el['kill_steps']}, "
          f"launcher exit {el['rc']} after {len(el['generations']) - 1} "
          f"restarts in {el['wall_s']:.1f} s; every generation's losses "
          f"bitwise the uninterrupted run's; committed step "
          f"{el['committed_step']}")
    for kill, gen, sp in zip(el["kills"], el["generations"][1:],
                             el["splits"]):
        parts = sum(v for k, v in sp.items() if k != "kill_to_first_step_s")
        print(f"elastic: kill at step {kill['step']} (staged "
              f"{kill['staged_step']}) -> generation {gen['gen']} from "
              f"{gen['tier']} step {gen['start_step']}: "
              f"{sp['kill_to_first_step_s']:.3f} s to the first resumed "
              f"step = notice {sp['notice_s']:.3f} + persist "
              f"{sp['persist_s']:.3f} + failure report "
              f"{sp['report_s']:.3f} + rendezvous {sp['rendezvous_s']:.3f} "
              f"+ worker start {sp['process_start_s']:.3f} + restore "
              f"{sp['restore_s']:.3f} + first step "
              f"{sp['first_step_s']:.3f} (+ "
              f"{sp['kill_to_first_step_s'] - parts:.3f} between them)")
    mg = el["master_goodput"] or {}
    print(f"elastic: goodput: the drill's productive seconds over its wall "
          f"{el['drill_goodput']:.4f}; the last generation's ledger "
          f"{el['final_ledger_goodput']:.4f}; the master's summary "
          f"{mg.get('goodput_fraction', float('nan')):.4f} over "
          f"{mg.get('nodes')} node(s)")

    # phase 9 — the node-loss drill: 2 nodes, node 1 lost, the ring
    gc.collect()
    torch.cuda.empty_cache()
    nl, nl_launches = node_loss_phase(torch, tfa)
    print("node-loss: " + json.dumps(nl))
    ls, sp = nl["launches"], nl["split"]
    print(f"node-loss: GPT-2 124M x 2 ranks, a gloo world of 2 nodes on "
          f"this card, {nl['max_steps']} steps at B = {NODE_LOSS_B}, "
          f"T = {TRAIN_T}, a shm stage every "
          f"{nl['stage_steps']} steps, a disk save + ring backup "
          f"every {nl['save_steps']}; node 1 lost after step "
          f"{nl['lose_after']} (committed and held by node 0's server "
          f"{nl['backed_up_wait_s']:.3f} s after both waited); launchers "
          f"exit {nl['rcs']}; node 1's new agent restored step "
          f"{nl['ring_restore'][0]['step']} from rank "
          f"{nl['ring_restore'][0]['holder']} in "
          f"{nl['ring_restore'][0]['s']:.3f} s; node 1 resumed from "
          f"{ls['r1_1']['tier']} step {ls['r1_1']['start_step']} "
          f"(restore_storage "
          f"{ls['r1_1']['ledger_states'].get('restore_storage', 0.0)}), "
          f"node 0 from {ls['r0_1']['tier']} step "
          f"{ls['r0_1']['start_step']}; every loss of both ranks bitwise "
          f"its uninterrupted run's; 12 + 12 flash launches a step in "
          f"every worker; committed step {nl['committed_step']}; "
          f"wall {nl['wall_s']:.1f} s")
    parts = sum(v for k, v in sp.items() if k != "kill_to_first_step_s")
    print(f"node-loss: node 1, loss to its first resumed step "
          f"{sp['kill_to_first_step_s']:.3f} s = the new agent's start "
          f"{sp['agent_start_s']:.3f} + rendezvous {sp['rendezvous_s']:.3f} "
          f"+ peer exchange {sp['peer_exchange_s']:.3f} + ring restore "
          f"{sp['ring_restore_s']:.3f} + launch {sp['launch_s']:.3f} + "
          f"worker start {sp['process_start_s']:.3f} + restore from shm "
          f"{sp['restore_s']:.3f} + first step {sp['first_step_s']:.3f} (+ "
          f"{sp['kill_to_first_step_s'] - parts:.3f} between them)")
    print("node-loss: ring backups (node, step, copies, s, of it the copy "
          "under the segment's lock): " + ", ".join(
              f"({b['node']}, {b['step']}, {b['copies']}, {b['s']:.3f}, "
              f"{b.get('copy_s', float('nan')):.3f})"
              for b in nl["backups"]))
    for key, v in sorted(ls.items()):
        waits = ", ".join(f"{x['step']}: {x.get('lock_wait_s', 0):.4f}"
                          for x in v["saves"] or [])
        peak = (v["peak_bytes"] or 0) / 1e9
        print(f"node-loss: {key}: steps {v['steps'][0]}-{v['steps'][-1]}, "
              f"from {v['tier']} (restore {v['restore_s']}), peak "
              f"{peak:.2f} GB, stage lock waits by step (s) {{{waits}}}")

    # phase 10 — the journaled master: SIGKILLed mid-shard, replayed
    gc.collect()
    torch.cuda.empty_cache()
    mk, mk_ref, mk_launches = master_kill_phase(torch, tfa)
    print_master_kill(mk, mk_ref)

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
            "library_ms": None, "loop_ms": t["loop_ms"],
            "loop_ms_host_paced": t["loop_ms_host_paced"],
            "timed_work": "one grouped launch over the 50 weight matrices "
                          "of GPT-2 124M",
            "launches_in": "serving, 16 requests",
            "launches_worker_route": worker_launches[name],
            "launches_elastic_route": el_launches[name],
            "launches_node_loss_route": nl_launches[name],
            "launches_master_kill_route": mk_launches[name],
        })
    src = "dlrover_wuqiong_tpu_torch/csrc/flash_attention.cu"
    for name, replaces, counts, run in (
            ("flash_attention_fwd", ":108", fa_launches,
             f"training, {TRAIN_STEPS} steps"),
            ("flash_attention_bwd_fused", ":429", fa_launches,
             f"training, {TRAIN_STEPS} steps"),
            ("flash_attention_bwd_dq", ":327", llama_launches,
             f"Llama-3 8B training ({LLAMA_LAYERS} layers), "
             f"{LLAMA_STEPS} steps"),
            ("flash_attention_bwd_dkv", ":375", llama_launches,
             f"Llama-3 8B training ({LLAMA_LAYERS} layers), "
             f"{LLAMA_STEPS} steps")):
        t = fa_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "dlrover_wuqiong_tpu/ops/flash_attention.py"
                        + replaces,
            "launches": counts[name], "max_abs_err": fa_err[name],
            "ms": t["ms"], "ms_host_paced": t["ms_host_paced"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "timed_work": "GPT-2 attention, (288, 1024, 1024, 64) causal",
            "launches_in": run,
            "launches_llama3_8b_training": llama_launches[name],
            "launches_split_side_run": split_launches[name],
            "launches_checkpoint_resumes": {
                t: ckpt_launches[t][name] for t in ckpt_launches},
            "launches_elastic_route": el_launches[name],
            "launches_node_loss_route": nl_launches[name],
            "launches_master_kill_route": mk_launches[name],
        })
        if "llama3_8b" in t:
            kernels[-1]["llama3_8b"] = {
                key: t["llama3_8b"][key]
                for key in ("shape", "ms", "ms_host_paced", "plain_ms",
                            "bound_ms", "bound_by", "library_ms", "row_err",
                            "max_abs_err")}
    print(f"wall: {time.monotonic() - t_start:.1f} s from the start to the "
          f"last check")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
