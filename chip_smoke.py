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
   int8 (int8, bf16, int8).
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
   diagnostics, one run each: the worker on the main thread, and the
   worker beside a 2 ms poller of the master's queue.
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
   int leaves exact.  7.2: `CKPT_SAVES` saves in turns with a step alone
   and a step during the drain (blocked seconds, the snapshot's device
   time as issued and back to back, drain, persist), one save chained
   behind another, 1 timed restore a tier beside 7.1's (verified load
   and H2D apart).  7.3: the SIGKILL drill
   (``checkpoint.drill.sigkill_drill``): a trainer subprocess saves to
   shm at step 5, takes step 6 and is SIGKILLed; a
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
   124M), TrainingArgs(max_steps=8, warmup_steps=4, cosine,
   save_steps=4, flash_stage_steps=1, logging_steps=1), data_fn)``
   (`ELASTIC`) in this process at B = 24, T = 1024, the data function
   drawing each step's tokens from (seed, step): every loss finite, the
   last below the first, step 8 committed, 12 forward and 12
   fused-backward launches a step.  8.2: the same Trainer as the worker
   of ``python -m dlrover_wuqiong_tpu_torch.run --standalone
   --max_restarts=3``, a SIGKILL at one seeded step in [6, 7] (the worker
   waits out its staging there).  Checks: the launcher exits 0 after
   exactly 1 restart, ``latest_checkpointed_iteration.txt`` reads 8, the
   killed
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
   uninterrupted run in this process (GPT-2 124M at B = 8, T = 1024, 12
   steps, warmup 4, tokens from (seed, step, rank); `NODE_LOSS_KNOBS`),
   then two ``python
   -m dlrover_wuqiong_tpu_torch.run --nnodes=2`` launchers against an
   in-process port master with ``DWT_CTX_CHECKPOINT_REPLICA=1``, their
   workers the same Trainers on the card in a gloo world (NCCL refuses
   two ranks on one card), a shm stage every 3 steps and a disk save
   (persist, then the ring backup) every 6.  After step 6 is committed
   and node 0's ReplicaServer holds node 1's segment of it, node 1's
   agent and worker are SIGKILLed, its segment unlinked, and a fresh
   node-1 launcher started.  Checks (`node_loss_checks`): both launchers
   exit 0, step 12 committed, node 1's new agent spans and logs a ring
   restore of step 6 from rank 0's holder, node 1's new worker resumes
   from tier ``shm`` at step 6 with no storage read, node 0 from its own
   shm, every loss of both ranks bitwise its uninterrupted run's, 12 + 12
   flash launches a step in every worker.  Prints node 1's time from the
   loss to its first resumed step by part, each ring backup, each
   worker's peak memory and how long each of its stages waited on the
   segment's lock.
10. The journaled master (``chaos.master_kill``, GPT-2 124M at full
   width and depth, bf16 compute over float32 masters, B = 8, T = 1024).
   10.1: ``auto_accelerate(GPT(cfg with remat=False), optimizer=adamw(
   3e-4), seed=0)`` in this process over the sample ranges [0, 768) in
   order, 8 samples a step (each sample a row of 1025 tokens from (seed,
   sample index)): 96 reference losses, every one finite, the last
   below the first, the median step, and 12 forward and 12
   fused-backward launches a step (counts set to 0 just before, read
   just after).  10.2: ``python -m dlrover_wuqiong_tpu_torch.master
   --journal-dir=...`` as a subprocess, ``python -m
   dlrover_wuqiong_tpu_torch.run --nnodes=1 --max_restarts=2`` dialing
   it, its worker the same trainer on the card fed by the master's
   dataset shards (768 samples, 32 minibatches a shard: 3 shards of 32
   steps); after the 2nd fetch and 4 of its steps the master is
   SIGKILLed, and 1.5 s later a new one starts on the same journal and
   port.  Checks, every invariant of the drill: one worker generation,
   the launcher exits 0, the 768 samples tiled once (fetched ==
   completed), steps inside the outage, heartbeats buffered and drained,
   the epoch at 2 and the node re-registered, the worker's ledger
   degraded and productive both > 0, 0.5 <= goodput_wall <= 1 (the ideal
   step the median of the worker's own steps outside the outage), the
   restarted master on group commit, and the incident timeline: the
   restarted master's live answer byte-equal to the offline assembly of
   the journal and the worker's flight dump, every journal event once in
   (epoch, seq) order over epochs [1, 2], its degraded seconds within
   0.05 s of the worker's ledger, and the offline CLI's hash equal to
   the live bytes; every one of the 96 losses bitwise 10.1's; and the
   worker's own counters at 12 forward and 12 fused-backward launches a
   step and no int8 one.  Prints the outage, the restart gap, the frames
   and seconds of the replay, the journal's gauges, the steps in the
   outage, the degraded and productive seconds, the goodput, the host
   ms p50 / p99 of the journaled ``get_task`` and
   ``report_task_result`` before the kill and after the restart, the
   timeline's gates and the phase's wall.  Its directories and both
   masters go whether it passes or fails.
11. The warm standby master (``chaos.master_failover``, the same model,
   worker, shards and kill point as phase 10, held to 10.1's run): a
   primary ``python -m dlrover_wuqiong_tpu_torch.master --lease-ttl=1.0
   --peer=STANDBY`` and a standby ``--standby-of=PRIMARY`` tailing its
   journal; the worker dials ``PRIMARY,STANDBY``.  The primary is
   SIGKILLed; the standby promotes after 1.0 s of lease silence.  Checks,
   every invariant of the drill: one worker generation, the launcher
   exits 0, the endpoint list rotated, the 768 samples tiled once, all
   96 losses bitwise 10.1's, the buffer drained, the promoted epoch 3
   (old + 2) seen by the worker and the node re-registered, degraded and
   productive > 0, the standby fetched before the kill, the promotion
   gap below this run's restart baseline (the corpse revived, spawn to
   serving) plus the ttl, the corpse fenced read-only through its
   ``--peer`` (a read answers, a write bounces with ``NotLeaderError``),
   the live timeline over both journals byte-equal to the offline one
   with a ``failover`` incident, 0.5 <= goodput_wall <= 1; and 12 + 12
   flash launches a step in the worker, no int8 one.  Prints the
   promotion gap beside phase 10's restart gap and this run's baseline,
   the ttl, the standby's lag at the kill, the frames shipped and
   folded, the steps and degraded seconds in the failover, the goodput,
   the timeline's event count and the phase's wall.
12. The model knobs (``chip_smoke.model_knobs_phase``, runnable alone),
   each through ``auto_accelerate``'s one-device strategies.  12.1: at
   GPT-2's c_fc shapes, (24576, 768) @ (768, 3072) in bf16,
   ``fp8_quantize``'s q and scale on the card bitwise the CPU's (e4m3 and
   e5m2), ``fp8_dot`` through ``torch._scaled_mm`` and ``fp8_matmul``'s
   e5m2 backward pair each within ``FP8_OP_RTOL`` of the float32
   products of the same fp8 operands, a (100, 768) operand raising, and
   their times beside the bf16 products.  12.2: GPT-2 124M (remat off,
   B = 24, T = 1024) with ``("amp", {"fp8": True})`` and phase 4b's bf16
   build in turns on one batch (2 warm-up and 10 timed steps each):
   losses finite and falling, each fp8 step within ``FP8_LOSS_RTOL`` of
   the bf16 step, 12 + 12 flash launches a step, 48 fp8 products a step
   (profiler), ms a step, tokens/s, peak memory and device ms by kind.
   12.3: the same for Llama-3 8B at phase 4c's cut (4 layers, B = 1,
   T = 4096, remat "full": 8 forward, 4 dq and 4 dk/dv launches a step,
   56 fp8 products), 5 steps each.  12.4: GPT-2 124M under remat off,
   "full", "dots", "offload_dots", "save_names" and "offload_names" from
   one seed and batch (2 warm-up + 5 steps each): step 1's loss bitwise
   across the six, later ones within ``REMAT_LOSS_RTOL`` of "full"'s, the
   offload policies below their on-device twins in peak memory and
   "full" below remat off; ms a step, peak and bytes to and from the
   host.  12.5: GPT-2 124M with 8 experts (top-2, capacity factor 1.25,
   remat "full", B = 8, T = 1024, 10 steps): losses finite and falling,
   the aux loss apart, 24 + 12 flash launches a step; then one ``MoEMLP``
   (768, 3072, 8 experts, 8192 tokens, top-2): ``torch._grouped_mm``
   against its per-group loop and the grouped impl against the capacity
   impl with room for every token, within ``MOE_RTOL``.  No int8 launch.
13. The optimizers (``chip_smoke.optimizers_phase``, runnable alone).
   13.1: seeded float32 leaves of (3072, 768) and (50304, 768) and 3
   steps of seeded gradients through AGD (plain; amsgrad with clip),
   Adam8bit, ``StableBF16`` over adamw in both modes and muP AdamW, on
   the card and on the CPU: the port's own rules' updates within
   ``OPT_RTOL`` relative, the rules over torch's AdamW within it on
   their new values, Adam8bit's int8 codes equal (codes off by one
   counted, failing above ``OPT_CODE_SHARE`` of them).  13.2: GPT-2 124M
   at phase 4b's build with adamw, agd, adamw8bit, mup_adam (base n_embd
   256), stable_bf16 (Kahan and master, and Kahan with
   optimizer_offload), optimizer_offload and WSAM (rho 0.05, decoupled),
   one build at a time on one batch, 2 warm-up and 5 timed steps: losses
   finite and falling, step 1's loss equal across the float32 builds,
   bf16 parameters and losses within ``STABLE_LOSS_RTOL`` of adamw's
   under stable_bf16, the offloaded state in pinned host memory and its
   parameters bitwise adamw's (stable_bf16's with stable_bf16),
   offload and adamw8bit peaks below adamw's, 12 + 12 flash launches a
   step (24 + 24 under WSAM); ms a step, tokens/s, peak and the
   optimizer's device ms (profiler).  13.3: GPT-2 124M under stable_bf16
   + adamw8bit saved to shm and restored into a build from another seed:
   the next step's loss and the state bitwise.  13.4: Llama-3 8B at full
   width, 24 of 32 layers (B = 1, T = 4096, remat "full"), stable_bf16 +
   adamw8bit, 1 warm-up and 3 timed steps: losses finite, 48 forward, 24
   dq and 24 dk/dv launches a step, ms, tokens/s, peak beside the
   computed state (fails, printing the peak, if it does not fit).  No
   int8 launch.
14. The mesh strategies (``chip_smoke.parallel_phase``, runnable alone),
   in an NCCL world of one of its own (a TCP store on a free localhost
   port), destroyed at the end.  14.1: GPT-2 124M at phase 4b's build
   plain, then under fsdp, zero2, ddp and tensor_parallel 1 + fsdp (the
   DTensor route with its redistributes), then plain again, one build at
   a time, 2 warm-up and 5 timed steps: every mesh build's parameters
   DTensors on the card, its losses and final parameters bitwise the
   plain build's, 12 + 12 flash launches a step; ms a step, tokens/s,
   peak and the device ms in NCCL kernels (profiler, one step of the
   fsdp and tensor_parallel builds).  14.3:
   the fsdp build's state saved to shm through FlashCheckpointer (its
   leaf names the plain build's: whole pieces in a world of one) and
   restored into an fsdp build from another seed; the next step's loss
   and the parameters bitwise.  14.2: Llama-3 8B at phase 4c's cut
   under fsdp, 1 warm-up and 3 timed steps: losses finite, 4c's trend
   rule, 8 forward, 4 dq and 4 dk/dv launches a step, ms, peak and NCCL
   ms.  14.4, computed on the meta device in a child process: Llama-3
   8B at full depth under fsdp in a fake world of 8, rank 0's bytes of
   parameters and AdamW moments within 1% of the total's eighth, and
   ``auto_plan``'s "does not fit" for one card of this card's memory.
15. Sequence and expert parallel (``chip_smoke.long_context_phase``,
   runnable alone).  15.1-15.2: ring, Ulysses and gathered ("gspmd")
   attention at Llama-3 8B's widths (b 1, 32 heads, d 128, bf16,
   causal) over 4 sp ranks emulated in this process (the gloo tests'
   bodies with the transport swapped), S 32768 and 4096: o, lse, dq, dk
   and dv against one whole-sequence kernel call, at 4096 against the
   plain version too; launches and the forward and backward ms; the
   ring at 32768 profiled once.  15.3: GPT-2 124M with 8 experts under
   expert_parallel 1 + fsdp and Llama-3 8B at 4 layers under
   sequence_parallel (ring, 1) + fsdp, in phase 14's NCCL world of one,
   bitwise their plain builds (size 1 falls through, as in JAX).
16. Checkpoint interop and local SGD (``chip_smoke.interop_phase``,
   runnable alone).  16.1: GPT-2 124M at phase 4b's build under fsdp
   with adamw8bit in an NCCL world of one of its own, 3 steps, a flash
   save to disk, `export_dcp` of it, `load_dcp` into a fresh build
   (every leaf of the checkpoint tree bitwise), a timed `save_dcp` and
   `load_dcp` (wall and bytes), then 2 steps of the trained and the
   loaded builds, bitwise.  16.2: local SGD (DiLoCo) on GPT-2 124M,
   two replica groups emulated in this process (the gloo tests' body,
   the sum over the groups a sum of tensors), B = 8 a group, a sync
   every 4 of 12 steps, mean and then GTA: the groups bitwise equal
   after every sync, the rounds' mean losses falling, 12 + 12 flash
   launches a group and step; an inner and a sync step's ms beside a
   plain GPT-2 step at B = 8.  16.3: the CPU path's streamed attention
   scans, called on CUDA tensors at Llama-3 8B's (32, 4096, 4096, 128)
   causal, within `FA_TOL` of kernels 1, 3 and 4 (lse within
   `FA_LSE_TOL`), their peak memory beside the dense plain version's.
17. Pipeline parallelism and the RL hybrid engine
   (``chip_smoke.pipeline_phase``, runnable alone).  pp 4 stages
   emulated in this process (`parallel.pipeline.EmulatedPipeline`: the
   gloo tests' schedule bodies, the hop between stages a hand-over of
   tensors).  17.1: GPT-2 124M, B = 16 in 8 microbatches, T = 1024,
   under gpipe, 1F1B and interleaved (v = 3, one layer a chunk); 17.2:
   Llama-3 8B's widths at 4 layers, B = 4 in 4 microbatches, T = 4096,
   under 1F1B and gpipe.  From one seeded init, each schedule's first
   step against the plain one-device step on the same batch (loss, grad
   norm, each leaf's gradient, the updated leaves; the PIPE_*
   tolerances), then timed steps of each: median ms and spread, the
   host's time for a step and a tick (until the step returns, before
   its loss is read), peak memory (and above the
   state), the ticks a step against `schedule_ticks`, flash launches a
   step (``pipeline_phase(..., profiled=...)`` adds a profiled GPT-2
   step: device busy share, kernels).  17.3: `rl.hybrid
   .HybridEngine` in an NCCL world of one, GPT-2 124M synced to the
   decode placement twice, bitwise; the second sync's wall.
6. One JSON line of the six kernels, the card line, and last
   ``{"ok": true, "device": {...}}``.

It exits non-zero without printing a result when CUDA is absent or when
the package is not beside this script.  Profiler tables are written to
``chiprun_out/chip_smoke_profile.txt`` (serving),
``chiprun_out/chip_smoke_train_profile.txt`` (GPT-2 training),
``chiprun_out/chip_smoke_llama_profile.txt`` (Llama training) and
``chiprun_out/chip_smoke_ring_profile.txt`` (phase 15's ring).
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

CKPT_SAVES = 1      # timed saves, each drained and committed before the next
CKPT_RESTORES = 1   # timed restores a tier, beside phase 7.1's one
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


RING_REPEATS = 1    # timed calls of each replica-ring stage


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
#: cosine, a disk save every 4 steps (and a shm stage every step), one
#: SIGKILL at a seeded step in [6, 7].  8 steps and one kill: the
#: script's wall on a slow host came within 10% of the 1200 s limit
#: with 30 steps, and again with phase 14 beside two kills; 20 steps
#: until phase 15 came, 14 until it passed 900 s on a slow host
ELASTIC = dict(batch=TRAIN_B, seq=TRAIN_T, max_steps=8, warmup=4,
               save_steps=4, kill_range=(6, 7), kills=1)


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
    check(r["rc"] == 0 and len(gens) == e["kills"] + 1,
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
    check(len(r["splits"]) == e["kills"], f"drill: {len(r['splits'])} "
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
#: phase 9's drill, cut from `trainer.drill.NODE_LOSS` (30 steps, node 1
#: lost after step 20) to 12 steps, node 1 lost after step 6 (a stage
#: every 3 steps, a save every 6), so the script stays under ~900 s
NODE_LOSS_KNOBS = dict(max_steps=12, warmup=4, save_steps=6,
                       stage_steps=3, lose_after=6)


def node_loss_phase(torch, tfa) -> tuple:
    """Phase 9: each rank's uninterrupted run in this process, then the
    node-loss drill (`trainer.drill.node_loss_drill`) on the card, and
    every check of `trainer.drill.node_loss_checks`.  Returns (report,
    the workers' summed launches)."""
    import gc

    from dlrover_wuqiong_tpu_torch.trainer import drill

    knobs = dict(model="gpt2", device="cuda", batch=NODE_LOSS_B,
                 seq=TRAIN_T, **NODE_LOSS_KNOBS)
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


def master_reference(torch, tfa) -> dict:
    """Phase 10.1: the uninterrupted run in this process that phases 10
    and 11 hold their drills to, its launches under "launches"."""
    from dlrover_wuqiong_tpu_torch import chaos

    geo = chaos.MASTER_KILL["gpt2"]
    n = geo["dataset_size"] // geo["batch"]
    torch.cuda.synchronize()
    tfa.reset_launches()
    ref = chaos.master_kill_reference(model="gpt2", device="cuda")
    torch.cuda.synchronize()
    ref["launches"] = dict(tfa.LAUNCHES)
    losses = [float.fromhex(h) for h in ref["losses"]]
    check(len(losses) == n, f"master-kill reference: {len(losses)} losses")
    check(all(abs(v) < float("inf") for v in losses),
          "master-kill reference: a loss is not finite")
    check(losses[-1] < losses[0], f"master-kill reference: loss "
          f"{losses[0]} -> {losses[-1]} did not fall")
    expect_launches(ref["launches"], n, 12, 1, "fused",
                    "master-kill reference")
    return ref


def master_drill_checks(r: dict, tag: str):
    """What phases 10 and 11 hold a drill's report to beyond its own
    `ok`: every step, every loss bitwise, 12 + 12 flash launches a step
    in the worker and no int8 one."""
    from dlrover_wuqiong_tpu_torch import chaos

    geo = chaos.MASTER_KILL["gpt2"]
    n = geo["dataset_size"] // geo["batch"]
    check(r["ok"], f"{tag} drill failed: " + json.dumps(r)[:8000])
    check(r["steps"] == n and r["losses_bitwise"],
          f"{tag}: {r['steps']} steps, losses bitwise "
          f"{r['losses_bitwise']}")
    check(r["goodput_wall"] <= 1.0,
          f"{tag}: goodput_wall {r['goodput_wall']} above 1")
    launches = {k: v for k, v in r["launches"].items()
                if k.startswith("flash_")}
    expect_launches(launches, n, 12, 1, "fused", f"{tag} worker")
    check(r["launches"]["quantize_int8_blockwise"] == 0 and
          r["launches"]["dequantize_int8_blockwise"] == 0,
          f"{tag} worker: int8 launches {r['launches']}")


def master_kill_phase(torch, tfa, ref: dict = None) -> tuple:
    """Phase 10: the uninterrupted run in this process (10.1, unless
    `ref` is given), then the master-kill drill (`chaos.master_kill`)
    against it (10.2), with every check of the drill.  Returns (report,
    the reference, the worker's launches)."""
    import gc

    from dlrover_wuqiong_tpu_torch import chaos

    if ref is None:
        ref = master_reference(torch, tfa)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    r = chaos.master_kill(model="gpt2", device="cuda", reference=ref,
                          timeout=300.0)
    r["phase_wall_s"] = time.monotonic() - t0
    master_drill_checks(r, "master-kill")
    return r, ref, r["launches"]


def master_failover_phase(torch, tfa, ref: dict = None,
                          restart_gap_s: float = None) -> tuple:
    """Phase 11: the warm-standby drill (`chaos.master_failover`) against
    phase 10's uninterrupted run (`ref`; run here when not given), with
    every check of the drill.  `restart_gap_s` is phase 10's, printed
    beside the promotion gap.  Returns (report, the worker's launches)."""
    import gc

    from dlrover_wuqiong_tpu_torch import chaos

    if ref is None:
        ref = master_reference(torch, tfa)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    r = chaos.master_failover(model="gpt2", device="cuda", reference=ref,
                              timeout=300.0)
    r["phase_wall_s"] = time.monotonic() - t0
    r["phase10_restart_gap_s"] = restart_gap_s
    master_drill_checks(r, "master-failover")
    return r, r["launches"]


def print_master_failover(fo: dict):
    """Phase 11's lines: the report as JSON, then its numbers."""
    print("master-failover: " + json.dumps(fo))
    pk, sb, lg = fo["pre_kill"], fo["standby"], fo["ledger"]
    gap10 = fo.get("phase10_restart_gap_s")
    print(f"master-failover: GPT-2 124M, {fo['steps']} steps at B = "
          f"{fo['batch']}, T = {fo['seq']} from {fo['shards_completed']} "
          f"shards dispatched by a primary (lease ttl {fo['lease_ttl']} s, "
          f"a lease frame every {fo['lease_ttl'] / 3:.3f} s) and then its "
          f"warm standby; primary SIGKILLed after fetch 2 and 4 of its "
          f"steps; promotion gap (SIGKILL to the standby serving as "
          f"leader at epoch {fo['promoted_epoch']}) "
          f"{fo['promotion_gap_s']:.3f} s against this run's restart "
          f"baseline {fo['restart_gap_s']:.3f} s + ttl "
          f"{fo['lease_ttl']} s = {fo['restart_the_world_s']:.3f} s "
          f"(phase 10's restart gap "
          + (f"{gap10:.3f} s" if gap10 is not None else "not run")
          + f"); standby lag at the kill {pk['standby_lag_frames']} "
          f"frames (primary durable seq {pk['durable_seq']}, shipped "
          f"{pk['shipped_seq']}); the standby folded "
          f"{sb.get('frames_folded')} frames ({sb.get('snapshots')} "
          f"snapshots), last mirrored seq {sb.get('last_seq')}; steps in "
          f"the failover {fo['steps_in_outage']}; heartbeats buffered "
          f"{fo['heartbeats_buffered']}, drained {fo['buffer_drained']}, "
          f"endpoint rotations {fo['client_failovers']}; ledger degraded "
          f"{lg['degraded_s']:.3f} s, productive {lg['productive_s']:.3f} "
          f"s; goodput_wall {fo['goodput_wall']:.4f} (ideal step "
          f"{fo['ideal_step_s'] * 1e3:.2f} ms, the worker's own median "
          f"outside the failover; reference "
          f"{fo['reference_step_s'] * 1e3:.2f} ms); corpse fenced "
          f"{fo['corpse_fenced']}, reads {fo['corpse_read_ok']}, "
          f"mutations refused {fo['corpse_mutation_refused']}; timeline "
          f"{fo['timeline_events']} events, byte-equal "
          f"{fo['timeline_byte_equal']}, incidents "
          f"{fo['timeline_incidents']}; all {fo['steps']} losses bitwise "
          f"the uninterrupted run's; phase wall {fo['phase_wall_s']:.1f} s")



def print_master_kill(mk: dict, mk_ref: dict):
    """Phase 10's lines: the report as JSON, then its numbers."""
    print("master-kill: " + json.dumps(
        {**mk, "reference": {"step_s": mk_ref["step_s"],
                             "launches": mk_ref["launches"]}}))
    print(f"master-kill: timeline {mk['timeline_events']} events, "
          f"byte-equal {mk['timeline_byte_equal']}, causal "
          f"{mk['timeline_causal']}, epochs {mk['timeline_epochs']}, "
          f"degraded {mk['timeline_degraded_s']:.3f} s against the "
          f"ledger's (within 0.05: {mk['timeline_attribution_ok']}), "
          f"offline CLI hash equal {mk['incident_report_sha_match']}; "
          f"phase wall {mk['phase_wall_s']:.1f} s")
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
          f"{mk['goodput_wall']:.4f} (ideal step "
          f"{mk['ideal_step_s'] * 1e3:.2f} ms, the worker's own median "
          f"outside the outage); one worker generation, launcher exit "
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


# ------------------------------------------------------------ phase 12

#: the fp8 runs: 2 warm-up steps each, then turns of timed steps
#: (fp8, bf16, bf16, fp8)
FP8_TURNS = {"gpt2": (3, 3, 3, 3), "llama": (2, 2, 3, 3)}
#: an fp8 step's loss against the bf16 step's on the same batch, relative
#: (tests/test_fp8_strategy.py:60's bound)
FP8_LOSS_RTOL = 0.05
#: the fp8 forward and its plain form, relative to the largest value:
#: the same fp8 operands on both sides, summed in float32 in another
#: order, the forward's output rounded to bf16 (2^-8)
FP8_OP_RTOL = 1e-2
#: the remat runs: GPT-2 124M at phase 4b's batch, 2 warm-up + 5 steps
REMAT_POLICIES = (None, "full", "dots", "offload_dots", "save_names",
                  "offload_names")
REMAT_WARMUP, REMAT_STEPS = 1, 3
#: a later step's loss under any policy against "full"'s, relative
REMAT_LOSS_RTOL = 1e-3
#: GPT-2 124M with 8 experts, top-2, capacity factor 1.25, remat "full"
MOE_B, MOE_STEPS = 8, 10
#: one MoEMLP on the card: the grouped product against its per-group loop
#: and the grouped impl against the capacity impl with room for every
#: token, relative to the largest value (bf16 products summed in other
#: orders and the capacity impl's dense dispatch products)
MOE_RTOL = 2e-2


def _rel_err(torch, got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def fp8_ops_check(torch, tq) -> dict:
    """12.1: the fp8 quantize, the `_scaled_mm` forward and the e5m2
    backward pair on the card at GPT-2's c_fc shapes, against the CPU's q
    and scale and the float32 products of the same fp8 operands."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    M, K, N = TRAIN_B * TRAIN_T, 768, 3072
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.03).bfloat16()
    g = torch.randn((M, N), generator=gen, device="cuda").bfloat16()
    out = {}
    for fmt in (tq.E4M3, tq.E5M2):
        for t, name in ((x, "x"), (w, "kernel")):
            q, s = tq.fp8_quantize(t, fmt)
            qc, sc = tq.fp8_quantize(t.cpu(), fmt)
            check(torch.equal(q.view(torch.uint8).cpu(),
                              qc.view(torch.uint8)) and s.item() == sc.item(),
                  f"fp8_quantize {fmt} of {name} on the card differs from "
                  f"the CPU's")
    qa, sa = tq.fp8_quantize(x)
    qb, sb = tq.fp8_quantize(w)
    y = tq.fp8_dot(x, w)
    ref = (qa.float() @ qb.float()) / (sa * sb)
    out["fwd_rel_err"] = _rel_err(torch, y, ref)
    check(y.dtype == torch.bfloat16 and out["fwd_rel_err"] <= FP8_OP_RTOL,
          f"fp8_dot through _scaled_mm: {out['fwd_rel_err']} relative "
          f"against the float32 product (tolerance {FP8_OP_RTOL})")
    xa = x.clone().requires_grad_()
    wb = w.clone().requires_grad_()
    tq.fp8_matmul(xa, wb).backward(g)
    qg, sg = tq.fp8_quantize(g, tq.E5M2)
    qb5, sb5 = tq.fp8_quantize(w, tq.E5M2)
    qa5, sa5 = tq.fp8_quantize(x, tq.E5M2)
    ga = (qg.float() @ qb5.float().t()) / (sg * sb5)
    gb = (qa5.float().t() @ qg.float()) / (sa5 * sg)
    out["ga_rel_err"] = _rel_err(torch, xa.grad, ga)
    out["gb_rel_err"] = _rel_err(torch, wb.grad, gb)
    check(max(out["ga_rel_err"], out["gb_rel_err"]) <= FP8_OP_RTOL,
          f"fp8_matmul's e5m2 backward: {out['ga_rel_err']}, "
          f"{out['gb_rel_err']} relative (tolerance {FP8_OP_RTOL})")
    try:
        tq.fp8_dot(x[:100], w)
    except ValueError:
        out["unaligned_raises"] = True
    else:
        fail("fp8_dot of a (100, 768) operand did not raise")
    # times at the c_fc shape: the fp8 forward (two quantize passes and
    # the product), the product alone, the bf16 product, and the
    # backward's two upcast products
    out["fp8_dot_ms"] = cuda_ms(torch, lambda: tq.fp8_dot(x, w), 20)
    out["scaled_mm_ms"] = cuda_ms(
        torch, lambda: tq._scaled_mm(qa, qb, sa, sb, torch.bfloat16), 20)
    out["bf16_mm_ms"] = cuda_ms(torch, lambda: x @ w, 20)
    out["e5m2_backward_products_ms"] = cuda_ms(
        torch, lambda: (tq._upcast_mm(qg, qb5.t()),
                        tq._upcast_mm(qa5.t(), qg)), 20)
    out["bf16_backward_products_ms"] = cuda_ms(
        torch, lambda: (g @ w.t(), x.t() @ g), 20)
    flop = 2 * M * K * N
    out["scaled_mm_tflop_per_s"] = flop / out["scaled_mm_ms"] / 1e9
    out["bf16_mm_tflop_per_s"] = flop / out["bf16_mm_ms"] / 1e9
    return out


def knob_profile(torch, tq, res, batch, n: int) -> dict:
    """Device ms a step by kind over n profiled steps: fp8 products
    (``aten::_scaled_mm``), bf16 products (``aten::mm``/``addmm``/``bmm``,
    the backward's upcast products among them), the fp8 quantize passes
    (the kernels under an annotation around `fp8_quantize`, put there for
    this window only), flash, optimizer and the rest; and fp8 products a
    step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    quantize = tq.fp8_quantize

    def annotated(*a, **kw):
        with record_function("fp8_quantize"):
            return quantize(*a, **kw)

    tq.fp8_quantize = annotated
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                res.state, _ = res.train_step(res.state, batch)
            torch.cuda.synchronize()
    finally:
        tq.fp8_quantize = quantize
    kern = device_events(torch, prof)
    if not kern:
        return {"device_ms_per_step_by_kind": "not measured"}
    busy = sum(e.time_range.elapsed_us() for e in kern)
    flash = sum(e.time_range.elapsed_us() for e in kern
                if "fa_fwd" in e.name or "fa_bwd" in e.name)
    opt = sum(e.time_range.elapsed_us() for e in kern
              if "multi_tensor" in e.name.lower())
    avg = {a.key: a for a in prof.key_averages()}

    def self_us(*keys):
        return sum(avg[k].self_device_time_total for k in keys if k in avg)

    cpu = torch.autograd.DeviceType.CPU
    quant = sum(e.device_time_total for e in prof.events()
                if e.name == "fp8_quantize" and e.device_type == cpu)
    fp8 = self_us("aten::_scaled_mm")
    bf16 = self_us("aten::mm", "aten::addmm", "aten::bmm")
    kinds = {"fp8_product": fp8, "bf16_product": bf16, "fp8_quantize": quant,
             "flash_attention": flash, "optimizer": opt}
    kinds["other"] = busy - sum(kinds.values())
    scaled = avg.get("aten::_scaled_mm")
    return {"device_busy_ms_per_step": busy / n / 1e3,
            "fp8_products_per_step": (scaled.count / n) if scaled else 0,
            "device_ms_per_step_by_kind": {k: v / n / 1e3
                                           for k, v in kinds.items()}}


def fp8_turns(torch, tfa, tq, builds: dict, batch, turns, layers,
              fwd_per_layer, route, tag) -> dict:
    """Warm-up then timed steps of the fp8 and bf16 builds in turns on one
    batch: every loss finite, each fp8 step's loss within FP8_LOSS_RTOL of
    the bf16 step's, the flash launches as prescribed in every turn.
    Returns both builds' losses, ms a step and peak memory, and the flash
    launches of all the timed turns."""
    runs = {k: {"losses": [], "ms": [], "peak_bytes": 0} for k in builds}
    total = {}
    for name, res in builds.items():
        losses, _, _, _ = run_steps(torch, tfa, res, batch, 2)
        runs[name]["losses"] += losses
    for name, n in zip(("fp8", "bf16", "bf16", "fp8"), turns):
        torch.cuda.reset_peak_memory_stats()
        losses, norms, ms, launches = run_steps(torch, tfa, builds[name],
                                                batch, n)
        run = runs[name]
        run["peak_bytes"] = max(run["peak_bytes"],
                                torch.cuda.max_memory_allocated())
        run["losses"] += losses
        run["ms"] += [ms] * n
        check(all(map(lambda v: v == v and abs(v) < float("inf"),
                      losses + norms)), f"{tag} {name}: non-finite loss or "
              f"grad norm: {losses} {norms}")
        expect_launches(launches, n, layers, fwd_per_layer, route,
                        f"{tag} {name}")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    l8, l16 = runs["fp8"]["losses"], runs["bf16"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(l8, l16)]
    check(max(rel) <= FP8_LOSS_RTOL, f"{tag}: fp8 losses {l8} against bf16 "
          f"{l16}: {max(rel)} relative (bound {FP8_LOSS_RTOL})")
    for name, run in runs.items():
        ms = run.pop("ms")
        run["ms_per_step"] = sum(ms) / len(ms)
    runs["max_relative_loss_difference"] = max(rel)
    return runs, total


def gpt2_fp8(torch, tfa, tq) -> tuple:
    """12.2: GPT-2 124M, ("amp", {"fp8": True}) against phase 4b's bf16
    build, in turns on one batch."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    builds = {
        "fp8": auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0,
                               strategy=[("amp", {"fp8": True})]),
        "bf16": auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0)}
    check(builds["fp8"].model.config.fp8 and not builds["bf16"].model.config
          .fp8, "the amp fp8 strategy did not rebuild GPT-2 with fp8")
    batch = train_batch(torch, 50257)
    out, launches = fp8_turns(torch, tfa, tq, builds, batch,
                              FP8_TURNS["gpt2"], 12, 1, "fused", "GPT-2 fp8")
    for name in ("fp8", "bf16"):
        first, last = out[name]["losses"][0], out[name]["losses"][-1]
        check(last < first, f"GPT-2 {name}: loss did not fall: "
              f"{out[name]['losses']}")
        out[name]["tokens_per_s"] = (TRAIN_B * TRAIN_T
                                     / out[name]["ms_per_step"] * 1e3)
        out[name]["profile"] = knob_profile(torch, tq, builds[name], batch,
                                            2)
    # 4 projections a layer (remat off); None where the profiler saw no
    # device activity
    n8 = out["fp8"]["profile"].get("fp8_products_per_step")
    check(n8 in (48, None), f"GPT-2 fp8: {n8} fp8 products a step")
    check(out["bf16"]["profile"].get("fp8_products_per_step") in (0, None),
          "GPT-2 bf16 ran fp8 products")
    del builds
    torch.cuda.empty_cache()
    return out, launches


def llama_fp8(torch, tfa, tq) -> tuple:
    """12.3: Llama-3 8B at phase 4c's cut (4 layers, full width, B = 1,
    T = 4096, remat "full": two forward launches a layer), fp8 against
    bf16, in turns."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_layers=LLAMA_LAYERS)
    builds = {
        "fp8": auto_accelerate(Llama(cfg), optimizer=adamw(3e-4), seed=0,
                               strategy=[("amp", {"fp8": True})]),
        "bf16": auto_accelerate(Llama(cfg), optimizer=adamw(3e-4), seed=0)}
    batch = train_batch(torch, cfg.vocab_size, b=LLAMA_B, t=LLAMA_T)
    out, launches = fp8_turns(torch, tfa, tq, builds, batch,
                              FP8_TURNS["llama"], LLAMA_LAYERS, 2, "split",
                              "Llama-3 8B fp8")
    for name in ("fp8", "bf16"):
        ls = out[name]["losses"]
        # the mean of the last two steps against the first two (phase 4c:
        # adamw(3e-4) swings this width's loss from one step to the next)
        check(sum(ls[-2:]) < sum(ls[:2]), f"Llama {name}: the loss did not "
              f"fall: {ls}")
        out[name]["tokens_per_s"] = (LLAMA_B * LLAMA_T
                                     / out[name]["ms_per_step"] * 1e3)
    out["fp8"]["profile"] = knob_profile(torch, tq, builds["fp8"], batch, 1)
    n8 = out["fp8"]["profile"].get("fp8_products_per_step")
    # 7 projections a layer, each forward run twice under remat "full"
    # (the recompute stops after a layer's last fp8 forward has run:
    # its autograd.Function keeps its inputs after computing)
    check(n8 in (2 * 7 * LLAMA_LAYERS, None),
          f"Llama fp8: {n8} fp8 products a step")
    del builds
    torch.cuda.empty_cache()
    return out, launches


def remat_policies(torch, tfa) -> tuple:
    """12.4: GPT-2 124M at B = 24, T = 1024 under each policy from the
    same seed and batch: step 1's loss bitwise across all six, later
    losses within REMAT_LOSS_RTOL of "full"'s, the offload policies below
    their on-device twins in peak memory and "full" below remat off."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.ops import remat as tremat
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    batch = train_batch(torch, 50257)
    out, launches = {}, {}
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(GPTConfig.gpt2(), remat=policy is not None,
                                  remat_policy=policy or "full")
        res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warm, _, _, _ = run_steps(torch, tfa, res, batch, REMAT_WARMUP)
        tremat.reset_offload_bytes()
        losses, _, ms, l = run_steps(torch, tfa, res, batch, REMAT_STEPS)
        name = policy or "off"
        expect_launches(l, REMAT_STEPS, 12, 1 if policy is None else 2,
                        "fused", f"remat {name}")
        launches[name] = l
        out[name] = {
            "ms_per_step": ms, "losses": warm + losses,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "d2h_bytes_per_step": tremat.OFFLOAD_BYTES["d2h"] / REMAT_STEPS,
            "h2d_bytes_per_step": tremat.OFFLOAD_BYTES["h2d"] / REMAT_STEPS}
        del res
        torch.cuda.empty_cache()
    first = {k: v["losses"][0] for k, v in out.items()}
    check(len(set(first.values())) == 1,
          f"remat: step 1's losses differ across policies: {first}")
    full = out["full"]["losses"]
    for name, v in out.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(v["losses"], full))
        v["max_relative_loss_difference_vs_full"] = rel
        check(rel <= REMAT_LOSS_RTOL, f"remat {name}: losses {v['losses']} "
              f"against full's {full}: {rel} relative")
    peak = {k: v["max_memory_allocated_bytes"] for k, v in out.items()}
    for low, high in (("offload_dots", "dots"),
                      ("offload_names", "save_names"), ("full", "off")):
        check(peak[low] < peak[high], f"remat: peak memory of {low} "
              f"{peak[low]} is not below {high}'s {peak[high]}")
    for name in ("offload_dots", "offload_names"):
        check(out[name]["d2h_bytes_per_step"] > 0,
              f"remat {name}: nothing went to the host")
    return out, launches


def moe_gpt2(torch, tfa) -> tuple:
    """12.5: GPT-2 124M with 8 experts, top-2, capacity factor 1.25, remat
    "full", B = 8, T = 1024; then one MoEMLP at its width, the grouped
    impl against its per-group loop and against the capacity impl."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models import moe as tmoe
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(GPTConfig.gpt2(), moe_experts=8, moe_top_k=2,
                              moe_capacity_factor=1.25)
    check(cfg.remat and cfg.remat_policy == "full", f"GPT-2 preset: {cfg}")
    t0 = time.monotonic()
    res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in res.model.parameters())
    batch = train_batch(torch, 50257, b=MOE_B)
    tfa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    auxes, metrics = [], []
    t0 = time.monotonic()
    for _ in range(MOE_STEPS):
        res.state, m = res.train_step(res.state, batch)
        metrics.append(m["loss"])
        auxes.append(tmoe.collect_moe_aux_loss(res.model.intermediates)
                     .detach())
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / MOE_STEPS * 1e3
    launches = dict(tfa.LAUNCHES)
    losses = torch.stack(metrics).cpu().tolist()
    aux = torch.stack(auxes).cpu().tolist()
    check(all(v == v and abs(v) < float("inf") for v in losses + aux),
          f"MoE GPT-2: non-finite loss {losses} or aux {aux}")
    check(losses[-1] < losses[0], f"MoE GPT-2: loss did not fall: {losses}")
    expect_launches(launches, MOE_STEPS, 12, 2, "fused", "MoE GPT-2")
    capacity = int(cfg.moe_capacity_factor * MOE_B * TRAIN_T * 2 / 8)
    out = {"params": n_params, "capacity": capacity, "init_s": init_s,
           "batch": MOE_B, "seq": TRAIN_T, "steps": MOE_STEPS,
           "ms_per_step": ms, "tokens_per_s": MOE_B * TRAIN_T / ms * 1e3,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "losses": losses, "aux_losses": aux, "launches": launches}
    out["profile"] = profile_steps(torch, res, batch, 2, ms,
                                   "chip_smoke_moe_profile.txt")
    del res
    torch.cuda.empty_cache()

    # one MoEMLP: grouped (torch._grouped_mm) against its per-group loop
    # on the card, and against the capacity impl with C = T (cf = E / k)
    d, f, E, n_tok = 768, 3072, 8, MOE_B * TRAIN_T
    gen = torch.Generator(device="cuda").manual_seed(5)
    mcfg = tmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=4.0)
    mlp = tmoe.MoEMLP(d, f, mcfg, device="cuda")
    with torch.no_grad():
        mlp.router.kernel.copy_(torch.randn((d, E), generator=gen,
                                            device="cuda") * d ** -0.5)
        for p in (mlp.experts_w_in, mlp.experts_w_gate, mlp.experts_w_down):
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    x = torch.randn((MOE_B, TRAIN_T, d), generator=gen,
                    device="cuda").bfloat16()
    with torch.no_grad():
        probs = torch.softmax(mlp.router(x.reshape(-1, d).float()), -1)
        _, experts = tmoe._top_k(probs, 2)
        flat = experts.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sizes = torch.bincount(flat, minlength=E)
        xs = x.reshape(-1, d)[order // 2]
        w = mlp.experts_w_gate.bfloat16()
        grouped = tmoe._ragged_dot(xs, w, sizes)
        loop, start = [], 0
        for g, n in enumerate(sizes.tolist()):
            loop.append(xs[start:start + n] @ w[g])
            start += n
        loop = torch.cat(loop)
        cap, _ = mlp(x)
        mlp.moe = dataclasses.replace(mcfg, impl="grouped")
        grp, _ = mlp(x)
        out["mlp"] = {
            "tokens": n_tok, "group_sizes": sizes.tolist(),
            "grouped_mm_vs_loop_rel_err": _rel_err(torch, grouped, loop),
            "grouped_vs_capacity_rel_err": _rel_err(torch, grp, cap),
            "grouped_ms": cuda_ms(torch, lambda: mlp(x), 10)}
        mlp.moe = mcfg
        out["mlp"]["capacity_cf4_ms"] = cuda_ms(torch, lambda: mlp(x), 5)
        mlp.moe = dataclasses.replace(mcfg, capacity_factor=1.25)
        out["mlp"]["capacity_cf1.25_ms"] = cuda_ms(torch, lambda: mlp(x), 5)
    for key in ("grouped_mm_vs_loop_rel_err", "grouped_vs_capacity_rel_err"):
        check(out["mlp"][key] <= MOE_RTOL, f"MoEMLP: {key} "
              f"{out['mlp'][key]} (tolerance {MOE_RTOL})")
    del mlp
    torch.cuda.empty_cache()
    return out, launches


def model_knobs_phase(torch, tfa) -> tuple:
    """Phase 12, runnable alone: the fp8 ops (12.1), GPT-2 124M (12.2)
    and Llama-3 8B at 4 layers (12.3) with fp8 against bf16, the remat
    policies (12.4) and GPT-2 124M with experts (12.5), each through
    `auto_accelerate`.  Returns (report, flash launches per run)."""
    import gc

    from dlrover_wuqiong_tpu_torch.ops import quantization as tq

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    tq.reset_launches()
    out, launches = {"fp8_ops": fp8_ops_check(torch, tq)}, {}
    for key, fn in (("gpt2_fp8", lambda: gpt2_fp8(torch, tfa, tq)),
                    ("llama_fp8", lambda: llama_fp8(torch, tfa, tq)),
                    ("remat", lambda: remat_policies(torch, tfa)),
                    ("moe", lambda: moe_gpt2(torch, tfa))):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        out[key], launches[key] = fn()
        out[key + "_wall_s"] = time.monotonic() - t1
    out["int8_launches"] = dict(tq.LAUNCHES)
    check(sum(out["int8_launches"].values()) == 0,
          f"model knobs: int8 launches {out['int8_launches']}")
    out["phase_wall_s"] = time.monotonic() - t0
    return out, launches


def print_model_knobs(mk: dict):
    """Phase 12's lines: the report as JSON, then its numbers."""
    print("model-knobs: " + json.dumps(mk))
    op = mk["fp8_ops"]
    print(f"model-knobs: fp8 ops at ({TRAIN_B * TRAIN_T}, 768) @ (768, "
          f"3072): q and scale bitwise the CPU's; fp8_dot "
          f"{op['fp8_dot_ms']:.4f} ms (the _scaled_mm alone "
          f"{op['scaled_mm_ms']:.4f} ms, {op['scaled_mm_tflop_per_s']:.1f} "
          f"TFLOP/s) against the bf16 product {op['bf16_mm_ms']:.4f} ms "
          f"({op['bf16_mm_tflop_per_s']:.1f} TFLOP/s); the e5m2 backward's "
          f"two upcast products {op['e5m2_backward_products_ms']:.4f} ms "
          f"against bf16's {op['bf16_backward_products_ms']:.4f} ms; "
          f"relative errors fwd {op['fwd_rel_err']:.2e}, dgrad "
          f"{op['ga_rel_err']:.2e}, wgrad {op['gb_rel_err']:.2e}; a "
          f"(100, 768) operand raises")
    for key, tag in (("gpt2_fp8", "GPT-2 124M, B = 24, T = 1024"),
                     ("llama_fp8", f"Llama-3 8B ({LLAMA_LAYERS} layers), "
                                   f"B = 1, T = 4096")):
        r = mk[key]
        prof = r["fp8"]["profile"]
        print(f"model-knobs: {tag}, in turns: fp8 "
              f"{r['fp8']['ms_per_step']:.2f} ms a step "
              f"({r['fp8']['tokens_per_s']:.0f} tokens/s, peak "
              f"{r['fp8']['peak_bytes'] / 1e9:.2f} GB) against bf16 "
              f"{r['bf16']['ms_per_step']:.2f} ms "
              f"({r['bf16']['tokens_per_s']:.0f} tokens/s, peak "
              f"{r['bf16']['peak_bytes'] / 1e9:.2f} GB); losses within "
              f"{r['max_relative_loss_difference']:.2e} relative; "
              f"{prof.get('fp8_products_per_step')} fp8 products a step; "
              f"device ms a step by kind "
              + json.dumps(prof.get("device_ms_per_step_by_kind")))
    for name, v in mk["remat"].items():
        print(f"model-knobs: remat {name}: {v['ms_per_step']:.2f} ms a "
              f"step, peak {v['max_memory_allocated_bytes'] / 1e9:.3f} GB, "
              f"to the host {v['d2h_bytes_per_step'] / 1e9:.3f} GB and "
              f"back {v['h2d_bytes_per_step'] / 1e9:.3f} GB a step")
    m = mk["moe"]
    print(f"model-knobs: GPT-2 124M with 8 experts (top-2, capacity "
          f"{m['capacity']} an expert, {m['params']} parameters), B = "
          f"{m['batch']}, T = {m['seq']}, remat full: "
          f"{m['ms_per_step']:.2f} ms a step ({m['tokens_per_s']:.0f} "
          f"tokens/s), peak {m['max_memory_allocated_bytes'] / 1e9:.2f} "
          f"GB; losses {m['losses'][0]:.4f} -> {m['losses'][-1]:.4f}, aux "
          f"{m['aux_losses'][0]:.5f} -> {m['aux_losses'][-1]:.5f}; device "
          f"ms a step by kind " + json.dumps(
              m["profile"].get("device_ms_per_step_by_kind")))
    ml = m["mlp"]
    print(f"model-knobs: MoEMLP (768, 3072, 8 experts, {ml['tokens']} "
          f"tokens, top-2): _grouped_mm against its per-group loop "
          f"{ml['grouped_mm_vs_loop_rel_err']:.2e}, grouped against "
          f"capacity (cf 4) {ml['grouped_vs_capacity_rel_err']:.2e} "
          f"(tolerance {MOE_RTOL}); forward ms: grouped "
          f"{ml['grouped_ms']:.3f}, capacity cf 4 "
          f"{ml['capacity_cf4_ms']:.3f}, capacity cf 1.25 "
          f"{ml['capacity_cf1.25_ms']:.3f}")
    print(f"model-knobs: phase wall {mk['phase_wall_s']:.1f} s (12.2 "
          f"{mk['gpt2_fp8_wall_s']:.1f}, 12.3 {mk['llama_fp8_wall_s']:.1f}, "
          f"12.4 {mk['remat_wall_s']:.1f}, 12.5 {mk['moe_wall_s']:.1f})")


# ------------------------------------------------------------ main


# ------------------------------------------------------------ phase 13

# 13.1: seeded float32 leaves at GPT-2's c_proj and (padded) embedding
# shapes, 3 steps of seeded gradients, each update rule on the card and
# on the CPU.
OPT_SHAPES = ((3072, 768), (50304, 768))
OPT_STEPS = 3
# The port's own rules (AGD, Adam8bit) run the same float32 operations,
# one rounding each, on both devices (optimizers/agd.py), so their
# updates (new value - old, float32) agree within OPT_RTOL relative.  The
# rules over torch's AdamW and Adam (StableBF16 over adamw, muP) run
# torch's own kernels, foreach on the card and per tensor on the CPU;
# those contract multiply-adds on the card and take a root that is not
# always correctly rounded on the CPU, so an element's new value may
# round the other way: they are held within OPT_RTOL relative on the new
# values, their updates reported.
OPT_RTOL = 1e-6
# Adam8bit's int8 codes should be bitwise equal; the phase reports how
# many differ by one code and fails above this share of all codes (or on
# any that differs by more)
OPT_CODE_SHARE = 1e-4
# 13.2: a stable_bf16 build's loss against the adamw build's, relative,
# step for step: tests/test_torch_bf16_stable.py's STABLE_LOSS_RTOL
# (GPT nano there, 5 steps, read 4.0e-3 on the CPU)
STABLE_LOSS_RTOL = 2e-2
OPT_WARMUP, OPT_TIMED = 1, 3
# 13.2's builds whose optimizer device ms a profiled step reads (the
# others print "not profiled"): the script's wall stays under ~900 s
OPT_PROFILED = ("adamw8bit", "stable_bf16_offload")
# 13.4: Llama-3 8B at 24 of its 32 layers under stable_bf16 + adamw8bit
OPT_LLAMA_LAYERS, OPT_LLAMA_WARMUP, OPT_LLAMA_TIMED = 24, 1, 3


def opt_rules(torch):
    """13.1's rules: name -> (factory, bf16 parameters, own arithmetic)."""
    from dlrover_wuqiong_tpu_torch.optimizers import (
        adamw8bit,
        agd,
        mup_adam,
        stable_bf16,
        width_mults,
    )
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    # the two leaves as a c_proj kernel and an embedding grown 4x from a
    # base of width 192 (in the leaves' sorted order)
    mults = width_mults(
        {"h_0": {"mlp": {"c_proj": {"kernel": torch.empty(768, 192)}}},
         "wte": {"embedding": torch.empty(50304, 192)}},
        {"h_0": {"mlp": {"c_proj": {"kernel": torch.empty(3072, 768)}}},
         "wte": {"embedding": torch.empty(50304, 768)}})
    return {
        "agd": (agd(1e-3, weight_decay=0.1), False, True),
        "agd_amsgrad_clip": (agd(1e-3, amsgrad=True, clip=0.5), False,
                             True),
        "adamw8bit": (adamw8bit(1e-3, weight_decay=0.1), False, True),
        "stable_bf16_adamw": (stable_bf16(adamw(1e-3)), True, False),
        "stable_bf16_master_adamw": (stable_bf16(adamw(1e-3), master=True),
                                     True, False),
        "mup_adamw": (mup_adam(1e-3, mults, weight_decay=0.1), False,
                      False),
    }


def _precise(opt, ps):
    """A copy of each leaf's float32 value on the host: the parameter, or
    for a StableBF16 the value its inner rule sees (p + e, or the
    master)."""
    from dlrover_wuqiong_tpu_torch.optimizers import StableBF16

    if isinstance(opt, StableBF16):
        if opt.master:
            vals = opt.comp
        else:
            vals = [p.detach().float() + c.float()
                    for p, c in zip(ps, opt.comp)]
    else:
        vals = [p.detach() for p in ps]
    return [v.float().cpu().clone() for v in vals]


def _rel(torch, a, b) -> float:
    """||a - b|| / ||b||, the norms summed in float64."""
    num = torch.linalg.vector_norm(a - b, dtype=torch.float64)
    den = torch.linalg.vector_norm(b, dtype=torch.float64)
    return float(num / max(float(den), 1e-30))


def opt_rules_check(torch, np) -> dict:
    """13.1: every rule's 3 steps on the card and on the CPU from the same
    leaves and gradients; the update, the new values and Adam8bit's codes
    held card against CPU."""
    from dlrover_wuqiong_tpu_torch.optimizers import Adam8bit

    rng = np.random.default_rng(0)
    w0 = [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
          for s in OPT_SHAPES]
    g0 = [[torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                            * np.float32(0.01)) for s in OPT_SHAPES]
          for _ in range(OPT_STEPS)]
    # the gradients on each device and in each dtype, made once; every
    # rule reads them and none writes them
    grads = {(dev, dt): [[g.to(dev, dt) for g in gs] for gs in g0]
             for dev in ("cpu", "cuda")
             for dt in (torch.float32, torch.bfloat16)}
    out = {}
    for name, (factory, bf16, own) in opt_rules(torch).items():
        dtype = torch.bfloat16 if bf16 else torch.float32
        got = {}
        for dev in ("cpu", "cuda"):
            # copies: on the CPU, .to(cpu) would alias the leaves, and the
            # rule would update them in place
            ps = [torch.nn.Parameter(w.to(dev, dtype, copy=True))
                  for w in w0]
            opt = factory(ps)
            start = _precise(opt, ps)
            t0 = time.monotonic()
            for gs in grads[(dev, dtype)]:
                for p, g in zip(ps, gs):
                    p.grad = g
                opt.step()
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.monotonic() - t0
            codes = ([[t.q.cpu() for t in opt.qtensors(p)] for p in ps]
                     if isinstance(opt, Adam8bit) else None)
            got[dev] = (start, _precise(opt, ps), codes, wall)
            del opt, ps
        (s0, cpu, c_cpu, w_cpu), (_, card, c_card, w_card) = (
            got["cpu"], got["cuda"])
        row = {"leaves": []}
        for i, shape in enumerate(OPT_SHAPES):
            upd = _rel(torch, card[i] - s0[i], cpu[i] - s0[i])
            val = _rel(torch, card[i], cpu[i])
            leaf = {"shape": list(shape), "update_rel_err": upd,
                    "value_rel_err": val,
                    "bitwise": bool(torch.equal(card[i], cpu[i]))}
            err = upd if own else val
            check(err <= OPT_RTOL, f"13.1 {name}, leaf {shape}: card "
                  f"against CPU {err:.3e} relative on the "
                  f"{'update' if own else 'new values'} (bound {OPT_RTOL})")
            if c_cpu is not None:
                for moment, a, b in zip(("mu", "nu"), c_card[i], c_cpu[i]):
                    d = (a.int() - b.int()).abs()
                    off1, worse = int((d == 1).sum()), int((d > 1).sum())
                    leaf[f"{moment}_codes_off_by_one"] = off1
                    check(worse == 0 and off1 <= OPT_CODE_SHARE * d.numel(),
                          f"13.1 {name}, leaf {shape}: {moment} codes "
                          f"differ, {off1} by one and {worse} by more, of "
                          f"{d.numel()}")
            row["leaves"].append(leaf)
        row["held_on"] = "update" if own else "new values"
        row["card_s"], row["cpu_s"] = w_card, w_cpu
        out[name] = row
    del grads
    return out


def device_resident(torch, res) -> int:
    """Bytes of a build's tensors on the card between steps: its state
    tree's leaves (parameters, step, optimizer state) and gradients."""
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        flatten_state_dict,
    )

    seen, total = set(), 0
    ts = list(flatten_state_dict(res.state.tree()).values())
    ts += [p.grad for p in res.model.parameters() if p.grad is not None]
    for t in ts:
        if t.device.type == "cuda" and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def opt_profile(torch, res, batch) -> dict:
    """One profiled step: the device ms of the optimizer's update (the
    kernels under an annotation around `optimizer_step`, put there for
    this window only) and of the whole step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from dlrover_wuqiong_tpu_torch.trainer import train_step as ts

    inner = ts.optimizer_step

    def annotated(opt):
        with record_function("optimizer_step"):
            return inner(opt)

    ts.optimizer_step = annotated
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res.state, _ = res.train_step(res.state, batch)
            torch.cuda.synchronize()
    finally:
        ts.optimizer_step = inner
    kern = device_events(torch, prof)
    if not kern:
        return {"optimizer_device_ms": "not measured"}
    cpu = torch.autograd.DeviceType.CPU
    opt = sum(e.device_time_total for e in prof.events()
              if e.name == "optimizer_step" and e.device_type == cpu)
    return {"optimizer_device_ms": opt / 1e3,
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in kern) / 1e3,
            "kernels": len(kern)}


def opt_gpt2_builds(torch, tfa) -> tuple:
    """13.2: GPT-2 124M (phase 4b's build: remat off, bf16 compute, B =
    24, T = 1024) with each optimizer from one seed on one batch, one
    build at a time: 2 warm-up and 5 timed steps, its own peak, then one
    profiled step.  Returns (report, flash launches of the timed steps)."""
    import dataclasses
    import gc

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.optimizers import (
        adamw8bit,
        agd,
        make_wsam_train_step,
        mup_adam,
        width_mults,
    )
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    L = cfg.n_layer
    base = GPT(dataclasses.replace(cfg, n_embd=256, n_head=4))
    specs = {
        "adamw": dict(optimizer=adamw(3e-4)),
        "agd": dict(optimizer=agd(3e-4)),
        "adamw8bit": dict(optimizer=adamw8bit(3e-4, weight_decay=1e-4)),
        "mup_adam": dict(optimizer=mup_adam(3e-4, width_mults(base,
                                                              GPT(cfg)))),
        "stable_bf16": dict(optimizer=adamw(3e-4),
                            strategy=[("stable_bf16", {})]),
        "stable_bf16_master": dict(optimizer=adamw(3e-4), strategy=[
            ("stable_bf16", {"master": True})]),
        "stable_bf16_offload": dict(optimizer=adamw(3e-4), strategy=[
            ("stable_bf16", {}), ("optimizer_offload", {})]),
        "optimizer_offload": dict(optimizer=adamw(3e-4), strategy=[
            ("optimizer_offload", {})]),
        "wsam": dict(optimizer=adamw(3e-4)),
    }
    batch = train_batch(torch, 50257)
    out, launches, kept_params = {}, {}, {}
    for name, kw in specs.items():
        gc.collect()
        torch.cuda.empty_cache()
        res = auto_accelerate(GPT(cfg), seed=0, **kw)
        per_step = 1
        if name == "wsam":
            res.train_step = make_wsam_train_step(res.loss_fn, 3e-4,
                                                  rho=0.05, decouple=True)
            per_step = 2
        warm, _, _, _ = run_steps(torch, tfa, res, batch, OPT_WARMUP)
        torch.cuda.synchronize()
        others = torch.cuda.memory_allocated() - device_resident(torch, res)
        torch.cuda.reset_peak_memory_stats()
        losses, norms, ms, lc = run_steps(torch, tfa, res, batch, OPT_TIMED)
        peak = torch.cuda.max_memory_allocated() - others
        losses = warm + losses
        check(all(map(lambda v: v == v and abs(v) < float("inf"),
                      losses + norms)), f"13.2 {name}: non-finite loss or "
              f"grad norm: {losses} {norms}")
        check(losses[-1] < losses[0], f"13.2 {name}: loss did not fall: "
              f"{losses}")
        expect_launches(lc, OPT_TIMED * per_step, L, 1, "fused",
                        f"13.2 {name}")
        launches[name] = lc
        dtypes = {str(p.dtype) for p in res.model.parameters()}
        row = {"losses": losses, "ms_per_step": ms,
               "tokens_per_s": TRAIN_B * TRAIN_T / ms * 1e3,
               "peak_bytes": peak, "param_dtypes": sorted(dtypes),
               "flash_launches_per_step": {k: v // OPT_TIMED
                                           for k, v in lc.items() if v}}
        if name.startswith("stable_bf16"):
            check(dtypes == {"torch.bfloat16"}, f"13.2 {name}: parameters "
                  f"{dtypes}, not bf16")
        else:
            check(dtypes == {"torch.float32"}, f"13.2 {name}: parameters "
                  f"{dtypes}, not float32")
        if name in ("adamw", "stable_bf16"):
            kept_params[name] = [p.detach().cpu() for p in
                                 res.model.parameters()]
        if name == "stable_bf16_offload":
            opt = res.state.opt_state
            host = list(opt.comp) + [
                v for view in opt.views for k, v in
                opt.inner.state[view].items() if k != "step"]
            check(host and all(v.device.type == "cpu" and v.is_pinned()
                               for v in host),
                  "13.2 stable_bf16_offload: the state is not in pinned "
                  "host memory between steps")
            row["host_state_bytes"] = sum(v.numel() * v.element_size()
                                          for v in host)
            same = all(torch.equal(a, p.detach().cpu()) for a, p in zip(
                kept_params["stable_bf16"], res.model.parameters()))
            check(same, "13.2 stable_bf16_offload: parameters after the "
                  "timed steps are not bitwise the stable_bf16 build's")
            row["params_bitwise_stable_bf16"] = same
        if name == "optimizer_offload":
            opt = res.state.opt_state
            host = [v for p in res.model.parameters()
                    for k, v in opt.state[p].items() if k != "step"]
            check(host and all(v.device.type == "cpu" and v.is_pinned()
                               for v in host),
                  "13.2 optimizer_offload: the state is not in pinned host "
                  "memory between steps")
            row["host_state_bytes"] = sum(v.numel() * v.element_size()
                                          for v in host)
            same = all(torch.equal(a, p.detach().cpu()) for a, p in zip(
                kept_params["adamw"], res.model.parameters()))
            check(same, "13.2 optimizer_offload: parameters after the timed "
                  "steps are not bitwise the adamw build's")
            row["params_bitwise_adamw"] = same
        row["profile"] = (opt_profile(torch, res, batch)
                          if name in OPT_PROFILED
                          else {"optimizer_device_ms": "not profiled"})
        out[name] = row
        del res
    first = {n: r["losses"][0] for n, r in out.items()}
    f32 = [n for n in out if not n.startswith("stable_bf16")]
    check(len({first[n] for n in f32}) == 1, f"13.2: step 1's loss differs "
          f"across the float32 builds: {first}")
    ref = out["adamw"]["losses"]
    for n in ("stable_bf16", "stable_bf16_master", "stable_bf16_offload"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(out[n]["losses"], ref))
        out[n]["max_relative_loss_vs_adamw"] = rel
        check(rel <= STABLE_LOSS_RTOL, f"13.2 {n}: losses {out[n]['losses']}"
              f" against adamw's {ref}: {rel} relative (bound "
              f"{STABLE_LOSS_RTOL})")
    for n in ("optimizer_offload", "adamw8bit"):
        check(out[n]["peak_bytes"] < out["adamw"]["peak_bytes"],
              f"13.2 {n}: peak {out[n]['peak_bytes']} not below adamw's "
              f"{out['adamw']['peak_bytes']}")
    out["step1_loss_bitwise_float32_builds"] = True
    out["step1_losses"] = first
    return out, launches


def opt_checkpoint(torch, tfa) -> dict:
    """13.3: GPT-2 124M under stable_bf16 + adamw8bit, 2 steps, saved to
    shm through FlashCheckpointer, restored into a build from another
    seed; one step on each: loss, parameters and state bitwise."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.optimizers import adamw8bit

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    batch = train_batch(torch, 50257)

    def build(seed):
        return auto_accelerate(GPT(cfg), optimizer=adamw8bit(3e-4),
                               strategy=[("stable_bf16", {})], seed=seed)

    with elastic_workspace("dwt-opt-ckpt-") as (out_dir, opened):
        from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
            FlashCheckpointer,
            StorageType,
        )
        from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
            flatten_state_dict,
        )

        ck = FlashCheckpointer(out_dir, job_name=os.environ["DWT_JOB_NAME"],
                               standalone=True)
        opened.append(ck)
        a = build(0)
        run_steps(torch, tfa, a, batch, 2)
        tree = a.state.tree()
        leaves = flatten_state_dict(tree)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in leaves.values())
        t0 = time.monotonic()
        ck.save_checkpoint(2, tree, StorageType.MEMORY)
        blocked = time.monotonic() - t0
        ck.wait_staging(120)
        staged = time.monotonic() - t0
        b = build(1)
        t0 = time.monotonic()
        ck.load_checkpoint(b.state)
        torch.cuda.synchronize()
        restore = time.monotonic() - t0
        rep = ck.last_restore_report
        check(rep["tier"] == "shm" and rep["step"] == 2,
              f"13.3: restored {rep}")
        la, _, _, _ = run_steps(torch, tfa, a, batch, 1)
        lb, _, _, _ = run_steps(torch, tfa, b, batch, 1)
        check(la == lb, f"13.3: the resumed step's loss {lb} is not the "
              f"original's {la}")
        fa, fb = (flatten_state_dict(a.state.tree()),
                  flatten_state_dict(b.state.tree()))
        check(list(fa) == list(fb) and all(torch.equal(fa[k], fb[k])
                                           for k in fa),
              "13.3: the resumed state is not bitwise the original's")
        names = [k for k in fa if k.startswith("opt_state/")]
        return {"leaves": len(fa), "state_bytes": state_bytes,
                "blocked_s": blocked, "staged_s": staged,
                "restore_s": restore, "loss_after_resume": la[0],
                "opt_state_names": names[:2] + names[-2:]}


def split_peak(torch, res, batch) -> dict:
    """One more step in two parts, each with its own peak: the forward
    and backward (to the last gradient), then the optimizer's update."""
    from dlrover_wuqiong_tpu_torch.trainer import train_step as ts

    opt = res.state.opt_state
    torch.cuda.synchronize()
    opt.zero_grad(set_to_none=True)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = res.loss_fn(res.model, batch)
    loss.backward()
    del loss
    torch.cuda.synchronize()
    fb = torch.cuda.max_memory_allocated()
    grads = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ts.optimizer_step(opt)
    res.state.step += 1
    torch.cuda.synchronize()
    return {"resident_without_grads_bytes": base,
            "forward_backward_peak_bytes": fb,
            "resident_with_grads_bytes": grads,
            "optimizer_peak_bytes": torch.cuda.max_memory_allocated()}


def opt_llama(torch, tfa) -> tuple:
    """13.4: Llama-3 8B at full width and 24 of 32 layers (phase 4c's
    config otherwise: B = 1, T = 4096, remat "full") under stable_bf16
    with adamw8bit(3e-4): 1 warm-up and 3 timed steps.  Fails, printing
    the peak, if it does not fit."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_wuqiong_tpu_torch.optimizers import adamw8bit

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_layers=OPT_LLAMA_LAYERS)
    n = cfg.num_params()
    # computed state: bf16 parameters, gradients and compensation, int8
    # mu and nu, a float32 scale per 256 elements of each leaf and
    # moment; against float32 parameters, gradients and AdamW moments
    out = {"layers": OPT_LLAMA_LAYERS, "params": n,
           "computed_state_bytes_float32_adamw": 16 * n}
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.monotonic()
        res = auto_accelerate(Llama(cfg), optimizer=adamw8bit(3e-4),
                              strategy=[("stable_bf16", {})], seed=0)
        torch.cuda.synchronize()
        out["init_s"] = time.monotonic() - t0
        params = list(res.model.parameters())
        check(sum(p.numel() for p in params) == n,
              f"13.4: {sum(p.numel() for p in params)} parameters, "
              f"num_params() says {n}")
        check({p.dtype for p in params} == {torch.bfloat16},
              "13.4: parameters are not bf16")
        scales = sum(2 * 4 * -(-p.numel() // 256) for p in params)
        out["computed_state_bytes"] = (2 + 2 + 2 + 2) * n + scales
        batch = train_batch(torch, cfg.vocab_size, b=LLAMA_B, t=LLAMA_T)
        warm, _, _, _ = run_steps(torch, tfa, res, batch, OPT_LLAMA_WARMUP)
        out["resident_bytes_after_warmup"] = device_resident(torch, res)
        torch.cuda.reset_peak_memory_stats()
        losses, norms, ms, lc = run_steps(torch, tfa, res, batch,
                                          OPT_LLAMA_TIMED)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError as e:
        fail(f"13.4: Llama-3 8B at {OPT_LLAMA_LAYERS} layers does not fit: "
             f"peak {torch.cuda.max_memory_allocated()} bytes of "
             f"{torch.cuda.get_device_properties(0).total_memory}: {e}")
    losses = warm + losses
    check(all(map(lambda v: v == v and abs(v) < float("inf"),
                  losses + norms)), f"13.4: non-finite loss or grad norm: "
          f"{losses} {norms}")
    # remat "full" runs each block's forward twice: 2 forward launches a
    # layer, as phase 4c's 8 at 4 layers
    expect_launches(lc, OPT_LLAMA_TIMED, OPT_LLAMA_LAYERS, 2, "split",
                    "13.4 Llama-3 8B")
    out["peak_split"] = split_peak(torch, res, batch)
    tokens = LLAMA_B * LLAMA_T
    out.update({"losses": losses, "ms_per_step": ms,
                "tokens_per_s": tokens / ms * 1e3,
                "flash_launches_per_step": {
                    k: v // OPT_LLAMA_TIMED for k, v in lc.items() if v}})
    out["profile"] = opt_profile(torch, res, batch)
    del res, params
    return out, lc


def optimizers_phase(torch, tfa) -> tuple:
    """Phase 13, runnable alone: the optimizers card against CPU (13.1),
    GPT-2 124M with each optimizer (13.2), the flash checkpoint of the
    stable_bf16 + adamw8bit state (13.3) and Llama-3 8B at 24 layers
    under stable_bf16 + adamw8bit (13.4).  Returns (report, flash
    launches per run)."""
    import gc

    import numpy as np

    from dlrover_wuqiong_tpu_torch.ops import quantization as tq

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    tq.reset_launches()
    out, launches = {}, {}
    t1 = time.monotonic()
    out["rules"] = opt_rules_check(torch, np)
    out["rules_wall_s"] = time.monotonic() - t1
    for key, fn in (("gpt2", lambda: opt_gpt2_builds(torch, tfa)),
                    ("checkpoint", lambda: (opt_checkpoint(torch, tfa),
                                            None)),
                    ("llama", lambda: opt_llama(torch, tfa))):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        out[key], lc = fn()
        if lc is not None:
            launches[key] = lc
        out[key + "_wall_s"] = time.monotonic() - t1
    out["int8_launches"] = dict(tq.LAUNCHES)
    check(sum(out["int8_launches"].values()) == 0,
          f"optimizers: int8 launches {out['int8_launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_wall_s"] = time.monotonic() - t0
    return out, launches


def print_optimizers(op: dict):
    """Phase 13's lines: the report as JSON, then its numbers."""
    print("optimizers: " + json.dumps(op))
    for name, r in op["rules"].items():
        print(f"optimizers: 13.1 {name}, card against CPU over "
              f"{OPT_STEPS} steps, held on the {r['held_on']}: " + "; ".join(
                  f"{tuple(lf['shape'])} update {lf['update_rel_err']:.2e}, "
                  f"values {lf['value_rel_err']:.2e}"
                  + (" (bitwise)" if lf["bitwise"] else "")
                  + "".join(f", {m} codes off by one "
                            f"{lf[m + '_codes_off_by_one']}"
                            for m in ("mu", "nu")
                            if m + "_codes_off_by_one" in lf)
                  for lf in r["leaves"])
              + f"; card {r['card_s']:.2f} s, CPU {r['cpu_s']:.2f} s")
    for name, r in op["gpt2"].items():
        if not isinstance(r, dict) or "ms_per_step" not in r:
            continue
        prof = r["profile"]
        opt_ms = prof.get("optimizer_device_ms")
        print(f"optimizers: 13.2 GPT-2 124M {name}: {r['ms_per_step']:.2f} "
              f"ms a step, {r['tokens_per_s']:.0f} tokens/s, peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB, optimizer device ms "
              + (f"{opt_ms:.2f}" if isinstance(opt_ms, float) else
                 str(opt_ms))
              + f", losses {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}"
              + (f", within {r['max_relative_loss_vs_adamw']:.2e} of adamw"
                 if "max_relative_loss_vs_adamw" in r else "")
              + f", flash a step {r['flash_launches_per_step']}")
    c = op["checkpoint"]
    print(f"optimizers: 13.3 stable_bf16 + adamw8bit GPT-2 124M state "
          f"{c['state_bytes']} bytes in {c['leaves']} leaves: save blocked "
          f"{c['blocked_s'] * 1e3:.1f} ms, staged {c['staged_s']:.3f} s, "
          f"restore {c['restore_s']:.3f} s; the resumed step bitwise")
    ll = op["llama"]
    opt_ms = ll["profile"].get("optimizer_device_ms")
    print(f"optimizers: 13.4 Llama-3 8B, {ll['layers']} layers "
          f"({ll['params']} parameters), stable_bf16 + adamw8bit: "
          f"{ll['ms_per_step']:.2f} ms a step, {ll['tokens_per_s']:.0f} "
          f"tokens/s, peak {ll['peak_bytes'] / 1e9:.2f} GB; computed state "
          f"{ll['computed_state_bytes'] / 1e9:.2f} GB against "
          f"{ll['computed_state_bytes_float32_adamw'] / 1e9:.2f} GB under "
          f"float32 AdamW; one more step's peaks: forward and backward "
          f"{ll['peak_split']['forward_backward_peak_bytes'] / 1e9:.2f} GB "
          f"(from {ll['peak_split']['resident_without_grads_bytes'] / 1e9:.2f}"
          f" GB without gradients), the optimizer "
          f"{ll['peak_split']['optimizer_peak_bytes'] / 1e9:.2f} GB; "
          f"optimizer device ms "
          + (f"{opt_ms:.2f}" if isinstance(opt_ms, float) else str(opt_ms))
          + f"; losses {ll['losses']}; flash a step "
          f"{ll['flash_launches_per_step']}")
    print(f"optimizers: phase wall {op['phase_wall_s']:.1f} s (13.1 "
          f"{op['rules_wall_s']:.1f}, 13.2 {op['gpt2_wall_s']:.1f}, 13.3 "
          f"{op['checkpoint_wall_s']:.1f}, 13.4 {op['llama_wall_s']:.1f})")


# ------------------------------------------------------------ phase 14

#: 14.1's builds beside the plain one: GPT-2 124M at phase 4b's build
MESH_BUILDS = {
    "fsdp": [("fsdp", {})],
    "zero2": [("zero2", {})],
    "ddp": [("ddp", {})],
    # the tensor-parallel DTensor route and its redistributes, at tp 1
    "tp1_fsdp": [("tensor_parallel", {"size": 1}), ("fsdp", {})],
}
MESH_WARMUP, MESH_TIMED, MESH_PROFILED = 1, 3, 1
#: 14.1's builds profiled (NCCL and busy device ms; the others print
#: "not profiled"): the DTensor routes, so the script stays near 900 s
MESH_PROFILED_BUILDS = ("fsdp", "tp1_fsdp")
MESH_LLAMA_WARMUP, MESH_LLAMA_TIMED = 1, 3
#: 14.4: the world Llama-3 8B's training state is sharded over, computed
MESH_FIT_WORLD = 8

# 14.4 runs in a child process: a "fake" world of MESH_FIT_WORLD on the
# meta device, so no later phase inherits a process group
FIT_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
world = int(sys.argv[2])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
try:
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_wuqiong_tpu_torch.parallel.fsdp import is_dtensor, state_bytes
    cfg = LlamaConfig.llama3_8b()
    res = auto_accelerate(Llama(cfg), strategy=[("fsdp", {})],
                          materialize=False, device="cpu")
    params = list(res.model.parameters())
    opt = res.state.opt_state
    moments = [t for p in params for k, t in opt.state[p].items()
               if k != "step"]
    local = [t.to_local() if is_dtensor(t) else t for t in params + moments]
    print(json.dumps({
        "world": world, "num_params": cfg.num_params(),
        "rank0_param_bytes": state_bytes(params),
        "rank0_state_bytes": state_bytes(params + moments),
        "total_state_bytes": 12 * cfg.num_params(),
        "all_meta": all(t.is_meta for t in local),
        "plan": res.strategy.plan.describe()}))
finally:
    dist.destroy_process_group()
"""


@contextlib.contextmanager
def nccl_world():
    """An NCCL world of one on card 0, its TCP store on a free localhost
    port, destroyed on the way out whatever happened."""
    import socket

    import torch
    import torch.distributed as dist

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def nccl_profile(torch, res, batch, n: int) -> dict:
    """n profiled steps: the device ms a step in NCCL kernels and in all
    device activities (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            res.state, _ = res.train_step(res.state, batch)
        torch.cuda.synchronize()
    ev = device_events(torch, prof)
    if not ev:
        return {"nccl_ms_per_step": "not measured",
                "device_busy_ms_per_step": "not measured"}
    nccl = [e for e in ev if "nccl" in e.name.lower()]
    return {"nccl_ms_per_step": sum(e.time_range.elapsed_us()
                                    for e in nccl) / n / 1e3,
            "nccl_kernels_per_step": len(nccl) / n,
            "device_busy_ms_per_step": sum(e.time_range.elapsed_us()
                                           for e in ev) / n / 1e3}


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def mesh_gpt2(torch, tfa) -> tuple:
    """14.1: GPT-2 124M (phase 4b's build) plain, then under each of
    `MESH_BUILDS`, then plain again, one build at a time from one seed on
    one batch: MESH_WARMUP + MESH_TIMED steps, their peak, then (for
    `MESH_PROFILED_BUILDS`) MESH_PROFILED profiled steps.  Every mesh
    build's parameters are DTensors on the card, its losses and its
    parameters after the timed steps bitwise the plain build's, 12 + 12
    flash launches a step.  Returns (report, timed launches, the fsdp
    build kept for 14.3)."""
    import dataclasses
    import gc

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.parallel.fsdp import is_dtensor
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    batch = train_batch(torch, 50257)
    out, launches, plain, kept = {}, {}, None, None
    for name in ["plain", *MESH_BUILDS, "plain_again"]:
        gc.collect()
        torch.cuda.empty_cache()
        # the peak over what was allocated before the build (the fsdp
        # build kept for 14.3, the batch)
        before = torch.cuda.memory_allocated()
        res = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0,
                              strategy=MESH_BUILDS.get(name))
        warm, warm_n, _, _ = run_steps(torch, tfa, res, batch, MESH_WARMUP)
        torch.cuda.reset_peak_memory_stats()
        losses, norms, ms, lc = run_steps(torch, tfa, res, batch,
                                          MESH_TIMED)
        peak = torch.cuda.max_memory_allocated() - before
        expect_launches(lc, MESH_TIMED, cfg.n_layer, 1, "fused",
                        f"14.1 {name}")
        launches[name] = lc
        row = {"losses": warm + losses, "grad_norms": warm_n + norms,
               "ms_per_step": ms, "tokens_per_s": TRAIN_B * TRAIN_T / ms
               * 1e3, "peak_bytes": peak,
               "plan": res.strategy.plan.describe()}
        params = [p for _, p in res.model.named_parameters()]
        dtensors = sum(is_dtensor(p) for p in params)
        row["dtensor_params"] = dtensors
        if name in MESH_BUILDS:
            # every parameter FSDP2 shards is a DTensor (under tensor
            # parallel the replicated ones too)
            check(dtensors >= len(params) - len(
                res.mesh_state.replicated) and dtensors > 0 and all(
                _local(p).is_cuda for p in params),
                f"14.1 {name}: {dtensors} of {len(params)} parameters are "
                f"DTensors on the card")
        host = [_local(p).detach().cpu() for p in params]
        if plain is None:
            plain = (row["losses"], host)
        else:
            same_l = row["losses"] == plain[0]
            same_p = all(torch.equal(a, b) for a, b in zip(host, plain[1]))
            row["losses_bitwise_plain"] = same_l
            row["params_bitwise_plain"] = same_p
            check(same_l and same_p, f"14.1 {name}: losses {row['losses']}"
                  f" against the plain build's {plain[0]}, parameters "
                  f"bitwise {same_p}")
        # after the comparison: a profiled step moves the parameters
        row.update(nccl_profile(torch, res, batch, MESH_PROFILED)
                   if name in MESH_PROFILED_BUILDS else
                   {"nccl_ms_per_step": "not profiled",
                    "device_busy_ms_per_step": "not profiled"})
        out[name] = row
        if name == "fsdp":
            kept = res
        del res
    return out, launches, kept


def mesh_llama(torch, tfa) -> tuple:
    """14.2: Llama-3 8B at phase 4c's cut (4 layers, full width, B = 1,
    T = 4096, remat "full") under fsdp: MESH_LLAMA_WARMUP warm-up and
    MESH_LLAMA_TIMED timed steps, 4c's trend rule on the losses and its
    launches (2 forward, 1 dq and 1 dk/dv a layer and step)."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_layers=LLAMA_LAYERS)
    t0 = time.monotonic()
    res = auto_accelerate(Llama(cfg), optimizer=adamw(3e-4), seed=0,
                          strategy=[("fsdp", {})])
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    batch = train_batch(torch, cfg.vocab_size, b=LLAMA_B, t=LLAMA_T)
    warm, _, _, _ = run_steps(torch, tfa, res, batch, MESH_LLAMA_WARMUP)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms, lc = run_steps(torch, tfa, res, batch,
                                      MESH_LLAMA_TIMED)
    peak = torch.cuda.max_memory_allocated()
    every = warm + losses
    check(all(map(lambda x: x == x and abs(x) < float("inf"),
                  every + norms)), f"14.2: non-finite loss or grad norm: "
          f"{every} {norms}")
    head, tail = sum(every[:2]) / 2, sum(every[-2:]) / 2
    check(tail < head, f"14.2: the mean loss of the last two steps {tail} "
          f"is not below the first two's {head}: {every}")
    expect_launches(lc, MESH_LLAMA_TIMED, LLAMA_LAYERS, 2, "split",
                    "14.2 Llama-3 8B under fsdp")
    row = {"layers": LLAMA_LAYERS, "batch": LLAMA_B, "seq": LLAMA_T,
           "losses": every, "grad_norms": norms, "ms_per_step": ms,
           "tokens_per_s": LLAMA_B * LLAMA_T / ms * 1e3, "peak_bytes": peak,
           "init_s": init_s, "plan": res.strategy.plan.describe()}
    row.update(nccl_profile(torch, res, batch, 1))
    del res
    torch.cuda.empty_cache()
    return row, lc


def mesh_checkpoint(torch, tfa, a) -> dict:
    """14.3: 14.1's fsdp build saved to shm through FlashCheckpointer,
    restored into a fresh fsdp build from another seed; one step on
    each: loss and parameters bitwise, and the leaf names the plain
    build's (whole pieces in a world of one)."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    batch = train_batch(torch, 50257)
    with elastic_workspace("dwt-mesh-ckpt-") as (out_dir, opened):
        from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
            FlashCheckpointer,
            StorageType,
        )
        from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
            _leaf_refs,
            flatten_state_dict,
        )

        ck = FlashCheckpointer(out_dir, job_name=os.environ["DWT_JOB_NAME"],
                               standalone=True)
        opened.append(ck)
        tree = a.state.tree()
        names = [e for n, leaf in flatten_state_dict(tree).items()
                 for e, _, _, _ in _leaf_refs(n, leaf)]
        plain = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0,
                                materialize=False)
        want = list(flatten_state_dict(plain.state.tree()))
        del plain
        check(names == want, f"14.3: leaf names {names[:4]}... are not "
              f"the plain build's {want[:4]}...")
        step = int(a.state.step)
        t0 = time.monotonic()
        ck.save_checkpoint(step, tree, StorageType.MEMORY)
        blocked = time.monotonic() - t0
        ck.wait_staging(120)
        staged = time.monotonic() - t0
        b = auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=1,
                            strategy=MESH_BUILDS["fsdp"])
        t0 = time.monotonic()
        ck.load_checkpoint(b.state)
        torch.cuda.synchronize()
        restore = time.monotonic() - t0
        rep = ck.last_restore_report
        check(rep["tier"] == "shm" and rep["step"] == step,
              f"14.3: restored {rep}")
        la, _, _, _ = run_steps(torch, tfa, a, batch, 1)
        lb, _, _, _ = run_steps(torch, tfa, b, batch, 1)
        check(la == lb, f"14.3: the resumed step's loss {lb} is not the "
              f"original's {la}")
        same = all(torch.equal(_local(p), _local(q)) for p, q in zip(
            a.model.parameters(), b.model.parameters()))
        check(same, "14.3: the resumed parameters are not bitwise")
        return {"leaves": len(names), "step": step, "blocked_s": blocked,
                "staged_s": staged, "restore_s": restore,
                "loss_after_resume": la[0]}


#: 14.4's child once started, until `mesh_fit_8b` collects it
_FIT_CHILD: list = []


def start_fit_child():
    """Start 14.4's child, which uses the CPU and the meta device only,
    so that it runs beside the phases before 14 (`main` starts it with
    phase 12); killed at exit if it is still running."""
    import atexit
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", FIT_CHILD, HERE,
                             str(MESH_FIT_WORLD)], stdout=out, stderr=err,
                            text=True, cwd=HERE)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    _FIT_CHILD.append((proc, out, err))


def mesh_fit_8b(torch) -> dict:
    """14.4, computed on the meta device: Llama-3 8B at full depth under
    fsdp over a fake world of MESH_FIT_WORLD (a child process, started
    here unless `start_fit_child` did it before), rank 0's bytes of
    parameters and AdamW moments beside the total's share; and
    auto_plan's refusal for one card of this one's memory."""
    from dlrover_wuqiong_tpu_torch.models.llama import LlamaConfig
    from dlrover_wuqiong_tpu_torch.parallel.mesh import (
        auto_plan,
        detect_hbm_per_device,
    )

    if not _FIT_CHILD:
        start_fit_child()
    proc, out, err = _FIT_CHILD.pop()
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed after 300 s"
    out.seek(0)
    err.seek(0)
    check(rc == 0, f"14.4 child failed ({rc}): {err.read()[-4000:]}")
    fit = json.loads(out.read().strip().splitlines()[-1])
    share = fit["total_state_bytes"] / MESH_FIT_WORLD
    check(fit["all_meta"] and fit["plan"] == f"fsdp{MESH_FIT_WORLD}",
          f"14.4: {fit}")
    check(abs(fit["rank0_state_bytes"] - share) <= 0.01 * share,
          f"14.4: rank 0 holds {fit['rank0_state_bytes']} bytes, not the "
          f"total's 1/{MESH_FIT_WORLD} ({share:.0f})")
    hbm = detect_hbm_per_device("cuda")
    try:
        auto_plan(1, LlamaConfig.llama3_8b().num_params(),
                  hbm_per_device=hbm)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None and "does not fit" in refusal,
          f"14.4: auto_plan took Llama-3 8B on one card of {hbm} bytes")
    fit.update(total_share_bytes=share, card_bytes=hbm,
               one_card_refusal=refusal)
    return fit


def parallel_phase(torch, tfa) -> tuple:
    """Phase 14: the mesh strategies.  14.1-14.3 in an NCCL world of one
    of this process's own, destroyed at the end; 14.4 in a child.
    Returns (report, {run: flash launches})."""
    import gc

    t0 = time.monotonic()
    out, walls = {}, {}
    with nccl_world():
        out["gpt2"], launches, kept = mesh_gpt2(torch, tfa)
        walls["14.1"] = time.monotonic() - t0
        out["checkpoint"] = mesh_checkpoint(torch, tfa, kept)
        del kept
        gc.collect()
        torch.cuda.empty_cache()
        walls["14.3"] = time.monotonic() - t0 - walls["14.1"]
        out["llama"], launches["llama_fsdp"] = mesh_llama(torch, tfa)
        walls["14.2"] = time.monotonic() - t0 - walls["14.1"] - walls["14.3"]
    gc.collect()
    torch.cuda.empty_cache()
    t4 = time.monotonic()
    out["fit_8b"] = mesh_fit_8b(torch)
    walls["14.4"] = time.monotonic() - t4
    out["walls_s"] = walls
    out["phase_wall_s"] = time.monotonic() - t0
    return out, launches


def print_parallel(pp: dict):
    """Phase 14's lines: the report as JSON, then its numbers."""
    print("parallel: " + json.dumps(pp))
    for name, r in pp["gpt2"].items():
        nccl = r["nccl_ms_per_step"]
        print(f"parallel: 14.1 GPT-2 124M {name} ({r['plan']}): "
              f"{r['ms_per_step']:.2f} ms a step, {r['tokens_per_s']:.0f} "
              f"tokens/s, peak {r['peak_bytes'] / 1e9:.2f} GB over what was "
              f"allocated before it, NCCL device "
              + (f"{nccl:.3f} ms" if isinstance(nccl, float) else str(nccl))
              + " a step"
              + (f", losses and parameters bitwise the plain build's"
                 if r.get("params_bitwise_plain") else ""))
    ll = pp["llama"]
    nccl = ll["nccl_ms_per_step"]
    print(f"parallel: 14.2 Llama-3 8B ({ll['layers']} layers) fsdp, built "
          f"and filled leaf by leaf in {ll['init_s']:.2f} s: "
          f"{ll['ms_per_step']:.2f} ms a step, {ll['tokens_per_s']:.0f} "
          f"tokens/s, peak {ll['peak_bytes'] / 1e9:.2f} GB, NCCL device "
          + (f"{nccl:.3f} ms" if isinstance(nccl, float) else str(nccl))
          + f" a step; losses {ll['losses']}")
    c = pp["checkpoint"]
    print(f"parallel: 14.3 fsdp state, {c['leaves']} leaves (the plain "
          f"build's names): save blocked {c['blocked_s'] * 1e3:.1f} ms, "
          f"staged {c['staged_s']:.3f} s, restore {c['restore_s']:.3f} s; "
          f"the resumed step bitwise")
    f = pp["fit_8b"]
    print(f"parallel: 14.4 computed on the meta device: Llama-3 8B "
          f"({f['num_params']} parameters) under fsdp over a fake world of "
          f"{f['world']}: rank 0 holds {f['rank0_state_bytes'] / 1e9:.3f} "
          f"GB of parameters + AdamW moments (parameters "
          f"{f['rank0_param_bytes'] / 1e9:.3f} GB), the total's 1/"
          f"{f['world']} is {f['total_share_bytes'] / 1e9:.3f} GB; one card "
          f"of {f['card_bytes'] / 2 ** 30:.1f} GiB: {f['one_card_refusal']}")
    w = pp["walls_s"]
    print(f"parallel: phase wall {pp['phase_wall_s']:.1f} s (14.1 "
          f"{w['14.1']:.1f}, 14.3 {w['14.3']:.1f}, 14.2 {w['14.2']:.1f}, "
          f"14.4 {w['14.4']:.1f})")

# ------------------------------------------------------------ phase 15

#: 15.1-15.2: Llama-3 8B's attention widths (b, heads, head dim), causal,
#: the sequence split over LONG_SP emulated ranks: 32768 (chunks of
#: 8192, the split backward) and 4096 (chunks of 1024, the fused one)
LONG_B, LONG_H, LONG_D, LONG_SP = 1, 32, 128, 4
LONG_SEQS = (32768, 4096)
LONG_IMPLS = ("ring", "ulysses", "gspmd")
LONG_TIMED = 3  # timed forward and backward calls of each
#: 15.3: the strategies at size 1, beside their plain builds
LONG_STRATEGIES = {
    "gpt2_moe8": [("expert_parallel", {"size": 1}), ("fsdp", {})],
    "llama3_8b": [("sequence_parallel", {"size": 1, "impl": "ring"}),
                  ("fsdp", {})],
}
LONG_WARMUP, LONG_STEPS = 1, 3


def long_inputs(torch, s: int, seed: int):
    """q, k, v and the output's cotangent, (1, 32, s, 128) bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((LONG_B, LONG_H, s, LONG_D), generator=gen,
                        device="cuda").to(torch.bfloat16)
            for _ in range(4)]


def long_timed(torch, run) -> tuple:
    """(forward ms, backward ms) of `run` (-> (outputs, backward fn)),
    by CUDA events around each half, the mean of LONG_TIMED calls after
    one warm-up."""
    fwd, bwd = [], []
    for i in range(LONG_TIMED + 1):
        torch.cuda.synchronize()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        out, backward = run()
        e[1].record()
        backward(out)
        e[2].record()
        e[2].synchronize()
        if i:
            fwd.append(e[0].elapsed_time(e[1]))
            bwd.append(e[1].elapsed_time(e[2]))
    return sum(fwd) / len(fwd), sum(bwd) / len(bwd)


def long_profile(torch, run) -> dict:
    """One forward and backward of `run` under the profiler: the device
    ms in the flash kernels and in everything else (the ring's merges,
    its lse masks, the concatenations), and the busy share of the
    profiled wall clock.  The table goes to
    chiprun_out/chip_smoke_ring_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out, backward = run()
        backward(out)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    del out
    kern = device_events(torch, prof)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           "chip_smoke_ring_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=30))
    if not kern:
        return {"device_busy_ms": "not measured"}
    flash = sum(e.time_range.elapsed_us() for e in kern
                if "fa_fwd" in e.name or "fa_bwd" in e.name) / 1e3
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    return {"device_busy_ms": busy, "flash_kernel_ms": flash,
            "other_device_ms": busy - flash, "profiled_wall_ms": wall_ms,
            "busy_share": busy / wall_ms, "kernels": len(kern)}


def long_attention(torch, tfa, s: int) -> dict:
    """15.1-15.2 at sequence length `s`: each sp impl's forward and
    backward over LONG_SP emulated ranks (`long_context.emulated`, the
    gloo tests' bodies with the transport swapped) against one
    whole-sequence kernel call, and at 4096 against the plain version
    too: o, lse, dq, dk and dv per row at FA_TOL (lse at FA_LSE_TOL); the
    launches of one forward and backward per kernel; the ms of each half
    beside the whole-sequence call's."""
    from dlrover_wuqiong_tpu_torch.parallel import long_context as tlc

    q, k, v, do = long_inputs(torch, s, seed=s)

    def whole():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o, lse = tfa.flash_attention_with_lse(*leaves, True)
        return (o, lse, leaves), lambda out: torch.autograd.backward(
            out[0], do)

    def sp_run(impl):
        def run():
            chunks = [[c.detach().clone().requires_grad_()
                       for c in t.chunk(LONG_SP, 2)] for t in (q, k, v)]
            outs = tlc.emulated(impl, *chunks, causal=True, with_lse=True)
            o = torch.cat([x[0] for x in outs], 2)
            lse = torch.cat([x[1] for x in outs], 2)
            return (o, lse, chunks), lambda out: torch.autograd.backward(
                out[0], do)
        return run

    def grads(leaves):
        return [torch.cat([c.grad for c in t], 2) if isinstance(t, list)
                else t.grad for t in leaves]

    out, backward = whole()
    backward(out)
    ref = [out[0].detach(), out[1].detach()] + grads(out[2])
    refs = {"whole-sequence kernel": ref}
    if s == 4096:
        scale = 1.0 / LONG_D ** 0.5
        flat = [t.reshape(LONG_B * LONG_H, s, LONG_D) for t in (q, k, v, do)]
        o_p, lse_p = tfa._fa_forward_plain(*flat[:3], True, scale)
        dq, dk, dv = tfa._fa_backward_plain(*flat[:3], o_p, lse_p, flat[3],
                                            True, scale)
        shape = (LONG_B, LONG_H, s, LONG_D)
        refs["plain"] = [o_p.reshape(shape), lse_p.reshape(shape[:3]),
                         dq.reshape(shape), dk.reshape(shape),
                         dv.reshape(shape)]
        del o_p, lse_p, dq, dk, dv, flat
    rows = {"whole": dict(zip(("fwd_ms", "bwd_ms"),
                              long_timed(torch, whole)))}
    for impl in LONG_IMPLS:
        run = sp_run(impl)
        torch.cuda.synchronize()
        tfa.reset_launches()
        out, backward = run()
        backward(out)
        torch.cuda.synchronize()
        row = {"launches": dict(tfa.LAUNCHES)}
        got = [out[0].detach(), out[1].detach()] + grads(out[2])
        for against, want in refs.items():
            errs = {name: _row_err(torch, g, w) for name, g, w in zip(
                ("o", "dq", "dk", "dv"), got[:1] + got[2:],
                want[:1] + want[2:])}
            fin = torch.isfinite(want[1])
            errs["lse"] = (got[1][fin] - want[1][fin]).abs().max().item()
            check(all(errs[n] <= FA_TOL for n in ("o", "dq", "dk", "dv"))
                  and errs["lse"] <= FA_LSE_TOL and bool(
                      (torch.isfinite(got[1]) == fin).all()),
                  f"15 {impl} at S={s} against the {against}: {errs} "
                  f"(tolerance {FA_TOL}, lse {FA_LSE_TOL})")
            row[f"err_vs_{against.split()[0]}"] = errs
        del out, got
        row["fwd_ms"], row["bwd_ms"] = long_timed(torch, run)
        if impl == "ring" and s == LONG_SEQS[0]:
            row["profile"] = long_profile(torch, run)
        rows[impl] = row
    check(sum(rows["ring"]["launches"].values()) > 0 and all(
        sum(rows[i]["launches"].values()) > 0 for i in LONG_IMPLS),
        f"15 S={s}: a schedule launched no kernel: {rows}")
    return rows


def long_build(torch, tfa, name: str, strategy) -> dict:
    """One 15.3 build (plain with `strategy` None): warm-up and timed
    steps, the losses, launches and a host copy of the parameters."""
    import dataclasses
    import gc

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    if name == "gpt2_moe8":
        model = GPT(dataclasses.replace(GPTConfig.gpt2(), moe_experts=8,
                                        moe_top_k=2,
                                        moe_capacity_factor=1.25))
        batch = train_batch(torch, 50257, b=MOE_B)
    else:
        model = Llama(dataclasses.replace(LlamaConfig.llama3_8b(),
                                          num_layers=LLAMA_LAYERS))
        batch = train_batch(torch, model.config.vocab_size, b=LLAMA_B,
                            t=LLAMA_T)
    res = auto_accelerate(model, optimizer=adamw(3e-4), seed=0,
                          strategy=strategy)
    warm, _, _, _ = run_steps(torch, tfa, res, batch, LONG_WARMUP)
    losses, norms, ms, lc = run_steps(torch, tfa, res, batch, LONG_STEPS)
    params = [_local(p).detach().cpu() for p in res.model.parameters()]
    row = {"losses": warm + losses, "grad_norms": norms, "ms_per_step": ms,
           "launches": lc, "plan": res.strategy.plan.describe(),
           "attn_impl": getattr(res.model.config, "attn_impl", None)}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return row, params


def long_strategies(torch, tfa) -> tuple:
    """15.3, in phase 14's NCCL world of one: each strategy at size 1
    beside its plain build, the losses and parameters bitwise; size 1
    falls through (no ep placement, no sp rewrite), as in JAX."""
    out, launches = {}, {}
    with nccl_world():
        for name, strategy in LONG_STRATEGIES.items():
            plain, p_plain = long_build(torch, tfa, name, None)
            built, p_built = long_build(torch, tfa, name, strategy)
            same = len(p_plain) == len(p_built) and all(
                torch.equal(a, b) for a, b in zip(p_plain, p_built))
            del p_plain, p_built
            check(built["losses"] == plain["losses"] and same,
                  f"15.3 {name}: losses {built['losses']} against the "
                  f"plain build's {plain['losses']}, parameters bitwise "
                  f"{same}")
            check(built["attn_impl"] == plain["attn_impl"],
                  f"15.3 {name}: size 1 rewrote attn_impl to "
                  f"{built['attn_impl']}")
            out[name] = {"plain": plain, "strategy": built,
                         "bitwise_plain": same}
            launches[f"{name}_strategy"] = built["launches"]
    return out, launches


def long_context_phase(torch, tfa) -> tuple:
    """Phase 15: sequence parallel attention on the card and the last two
    mesh strategies.  NCCL puts no two ranks on one card, so 15.1-15.2
    drive the sp schedules in this one process: `long_context.emulated`
    hands each emulated rank's local body (the code the gloo tests run)
    a rotation or a gather that reads rank (my - t) mod n's chunk, the
    ranks' bodies in turn in one autograd graph (Ulysses' all-to-all
    needs every rank's intermediate, so its body runs once over the
    ranks stacked on the batch axis).  The ring at the longer length is
    also profiled once (`long_profile`).  Returns (report, {run: flash
    launches})."""
    import gc

    t0 = time.monotonic()
    out, walls, launches = {}, {}, {}
    for s in LONG_SEQS:
        t = time.monotonic()
        out[f"s{s}"] = long_attention(torch, tfa, s)
        walls[f"15.1-2 S={s}"] = time.monotonic() - t
        for impl in LONG_IMPLS:
            launches[f"{impl}_s{s}"] = out[f"s{s}"][impl]["launches"]
        gc.collect()
        torch.cuda.empty_cache()
    t = time.monotonic()
    out["strategies"], more = long_strategies(torch, tfa)
    launches.update(more)
    walls["15.3"] = time.monotonic() - t
    out["walls_s"] = walls
    out["phase_wall_s"] = time.monotonic() - t0
    return out, launches


def print_long_context(lc: dict):
    """Phase 15's lines: the report as JSON, then its numbers."""
    print("long context: " + json.dumps(lc))
    for s in LONG_SEQS:
        rows = lc[f"s{s}"]
        w = rows["whole"]
        print(f"long context: S={s} (b {LONG_B}, {LONG_H} heads, d "
              f"{LONG_D}, causal, sp {LONG_SP} emulated): whole-sequence "
              f"kernel call fwd {w['fwd_ms']:.3f} ms, bwd "
              f"{w['bwd_ms']:.3f} ms")
        for impl in LONG_IMPLS:
            r = rows[impl]
            errs = "; ".join(
                f"vs {k[7:]} " + ", ".join(f"{n} {v:.2e}"
                                           for n, v in r[k].items())
                for k in r if k.startswith("err_vs_"))
            print(f"long context: S={s} {impl}: fwd {r['fwd_ms']:.3f} ms, "
                  f"bwd {r['bwd_ms']:.3f} ms; launches {r['launches']}; "
                  f"{errs}")
            if "profile" in r:
                print(f"long context: S={s} {impl}, one forward and "
                      f"backward profiled: " + json.dumps(r["profile"]))
    for name, r in lc["strategies"].items():
        st, pl = r["strategy"], r["plain"]
        print(f"long context: 15.3 {name} under {st['plan']} (size 1 falls "
              f"through, as in JAX): {st['ms_per_step']:.2f} ms a step "
              f"against the plain build's {pl['ms_per_step']:.2f}; losses "
              f"and parameters bitwise the plain build's: "
              f"{r['bitwise_plain']}")
    w = lc["walls_s"]
    print(f"long context: phase wall {lc['phase_wall_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in w.items()) + ")")


# ------------------------------------------------------------- phase 16

#: 16.1: steps before the flash save, and after the restore
INTEROP_BEFORE, INTEROP_AFTER = 3, 2
#: 16.2: DiLoCo over two emulated replica groups of GPT-2 124M, each on
#: its own batch of DILOCO_B rows; a sync every DILOCO_SYNC steps
DILOCO_B, DILOCO_SYNC, DILOCO_STEPS, DILOCO_GROUPS = 8, 4, 12, 2
#: 16.2: timed plain steps of one group's build (its inner step alone)
DILOCO_PLAIN = 3


def tree_locals(tree) -> dict:
    """{checkpoint name: the local tensor} of a state's checkpoint tree
    (a MeshPiece's local piece)."""
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        MeshPiece,
        flatten_state_dict,
    )

    return {n: (v.local if isinstance(v, MeshPiece) else v)
            for n, v in flatten_state_dict(tree).items()}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def interop_dcp(torch, tfa) -> tuple:
    """16.1: GPT-2 124M (phase 4b's build) under fsdp in phase 14's NCCL
    world of one with adamw8bit: INTEROP_BEFORE steps, a flash save to
    disk, `export_dcp` of it (a fresh build as the template), `load_dcp`
    into another fresh build (every leaf of its checkpoint tree bitwise
    the trained state's), a timed `save_dcp` and `load_dcp` of the state
    (wall and bytes), then INTEROP_AFTER steps of the trained and the
    loaded builds: losses and parameters bitwise.  Returns (report,
    flash launches of its steps)."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.optimizers import adamw8bit

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    batch = train_batch(torch, 50257)

    def build(seed):
        return auto_accelerate(GPT(cfg), seed=seed,
                               optimizer=adamw8bit(3e-4, weight_decay=1e-4),
                               strategy=[("fsdp", {})])

    launches = {k: 0 for k in tfa.LAUNCHES}

    def steps(res, n):
        out = run_steps(torch, tfa, res, batch, n)
        for k, v in out[3].items():
            launches[k] += v
        return out

    with elastic_workspace("dwt-dcp-") as (out_dir, opened):
        from dlrover_wuqiong_tpu_torch.checkpoint import dcp_compat
        from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
            FlashCheckpointer,
            StorageType,
        )
        from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
            AsyncCheckpointSaver,
        )

        a = build(0)
        before, _, ms, _ = steps(a, INTEROP_BEFORE)
        flash_dir = os.path.join(out_dir, "flash")
        ck = FlashCheckpointer(flash_dir, job_name=os.environ["DWT_JOB_NAME"],
                               standalone=True)
        t0 = time.monotonic()
        ck.save_checkpoint(INTEROP_BEFORE, a.state.tree(), StorageType.DISK)
        check(ck.wait_latest_checkpoint(300), "16.1: the flash save did "
              "not commit")
        flash_s = time.monotonic() - t0
        ck.close()
        AsyncCheckpointSaver.reset()
        b = build(1)
        t0 = time.monotonic()
        dcp_compat.export_dcp(flash_dir, os.path.join(out_dir, "dcp"),
                              b.state, job_name=os.environ["DWT_JOB_NAME"]
                              + "-export")
        torch.cuda.synchronize()
        export_s = time.monotonic() - t0
        del b
        c = build(2)
        t0 = time.monotonic()
        dcp_compat.load_dcp(os.path.join(out_dir, "dcp"), c.state)
        torch.cuda.synchronize()
        export_load_s = time.monotonic() - t0
        want, got = tree_locals(a.state.tree()), tree_locals(c.state.tree())
        same = sorted(want) == sorted(got) and all(
            torch.equal(want[n], got[n]) for n in want)
        check(same, "16.1: the state loaded from the DCP export is not "
              "bitwise the trained one")
        quant = sum(n.endswith("/0") and "/mu/" in n for n in want)
        check(quant > 0, "16.1: no adamw8bit codes in the checkpoint tree")
        t0 = time.monotonic()
        dcp_compat.save_dcp(os.path.join(out_dir, "dcp2"), a.state)
        save_s = time.monotonic() - t0
        dcp_bytes = dir_bytes(os.path.join(out_dir, "dcp2"))
        t0 = time.monotonic()
        dcp_compat.load_dcp(os.path.join(out_dir, "dcp2"), c.state)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        la, _, _, _ = steps(a, INTEROP_AFTER)
        lc_, _, _, _ = steps(c, INTEROP_AFTER)
        check(la == lc_, f"16.1: losses after the DCP round trip {lc_} "
              f"against the uninterrupted run's {la}")
        params = all(torch.equal(_local(p), _local(q)) for p, q in zip(
            a.model.parameters(), c.model.parameters()))
        check(params, "16.1: parameters after the DCP round trip are not "
              "bitwise the uninterrupted run's")
        check(before[-1] < before[0], f"16.1: loss did not fall: {before}")
        return {"losses": before + la, "ms_per_step": ms,
                "flash_save_s": flash_s, "export_s": export_s,
                "export_load_s": export_load_s, "dcp_save_s": save_s,
                "dcp_load_s": load_s, "dcp_bytes": dcp_bytes,
                "dcp_save_bytes_per_s": dcp_bytes / save_s,
                "dcp_load_bytes_per_s": dcp_bytes / load_s,
                "leaves": len(want), "quantized_code_leaves": quant,
                "bitwise_after_load": same,
                "bitwise_after_steps": params}, launches


def diloco_emulated(torch, tfa) -> tuple:
    """16.2: local SGD (DiLoCo) on GPT-2 124M (remat off, adamw(3e-4)),
    DILOCO_GROUPS replica groups emulated in this process: each group a
    one-device build from one seed on its own batch (B = DILOCO_B,
    T = 1024), stepped by `parallel.local_sgd.emulated_step` (the gloo
    tests' body, the sum over the groups a sum of tensors), a sync every
    DILOCO_SYNC of DILOCO_STEPS steps, with the mean and then with GTA:
    the groups apart after the first step and bitwise equal after every
    sync; the mean loss of each round of DILOCO_SYNC steps below the
    round before; 12 + 12 flash launches a group and step.  The ms of an
    inner step and a sync step (both groups) beside DILOCO_PLAIN timed
    steps of one group's build alone (a plain GPT-2 step at the same B).
    Returns (report, flash launches)."""
    import dataclasses
    import gc

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.parallel import local_sgd as tls
    from dlrover_wuqiong_tpu_torch.trainer.train_step import (
        adamw,
        make_train_step,
    )

    cfg = dataclasses.replace(GPTConfig.gpt2(), remat=False)
    batches = [train_batch(torch, 50257, seed=16 + g, b=DILOCO_B)
               for g in range(DILOCO_GROUPS)]
    out, launches = {}, {}
    for reduce in ("mean", "gta"):
        gc.collect()
        torch.cuda.empty_cache()
        ls = tls.LocalSGDConfig(sync_every=DILOCO_SYNC, reduce=reduce)
        builds = [auto_accelerate(GPT(cfg), optimizer=adamw(3e-4), seed=0)
                  for _ in range(DILOCO_GROUPS)]
        states = [tls.init_diloco_state(r.state, ls) for r in builds]
        inner = make_train_step(builds[0].loss_fn)
        torch.cuda.synchronize()
        tfa.reset_launches()
        losses, ms = [], []
        for step in range(1, DILOCO_STEPS + 1):
            t0 = time.monotonic()
            _, loss = tls.emulated_step(states, batches, inner, ls)
            losses.append(loss.item())
            ms.append((time.monotonic() - t0) * 1e3)
            groups = [list(s.inner_params.parameters()) for s in states]
            equal = all(torch.equal(p, q)
                        for p, q in zip(groups[0], groups[1]))
            synced = step % DILOCO_SYNC == 0
            check(equal == synced or step > 1 and not synced,
                  f"16.2 {reduce}: step {step}: groups bitwise equal "
                  f"{equal}, a sync step {synced}")
        launches[reduce] = dict(tfa.LAUNCHES)
        expect_launches(launches[reduce], DILOCO_STEPS * DILOCO_GROUPS,
                        cfg.n_layer, 1, "fused", f"16.2 {reduce}")
        rounds = [sum(losses[i:i + DILOCO_SYNC]) / DILOCO_SYNC
                  for i in range(0, DILOCO_STEPS, DILOCO_SYNC)]
        check(all(x == x for x in losses) and all(
            b < a for a, b in zip(rounds, rounds[1:])),
            f"16.2 {reduce}: the rounds' mean losses {rounds} do not fall")
        sync = [m for i, m in enumerate(ms, 1) if i % DILOCO_SYNC == 0]
        plain = [m for i, m in enumerate(ms, 1)
                 if i % DILOCO_SYNC and i > 1]
        _, _, plain_ms, _ = run_steps(torch, tfa, types.SimpleNamespace(
            state=states[0].inner_state(), train_step=inner), batches[0],
            DILOCO_PLAIN)
        out[reduce] = {"losses": losses, "round_mean_losses": rounds,
                       "inner_step_ms": sum(plain) / len(plain),
                       "sync_step_ms": sum(sync) / len(sync),
                       "plain_step_ms": plain_ms, "step_ms": ms}
        del builds, states
    return out, launches


def streamed_scan(torch, tfa) -> dict:
    """16.3: the streamed scans (`_fa_forward_streamed` over key blocks,
    `_fa_backward_streamed` over query blocks), called directly on CUDA
    tensors as phase 3b calls the plain versions, at Llama-3 8B's (32,
    4096, 4096, 128) causal, bf16, against kernels 1 (forward), 3 and 4
    (the split dq and dk/dv): every row of o, dq, dk and dv within
    `FA_TOL`, lse within `FA_LSE_TOL`; and the peak memory a forward and
    backward allocates beyond its inputs, streamed against the dense
    plain version's.  The kernel calls here compare: they count in no
    run."""
    s = LLAMA_SHAPE
    bh, n, d = s["b"] * s["h"], s["s"], s["d"]
    scale = 1.0 / d ** 0.5
    q, k, v, do = fa_inputs(torch, bh, n, n, d, seed=1600)
    o_k, lse_k = tfa._fa_forward_kernel(q, k, v, True, scale)
    g_k = tfa._fa_backward_kernel(q, k, v, o_k, lse_k, do, True, scale,
                                  None, "split")
    out = {"shape": [bh, n, n, d]}
    for name, fwd, bwd in (
            ("streamed", tfa._fa_forward_streamed,
             tfa._fa_backward_streamed),
            ("dense", tfa._fa_forward_plain, tfa._fa_backward_plain)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        o, lse = fwd(q, k, v, True, scale)
        g = bwd(q, k, v, o, lse, do, True, scale)
        torch.cuda.synchronize()
        row = {"ms": (time.monotonic() - t0) * 1e3,
               "peak_bytes": torch.cuda.max_memory_allocated() - base}
        if name == "streamed":
            errs = {"o": _row_err(torch, o, o_k)}
            errs.update({w: _row_err(torch, a, b)
                         for w, a, b in zip(("dq", "dk", "dv"), g, g_k)})
            lse_err = (lse - lse_k).abs().max().item()
            for w, e in errs.items():
                check(e <= FA_TOL, f"16.3: streamed {w} against the "
                      f"kernel: row err {e} (FA_TOL {FA_TOL})")
            check(lse_err <= FA_LSE_TOL, f"16.3: streamed lse against the "
                  f"kernel: {lse_err} (FA_LSE_TOL {FA_LSE_TOL})")
            row.update(row_err=errs, lse_err=lse_err)
        out[name] = row
        del o, lse, g
    check(out["streamed"]["peak_bytes"] < out["dense"]["peak_bytes"],
          f"16.3: the streamed peak {out['streamed']['peak_bytes']} is not "
          f"below the dense {out['dense']['peak_bytes']}")
    return out


def interop_phase(torch, tfa) -> tuple:
    """Phase 16: checkpoint interop and local SGD.  16.1 in an NCCL world
    of one of its own, destroyed at the end; 16.2 and 16.3 in this
    process.  Returns (report, {run: flash launches})."""
    import gc

    t0 = time.monotonic()
    out, walls, launches = {}, {}, {}
    with nccl_world():
        out["dcp"], launches["dcp"] = interop_dcp(torch, tfa)
    walls["16.1"] = time.monotonic() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    out["diloco"], more = diloco_emulated(torch, tfa)
    launches.update({f"diloco_{k}": v for k, v in more.items()})
    walls["16.2"] = time.monotonic() - t
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    out["streamed"] = streamed_scan(torch, tfa)
    walls["16.3"] = time.monotonic() - t
    out["walls_s"] = walls
    out["phase_wall_s"] = time.monotonic() - t0
    return out, launches


def print_interop(ip: dict):
    """Phase 16's lines: the report as JSON, then its numbers."""
    print("interop: " + json.dumps(ip))
    r = ip["dcp"]
    print(f"interop: 16.1 GPT-2 124M under fsdp (a world of one) with "
          f"adamw8bit, {r['ms_per_step']:.2f} ms a step; flash save to "
          f"disk {r['flash_save_s']:.3f} s; export_dcp (flash load + DCP "
          f"save) {r['export_s']:.3f} s, load_dcp of it "
          f"{r['export_load_s']:.3f} s, {r['leaves']} leaves bitwise; "
          f"save_dcp {r['dcp_save_s']:.3f} s, load_dcp "
          f"{r['dcp_load_s']:.3f} s of {r['dcp_bytes']} bytes "
          f"({r['dcp_save_bytes_per_s'] / 1e9:.3f} / "
          f"{r['dcp_load_bytes_per_s'] / 1e9:.3f} GB/s); "
          f"{INTEROP_AFTER} steps after it bitwise the uninterrupted run")
    for reduce, d in ip["diloco"].items():
        print(f"interop: 16.2 DiLoCo {reduce}, {DILOCO_GROUPS} groups "
              f"emulated, B = {DILOCO_B} a group, sync every "
              f"{DILOCO_SYNC}: rounds' mean losses "
              + ", ".join(f"{x:.4f}" for x in d["round_mean_losses"])
              + f"; an inner step {d['inner_step_ms']:.2f} ms, a sync step "
              f"{d['sync_step_ms']:.2f} ms (both groups), a plain GPT-2 "
              f"step at B = {DILOCO_B} {d['plain_step_ms']:.2f} ms; groups "
              f"bitwise equal after every sync")
    st = ip["streamed"]
    print(f"interop: 16.3 streamed scan at {st['shape']} causal: row errs "
          "against kernels 1, 3, 4 " + ", ".join(
              f"{w} {e:.2e}" for w, e in st["streamed"]["row_err"].items())
          + f", lse {st['streamed']['lse_err']:.2e}; forward + backward "
          f"peak {st['streamed']['peak_bytes'] / 1e9:.3f} GB "
          f"({st['streamed']['ms']:.1f} ms) against the dense plain "
          f"version's {st['dense']['peak_bytes'] / 1e9:.3f} GB "
          f"({st['dense']['ms']:.1f} ms)")
    w = ip["walls_s"]
    print(f"interop: phase wall {ip['phase_wall_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in w.items()) + ")")


# ------------------------------------------------------------ phase 17

#: 17.1: GPT-2 124M, pp 4 emulated, B 16 in M 8 microbatches, T 1024;
#: interleaved with v 3 (one layer a chunk)
PIPE_PP, PIPE_B, PIPE_M, PIPE_V, PIPE_TIMED = 4, 16, 8, 3, 3
#: 17.2: Llama-3 8B widths at 4 layers, B 4 in M 4 microbatches, T 4096
PIPE_LLAMA = dict(layers=4, b=4, t=4096, m=4, timed=2)
#: a schedule's first step against the plain step on the same batch and
#: init, bf16 compute: the loss, the grad norm, each leaf's gradient in
#: relative L2, and the share of each leaf's entries that the update
#: puts more than half an lr step from the plain update's (Adam's first
#: step is sign-like: an entry whose gradient sits at rounding size may
#: take the other sign)
PIPE_LOSS_RTOL, PIPE_NORM_RTOL, PIPE_GRAD_RTOL = 5e-3, 2e-2, 5e-2
PIPE_OFF_SHARE = 0.02
PIPE_LR = 3e-4


def _host(torch, tensors) -> list:
    return [t.detach().to("cpu", copy=True) for t in tensors]


def pipe_compare(torch, model, plain: dict, loss: float, gnorm: float,
                 tag: str) -> dict:
    """A schedule's first step (its loss, grad norm, the gradients left
    in ``.grad`` and the updated parameters) against the plain step's
    (`plain`: host copies), within the PIPE_* tolerances."""
    grad_err, off = (0.0, ""), (0.0, "")
    for (name, p), g0, p0 in zip(model.named_parameters(), plain["grads"],
                                 plain["params"]):
        g0, p0 = g0.to(p.device), p0.to(p.device)
        err = ((p.grad.float() - g0.float()).norm()
               / g0.float().norm().clamp_min(1e-30)).item()
        grad_err = max(grad_err, (err, name))
        moved = (p.detach() - p0).abs() > PIPE_LR / 2
        if name.endswith("c_attn.bias"):
            # GPT's key bias (the middle third) has a zero gradient in
            # exact arithmetic (softmax ignores what it adds to a row):
            # Adam moves it by rounding noise, either way
            q, _, v = moved.chunk(3)
            moved = torch.cat([q, v])
        off = max(off, (moved.float().mean().item(), name))
    out = {"loss": loss, "grad_norm": gnorm,
           "loss_rel_err": abs(loss - plain["loss"]) / abs(plain["loss"]),
           "grad_norm_rel_err": abs(gnorm - plain["grad_norm"])
           / plain["grad_norm"], "worst_leaf_grad_rel_err": grad_err[0],
           "worst_grad_leaf": grad_err[1],
           "worst_leaf_off_share": off[0], "worst_off_leaf": off[1]}
    check(out["loss_rel_err"] <= PIPE_LOSS_RTOL, f"{tag}: loss {loss} vs "
          f"the plain step's {plain['loss']} (rtol {PIPE_LOSS_RTOL})")
    check(out["grad_norm_rel_err"] <= PIPE_NORM_RTOL, f"{tag}: grad norm "
          f"{gnorm} vs {plain['grad_norm']} (rtol {PIPE_NORM_RTOL})")
    check(grad_err[0] <= PIPE_GRAD_RTOL, f"{tag}: {grad_err[1]}'s gradient "
          f"is {grad_err[0]} from the plain step's (rtol {PIPE_GRAD_RTOL})")
    check(off[0] <= PIPE_OFF_SHARE, f"{tag}: {off[0]} of {off[1]}'s "
          f"entries moved more than lr/2 from the plain update (<= "
          f"{PIPE_OFF_SHARE})")
    return out


def pipe_timed(torch, tfa, step, state, batch, n: int, pipe=None) -> dict:
    """n timed steps (CUDA-synchronized wall per step), the launch counts
    set to 0 just before and read just after, the peak memory over them
    (and above the memory held before them), the ticks a step."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ticks0 = pipe.ticks if pipe is not None else 0
    tfa.reset_launches()
    ms, host = [], []
    for _ in range(n):
        t0 = time.monotonic()
        state, m = step(state, batch)
        host.append((time.monotonic() - t0) * 1e3)
        m["loss"].item()
        ms.append((time.monotonic() - t0) * 1e3)
    launches = dict(tfa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ms_sorted = sorted(ms)
    return {"ms": ms, "median_ms": ms_sorted[len(ms) // 2],
            "spread_ms": ms_sorted[-1] - ms_sorted[0],
            "host_ms": host,
            "median_host_ms": sorted(host)[len(host) // 2],
            "launches": launches,
            "launches_per_step": {k: v / n for k, v in launches.items()},
            "peak_bytes": peak, "peak_above_state_bytes": peak - base,
            "ticks_per_step": (pipe.ticks - ticks0) / n if pipe else None}


def pipe_profile(torch, step, state, batch, median_ms: float,
                 tag: str) -> dict:
    """One more step under torch.profiler: the device's busy ms (its
    kernels and copies), its share of the unprofiled median step
    (`median_ms`), the kernels a step and their mean length.  The op
    table (by self CPU time) goes to
    chiprun_out/chip_smoke_pipeline_profile.txt under `tag`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, m = step(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kern = device_events(torch, prof)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           "chip_smoke_pipeline_profile.txt"), "a") as f:
        f.write(f"===== {tag}\n" + prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=25) + "\n")
    if not kern:
        return {"device_busy_ms": "not measured"}
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / median_ms, "kernels": len(kern),
            "mean_kernel_us": busy * 1e3 / len(kern)}


def pipe_grad_peak(torch, model, fwd_bwd) -> int:
    """The bytes one forward and backward (`fwd_bwd`, no update)
    allocates at its peak above what was allocated before it (the
    gradients included); the gradients are dropped after."""
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    model.zero_grad(set_to_none=True)
    return peak


def pipe_family(torch, tfa, make_model, batch, schedules, m: int, v: int,
                timed: int, tag: str, profiled=()) -> tuple:
    """One seeded build of `make_model()` (adamw(PIPE_LR), bf16 compute):
    the plain one-device step, then each schedule's first step from the
    same init, pp PIPE_PP emulated (`parallel.pipeline.EmulatedPipeline`
    over the same model), held against it (`pipe_compare`); then
    `timed` steps of each (`pipe_timed`), the plain step's too, and the
    peak of one forward and backward alone (`pipe_grad_peak`); the runs
    named in `profiled` ("plain" or a schedule) take one profiled step
    more (`pipe_profile`).  Returns (report, {schedule: flash launches
    of its timed steps})."""
    import gc

    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.parallel.pipeline import (
        EmulatedPipeline,
        pipeline_step,
        schedule_ticks,
    )
    from dlrover_wuqiong_tpu_torch.trainer.train_step import (
        TrainState,
        adamw,
        make_train_step,
    )

    res = auto_accelerate(make_model(), optimizer=adamw(PIPE_LR), seed=0)
    model, loss_fn = res.model, res.loss_fn
    init = _host(torch, model.parameters())
    del res

    def fresh():
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
                p.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        return TrainState.create(model, adamw(PIPE_LR))

    plain_step = make_train_step(loss_fn)
    state, met = plain_step(fresh(), batch)
    plain = {"loss": met["loss"].item(), "grad_norm": met["grad_norm"].item(),
             "grads": _host(torch, (p.grad for p in model.parameters())),
             "params": _host(torch, model.parameters())}
    out = {"plain": {"loss": plain["loss"], "grad_norm": plain["grad_norm"],
                     **pipe_timed(torch, tfa, plain_step, state, batch,
                                  timed)}}
    if "plain" in profiled:
        out["plain"]["profile"] = pipe_profile(
            torch, plain_step, state, batch, out["plain"]["median_ms"],
            f"{tag} plain")
    out["plain"]["fwd_bwd_peak_bytes"] = pipe_grad_peak(
        torch, model, lambda: loss_fn(model, batch).backward())
    del state
    launches = {"plain": out["plain"]["launches"]}
    for sched in schedules:
        vs = v if sched == "interleaved" else 1
        pipe = EmulatedPipeline(model, PIPE_PP, m, sched, vs)
        step = make_train_step(loss_fn, value_and_grad_fn=(
            lambda _, b, pipe=pipe: pipeline_step(pipe, loss_fn, b)))
        state, met = step(fresh(), batch)
        row = pipe_compare(torch, model, plain, met["loss"].item(),
                           met["grad_norm"].item(), f"{tag} {sched}")
        row.update(pipe_timed(torch, tfa, step, state, batch, timed, pipe))
        row["host_ms_per_tick"] = row["median_host_ms"] / \
            row["ticks_per_step"]
        if sched in profiled:
            row["profile"] = pipe_profile(torch, step, state, batch,
                                          row["median_ms"], f"{tag} {sched}")
        row["fwd_bwd_peak_bytes"] = pipe_grad_peak(
            torch, model, lambda: pipeline_step(pipe, loss_fn, batch))
        fwd_ticks = schedule_ticks(sched, m, PIPE_PP, vs)[0]
        row["schedule_ticks"] = fwd_ticks
        want = m + 2 * (PIPE_PP - 1) if sched == "1f1b" else 2 * fwd_ticks
        check(row["ticks_per_step"] == want, f"{tag} {sched}: "
              f"{row['ticks_per_step']} ticks a step, not {want}")
        check(row["launches"]["flash_attention_fwd"] > 0, f"{tag} {sched}: "
              "the flash forward kernel was not launched")
        out[sched] = row
        launches[sched] = row["launches"]
        del state, pipe, step
    model.zero_grad(set_to_none=True)
    del model, init, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def pipe_hybrid(torch) -> dict:
    """17.3: `rl.hybrid.HybridEngine` in an NCCL world of one: GPT-2
    124M's parameters placed for training and synced to the decode
    placement twice, bitwise the input; `last_sync_s` of the second."""
    from dlrover_wuqiong_tpu_torch.convert import _flatten
    from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig, init_params
    from dlrover_wuqiong_tpu_torch.rl.hybrid import HybridEngine

    params = init_params(GPTConfig.gpt2(), seed=0)
    eng = HybridEngine(decode_tp=1)
    train = eng.place_train(params)
    syncs = []
    for _ in range(2):
        dec = eng.sync_to_decode(train)
        syncs.append(eng.last_sync_s)
    flat, got = _flatten(params), _flatten(dec)
    check(sorted(flat) == sorted(got) and all(
        torch.equal(got[n].to_local(), flat[n]) for n in flat),
        "17.3: the decode placement is not bitwise the parameters")
    n_bytes = sum(t.numel() * t.element_size() for t in flat.values())
    return {"leaves": len(flat), "bytes": n_bytes, "sync_s": syncs,
            "last_sync_s": eng.last_sync_s,
            "received_bytes": eng.last_sync_bytes}


def pipeline_phase(torch, tfa, profiled=()) -> tuple:
    """Phase 17: pipeline parallelism, pp PIPE_PP stages emulated in this
    process through the schedules' own bodies.  17.1 GPT-2 124M (gpipe,
    1F1B, interleaved), 17.2 Llama-3 8B widths at 4 layers (1F1B, gpipe),
    17.3 the RL hybrid engine.  `profiled` names the GPT-2 runs ("plain",
    a schedule) that take one profiled step more (`pipe_profile`; about
    20 s each at ~25k kernels a step, so the whole script profiles
    none).  Returns (report, {run: flash launches})."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.models.llama import Llama, LlamaConfig

    t0 = time.monotonic()
    out, walls, launches = {}, {}, {}
    table = os.path.join(HERE, "chiprun_out",
                         "chip_smoke_pipeline_profile.txt")
    if os.path.exists(table):
        os.remove(table)
    gpt, more = pipe_family(
        torch, tfa, lambda: GPT(GPTConfig.gpt2()),
        train_batch(torch, 50257, seed=17, b=PIPE_B),
        ("gpipe", "1f1b", "interleaved"), PIPE_M, PIPE_V, PIPE_TIMED, "17.1",
        profiled)
    out["gpt2"] = gpt
    launches.update({f"gpt2_{k}": v for k, v in more.items()})
    walls["17.1"] = time.monotonic() - t0
    t = time.monotonic()
    L = PIPE_LLAMA
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=L["layers"])
    llama, more = pipe_family(
        torch, tfa, lambda: Llama(cfg),
        train_batch(torch, cfg.vocab_size, seed=172, b=L["b"], t=L["t"]),
        ("1f1b", "gpipe"), L["m"], 1, L["timed"], "17.2")
    out["llama"] = llama
    launches.update({f"llama_{k}": v for k, v in more.items()})
    walls["17.2"] = time.monotonic() - t
    t = time.monotonic()
    with nccl_world():
        out["hybrid"] = pipe_hybrid(torch)
    walls["17.3"] = time.monotonic() - t
    out["walls_s"] = walls
    out["phase_wall_s"] = time.monotonic() - t0
    return out, launches


def print_pipeline(pl: dict):
    """Phase 17's lines: the report as JSON, then its numbers."""
    print("pipeline: " + json.dumps(pl))
    for fam, (name, b, t) in (("gpt2", ("GPT-2 124M", PIPE_B, TRAIN_T)),
                              ("llama", (f"Llama-3 8B, "
                                         f"{PIPE_LLAMA['layers']} layers",
                                         PIPE_LLAMA["b"],
                                         PIPE_LLAMA["t"]))):
        d = pl[fam]
        p = d["plain"]
        for sched, r in d.items():
            pr = r.get("profile")
            if not pr or isinstance(pr["device_busy_ms"], str):
                continue
            print(f"pipeline: {name} {sched}, one profiled step: device "
                  f"busy {pr['device_busy_ms']:.1f} ms, "
                  f"{pr['device_busy_share']:.3f} of the median step "
                  f"{r['median_ms']:.1f} ms (the host's "
                  f"{r['median_host_ms']:.1f}); {pr['kernels']} kernels "
                  f"(mean {pr['mean_kernel_us']:.1f} us)")
        print(f"pipeline: {name}, B = {b}, T = {t}: the plain step "
              f"{p['median_ms']:.1f} ms (spread {p['spread_ms']:.1f}), peak "
              f"{p['peak_bytes'] / 1e9:.2f} GB, "
              f"{p['peak_above_state_bytes'] / 1e9:.2f} GB above the state, "
              f"forward + backward alone "
              f"{p['fwd_bwd_peak_bytes'] / 1e9:.2f} GB above it")
        for sched, r in d.items():
            if sched == "plain":
                continue
            lp = r["launches_per_step"]
            print(f"pipeline: {name} {sched} (pp {PIPE_PP} emulated): "
                  f"first step against the plain one: loss "
                  f"{r['loss_rel_err']:.2e}, grad norm "
                  f"{r['grad_norm_rel_err']:.2e}, worst leaf gradient "
                  f"{r['worst_leaf_grad_rel_err']:.2e} "
                  f"({r['worst_grad_leaf']}), worst leaf off share "
                  f"{r['worst_leaf_off_share']:.2e} "
                  f"({r['worst_off_leaf']}); "
                  f"{r['median_ms']:.1f} ms a step (spread "
                  f"{r['spread_ms']:.1f}; the host's "
                  f"{r['median_host_ms']:.1f}, "
                  f"{r['host_ms_per_tick']:.2f} a tick), peak "
                  f"{r['peak_bytes'] / 1e9:.2f} "
                  f"GB ({r['peak_above_state_bytes'] / 1e9:.2f} above the "
                  f"state; forward + backward alone "
                  f"{r['fwd_bwd_peak_bytes'] / 1e9:.2f}); "
                  f"{r['ticks_per_step']:.0f} ticks a step "
                  f"(schedule_ticks' forward {r['schedule_ticks']}); flash "
                  "launches a step " + ", ".join(
                      f"{k.replace('flash_attention_', '')} {v:.0f}"
                      for k, v in lp.items() if v))
    h = pl["hybrid"]
    print(f"pipeline: 17.3 HybridEngine (a world of one): sync_to_decode of "
          f"{h['leaves']} leaves, {h['bytes']} bytes, bitwise; last_sync_s "
          f"{h['last_sync_s']:.4f} (first {h['sync_s'][0]:.4f})")
    print(f"pipeline: phase wall {pl['phase_wall_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in pl["walls_s"].items())
          + ")")



def main():
    t_start = time.monotonic()
    # each phase's wall, printed before the kernels line
    walls, last = {}, [t_start]

    def lap(name):
        now = time.monotonic()
        walls[name] = round(now - last[0], 1)
        last[0] = now
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

    lap('1')
    # phase 2
    t0 = time.monotonic()
    ptxas = ptxas_start(_build)
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.2f} s")

    lap('2')
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

    lap('3')
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

    lap('3b')
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
    # then bf16, int8): host time varies from run to run
    runs = {"int8": [m_int8], "bf16": []}
    for quant in ("", "int8"):
        _, o, m, l = serve(torch, np, cfg, params, quant, reqs)
        check(len(o) == N_REQUESTS and all(
            len(v) == NEW_TOKENS for v in o.values()),
            f"quant={quant!r} run did not finish every request")
        check(quant or sum(l.values()) == 0, "quant='' launched kernels")
        runs[quant or "bf16"].append(m)
    print("serving: " + json.dumps({**runs, "int8_profile": prof}))

    lap('4')
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
    # diagnostics, one run each: the worker on this thread, and on its own
    # thread beside a 2 ms poller of the master's queue
    diag = {"main": [], "poll": []}
    for variant in ("main", "poll"):
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

    lap('4d')
    # phase 4b
    train, fa_launches, split_launches = train_phase(torch, tfa)
    print("training: " + json.dumps(train))

    lap('4b')
    # phase 4c
    llama, llama_launches = llama_train_phase(torch, tfa)
    print("llama training: " + json.dumps(llama))

    lap('4c')
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

    lap('5')
    # phase 5c
    llama_err, llama_losses = llama_reference(torch, np, tfa)
    print(f"reference: small Llama (D = 128, GQA, T = 2048, split route) "
          f"training card vs CPU: first step logits "
          f"{llama_err['logits']:.3g}, worst gradient "
          f"{llama_err['worst_grad']:.3g} ({llama_err['worst_grad_leaf']}) "
          f"relative (tolerance {NANO_GRAD_RTOL}); 3 adamw steps, losses "
          f"{llama_losses}, max relative difference "
          f"{llama_err['loss']:.3g} (tolerance {NANO_LOSS_RTOL})")

    lap('5c')
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

    lap('6b')
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

    lap('7')
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

    lap('8')
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

    lap('9')
    # phase 10 — the journaled master: SIGKILLed mid-shard, replayed
    gc.collect()
    torch.cuda.empty_cache()
    mk, mk_ref, mk_launches = master_kill_phase(torch, tfa)
    print_master_kill(mk, mk_ref)

    lap('10')
    # phase 11 — the warm standby: the primary SIGKILLed, the standby
    # promotes fenced, held to phase 10's uninterrupted run
    gc.collect()
    torch.cuda.empty_cache()
    fo, fo_launches = master_failover_phase(
        torch, tfa, ref=mk_ref, restart_gap_s=mk["restart_gap_s"])
    print_master_failover(fo)

    lap('11')
    # 14.4's child (CPU and meta only) runs beside phases 12-13
    start_fit_child()
    # phase 12 — the model knobs: fp8, the remat policies, experts
    gc.collect()
    torch.cuda.empty_cache()
    knobs, knob_launches = model_knobs_phase(torch, tfa)
    print_model_knobs(knobs)

    lap('12')
    # phase 13 — the optimizers: card against CPU, GPT-2 124M with each,
    # the checkpoint of their state, Llama-3 8B at 24 layers
    gc.collect()
    torch.cuda.empty_cache()
    optz, opt_launches = optimizers_phase(torch, tfa)
    print_optimizers(optz)

    lap('13')
    # phase 14 — the mesh strategies in an NCCL world of one, the 8B fit
    gc.collect()
    torch.cuda.empty_cache()
    par, par_launches = parallel_phase(torch, tfa)
    print_parallel(par)

    lap('14')
    # phase 15 — sequence parallel attention (emulated ranks) and the
    # expert/sequence parallel strategies at size 1
    gc.collect()
    torch.cuda.empty_cache()
    lctx, lc_launches = long_context_phase(torch, tfa)
    print_long_context(lctx)

    lap('15')
    # phase 16 — checkpoint interop (DCP, adamw8bit's sharded layout),
    # local SGD over emulated replica groups, the streamed scan
    gc.collect()
    torch.cuda.empty_cache()
    inter, inter_launches = interop_phase(torch, tfa)
    print_interop(inter)
    print("interop: flash launches by run (16.1's 7 steps, 16.2's 12 "
          "steps of 2 groups): " + json.dumps(inter_launches))

    lap('16')
    # phase 17 — pipeline parallelism (emulated stages) and the RL
    # hybrid engine
    gc.collect()
    torch.cuda.empty_cache()
    pipe, pipe_launches = pipeline_phase(torch, tfa)
    print_pipeline(pipe)

    lap('17')
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
            "launches_master_failover_route": fo_launches[name],
            "launches_model_knobs": knobs["int8_launches"][name],
            "launches_optimizers": optz["int8_launches"][name],
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
            "launches_master_failover_route": fo_launches[name],
            "launches_model_knobs": {
                run: (sum(l[name] for l in counts.values())
                      if run == "remat" else counts[name])
                for run, counts in knob_launches.items()},
            "launches_optimizers": {
                run: (sum(l[name] for l in counts.values())
                      if run == "gpt2" else counts[name])
                for run, counts in opt_launches.items()},
            "launches_mesh": {run: counts[name]
                              for run, counts in par_launches.items()},
            "launches_long_context": {run: counts[name] for run, counts
                                      in lc_launches.items()},
            "launches_interop": {run: counts[name] for run, counts
                                 in inter_launches.items()},
            "launches_pipeline": {run: counts[name] for run, counts
                                  in pipe_launches.items()},
        })
        if "llama3_8b" in t:
            kernels[-1]["llama3_8b"] = {
                key: t["llama3_8b"][key]
                for key in ("shape", "ms", "ms_host_paced", "plain_ms",
                            "bound_ms", "bound_by", "library_ms", "row_err",
                            "max_abs_err")}
    print("phase walls (s): " + json.dumps(walls))
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
