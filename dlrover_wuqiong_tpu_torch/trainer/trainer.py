"""High-level Trainer — one object from model to trained checkpoint.

Parity: dlrover_wuqiong_tpu/trainer/trainer.py — `TrainingArgs` (:38-159,
the same fields and defaults), `_MetricsPump` (:162-268) and `Trainer`:
the optimizer and its schedule (:298-303, :717-731), the elastic context
(:292-294), auto-resume through `FlashCheckpointer.load_checkpoint`
(:929-960) with ``DWT_ROLLBACK_BEFORE_STEP``, the fused K dispatch and
its auto-tune (:780-818) on the port's `fused_train_step`, the logging,
save, flash-stage and eval cadences at fusion boundaries (:761-778,
:1107-1160), SIGTERM graceful preemption and save-on-exit, the goodput
ledger's productive / rework / compile / dispatch accounting, the step
and goodput reports to the master, `_save` (:1206-1225) and `evaluate`
(:1227-1252, under ``torch.no_grad``).

In PyTorch the pieces map as follows:

- the optimizer defaults to `trainer.train_step.clip_adamw`, torch's
  counterpart of ``optax.chain(clip_by_global_norm(1.0),
  adamw(schedule, weight_decay))``; its checkpoint tree carries JAX's
  names (``opt_state/1/0/...``, ``opt_state/1/2/count``), so a JAX
  Trainer's checkpoint resumes here and the other way round;
- the schedule is optax's ``join_schedules([linear warmup from 0,
  cosine | linear decay to min_lr_ratio])`` (or the constant schedule's
  linear warmup), computed on the host in float32 from the restored
  count before each update, so K fused steps are K single steps bit for
  bit and a resumed run continues the schedule exactly;
- the data function is indexed by the step the restored state holds
  (``train_data(step)``), never by a counter of the process;
- the device is ``cuda`` unless the caller passes ``device``, as
  `auto_accelerate`'s is;
- a fused window stacks K host batches on a leading axis (the JAX
  package's `FusedBatchStager` comes with ``data/``, ROADMAP item 12).

Five hooks of the JAX Trainer import modules that are not ported; each
stays absent and the Trainer logs the list once at start: the
`StepProfiler` (:320, item 13), the `PerfObservatory` (:333, item 15),
the `ParalConfigListener` (:351, item 15), the `DeviceProber`
(:381-384, item 13), and the adaptive policy, variant tuner and warm
pool (:444-715, items 13 and 15).  A non-default knob that needs one of
them raises ValueError naming the item (``profile_trace_dir``,
``tune_variants > 0``, ``policy_steps > 0``); a default that would only
enable such a hook (``perf_window_every=8``, ``probe_interval=30.0``,
``tune_config_steps=25``) stays as it is.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..common.log import get_logger

logger = get_logger("trainer")


@dataclasses.dataclass
class TrainingArgs:
    """Parity: dlrover_wuqiong_tpu/trainer/trainer.py:38-159 — the knobs of
    the training loop, with the same names and defaults."""

    output_dir: str = "/tmp/dwt-run"
    max_steps: int = 1000
    global_batch_size: int = 32
    seq_len: int = 1024
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    lr_schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    min_lr_ratio: float = 0.1
    grad_accum_steps: int = 1
    strategy: Optional[list] = None          # auto_accelerate strategy
    logging_steps: int = 10
    save_steps: int = 200
    eval_steps: int = 0                      # 0 = no periodic eval
    max_eval_batches: int = 32
    seed: int = 0
    resume: bool = True                      # auto-resume from output_dir
    # "bf16" halves checkpoint bytes end to end (D2H staging, disk,
    # restore H2D) — lossy for f32 state (checkpointer docstring)
    ckpt_wire_dtype: Optional[str] = None

    def __post_init__(self):
        if self.ckpt_wire_dtype not in (None, "bf16"):
            raise ValueError(
                f"unsupported ckpt_wire_dtype {self.ckpt_wire_dtype!r}; "
                f"use 'bf16' or None")
        if self.fused_steps < 0:
            raise ValueError(
                f"fused_steps must be >= 0 (0 = auto-tune), got "
                f"{self.fused_steps}")
        if self.perf_window_every < 0 or self.perf_regress_windows < 1 \
                or not 0.0 < self.perf_overhead_budget <= 1.0:
            raise ValueError(
                f"bad perf-observatory knobs: perf_window_every="
                f"{self.perf_window_every} (>= 0), perf_regress_windows="
                f"{self.perf_regress_windows} (>= 1), perf_overhead_budget="
                f"{self.perf_overhead_budget} (in (0, 1])")
        if self.tune_variants < 0 or not 0.0 <= self.tune_hysteresis < 1.0:
            raise ValueError(
                f"bad autotuner knobs: tune_variants={self.tune_variants} "
                f"(>= 0; 0 = off), tune_hysteresis={self.tune_hysteresis} "
                f"(in [0, 1))")
        if self.tune_loss_bound <= 0.0:
            raise ValueError(
                f"tune_loss_bound must be > 0 (relative divergence "
                f"margin), got {self.tune_loss_bound}")
        if self.tune_numerics and self.tune_variants <= 0:
            raise ValueError(
                "tune_numerics requires the autotuner "
                "(tune_variants > 0) — the fp8 quant axis only runs "
                "under the loss-divergence guard")
    profile_trace_dir: str = ""              # profiler window target
    profile_start_step: int = -1
    profile_end_step: int = -1
    save_on_exit: bool = True
    tune_config_steps: int = 25              # poll master's paral config
    probe_interval: float = 30.0             # device-queue liveness probe
    # fused multi-step dispatch (trainer/train_step.py): 0 = auto-tune K
    # from the measured step time vs. the measured per-dispatch overhead,
    # clamped to a divisor of the active hook cadences; 1 = unfused;
    # K>1 = explicit.  Hooks fire at fusion boundaries only.
    fused_steps: int = 0
    # SIGTERM (the agent's stop signal) finishes the in-flight fusion,
    # saves, and exits cleanly instead of dying mid-step
    graceful_preemption: bool = True
    # stage the train state to shm (save_to_memory) every N steps — at
    # fusion boundaries when fused — so the agent's save-on-failure
    # persists the last boundary; 0 = off
    flash_stage_steps: int = 0
    policy_steps: int = 0                    # adaptive policy poll
    perf_window_every: int = 8               # perf observatory cadence
    perf_regress_windows: int = 3
    perf_overhead_budget: float = 0.01
    tune_variants: int = 0                   # online variant autotuner
    tune_hysteresis: float = 0.05
    tune_numerics: bool = False
    tune_loss_bound: float = 0.05
    # overlap the logging boundary's host work (metrics readback, master
    # reports) with the next fused dispatch via the metrics pump thread;
    # False = inline.  User callbacks force the inline path.
    async_metrics: bool = True


#: (knob, ROADMAP item) of the hooks the port does not have: a
#: non-default value raises
_UNPORTED_KNOBS = (
    ("profile_trace_dir", "13 (the step profiler)"),
    ("tune_variants", "15 (the variant autotuner)"),
    ("policy_steps", "15 (the adaptive policy)"),
)

#: the JAX Trainer's hooks that stay absent, logged once at start
_ABSENT_HOOKS = ("StepProfiler (item 13)", "PerfObservatory (item 15)",
                 "ParalConfigListener (item 15)", "DeviceProber (item 13)",
                 "adaptive policy, variant tuner and warm pool "
                 "(items 13 and 15)")


# ------------------------------------------------------------ schedules
#
# optax's schedules (optax/schedules/_schedule.py, _join.py) on the host,
# in float32 as optax computes them under jit.


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule``: polynomial of power 1, clipped."""
    init, end = np.float32(init_value), np.float32(end_value)

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float((init - end) * frac + end)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    init, a = np.float32(init_value), np.float32(alpha)
    pi = np.float32(math.pi)

    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            pi * c / np.float32(decay_steps)))
        return float(init * ((np.float32(1) - a) * cosine + a))

    return schedule


def join_schedules(schedules, boundaries) -> Callable[[int], float]:
    """``optax.join_schedules``: past each boundary the next schedule,
    counted from the boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


def make_schedule(args: TrainingArgs) -> Callable[[int], float]:
    """The JAX Trainer's `_make_schedule` (:717-731) for `args`."""
    peak = args.learning_rate
    if args.lr_schedule == "constant":
        return linear_schedule(0.0, peak, max(1, args.warmup_steps))
    decay_steps = max(1, args.max_steps - args.warmup_steps)
    if args.lr_schedule == "linear":
        decay = linear_schedule(peak, peak * args.min_lr_ratio, decay_steps)
    else:
        decay = cosine_decay_schedule(peak, decay_steps,
                                      alpha=args.min_lr_ratio)
    warmup = linear_schedule(0.0, peak, max(1, args.warmup_steps))
    return join_schedules([warmup, decay], [args.warmup_steps])


class _MetricsPump:
    """Single background consumer for the logging boundary's host work.

    The per-fusion metrics readback (``float(loss)``), the master reports
    and the user callbacks move off the hot loop onto ONE daemon thread
    draining a bounded queue, so the next fused dispatch overlaps the host
    work instead of serializing behind it.  Ledger CREDITS stay on the
    main thread at fusion boundaries: a job ships the snapshot dict taken
    at its boundary, never the live ledger.  The metrics are fresh tensors
    of the step (``loss.detach()``), which the next step's in-place
    updates never write.  At most `maxsize` boundaries ride in flight;
    joined from train()'s finally.

    `enabled=False` (async_metrics off, or callbacks present) consumes
    inline on the caller's thread — same code path, synchronous
    semantics, and a raising callback aborts training.
    """

    def __init__(self, trainer: "Trainer", enabled: bool = True,
                 maxsize: int = 2):
        import queue
        import threading

        self._trainer = trainer
        self._lock = threading.Lock()
        self._last_loss = float("nan")
        self._q: Any = None
        self._thread: Any = None
        if enabled:
            self._q = queue.Queue(maxsize=maxsize)
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="dwt-metrics-pump")
            self._thread.start()

    def submit(self, job: Dict[str, Any]) -> None:
        if self._thread is None:
            self._note_done(self._trainer._consume_boundary(job))
        else:
            self._q.put(job)

    def last_loss(self) -> float:
        with self._lock:
            return self._last_loss

    def stop(self, timeout: float = 60.0) -> None:
        """Flush queued boundaries and join (train()'s finally)."""
        if self._thread is None:
            return
        self._q.put(None)
        self._thread.join(timeout)
        self._thread = None

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            self._consume(job)

    def _consume(self, job: Dict[str, Any]) -> None:
        # async path only: a failed boundary is logged, never fatal
        try:
            loss = self._trainer._consume_boundary(job)
        except Exception:  # noqa: BLE001 — see docstring
            logger.exception("metrics pump: boundary %s failed",
                             job.get("step"))
            return
        self._note_done(loss)

    def _note_done(self, loss: float) -> None:
        with self._lock:
            self._last_loss = loss


class Trainer:
    """HF-style: Trainer(model, args, train_data[, eval_data]).train().

    `train_data` / `eval_data`: iterables yielding host batches — dicts of
    arrays shaped (global_batch, ...) — or callables `(step) -> batch`.
    `optimizer`: a factory ``params -> torch.optim.Optimizer`` (None: the
    JAX Trainer's chain, `clip_adamw` over the schedule).
    """

    def __init__(self, model, args: TrainingArgs,
                 train_data: Any, eval_data: Any = None,
                 optimizer=None, loss_fn: Optional[Callable] = None,
                 callbacks: Optional[list] = None, device=None):
        for knob, item in _UNPORTED_KNOBS:
            value = getattr(args, knob)
            if value != getattr(TrainingArgs, knob):
                raise ValueError(f"TrainingArgs.{knob}={value!r} needs a "
                                 f"hook the port does not have yet "
                                 f"(ROADMAP queue 1 item {item})")
        self.model = model
        self.args = args
        self.train_data = train_data
        self.eval_data = eval_data
        self.callbacks = callbacks or []
        self._loss_fn = loss_fn

        # elastic context: no-op when not launched by the agent
        from .elastic import init_elastic

        self.ctx = init_elastic()

        from .train_step import clip_adamw

        self.schedule = make_schedule(args)
        self.optimizer = optimizer or clip_adamw(
            self.schedule, weight_decay=args.weight_decay)

        from ..auto.accelerate import auto_accelerate

        self.res = auto_accelerate(
            model, optimizer=self.optimizer, strategy=args.strategy,
            loss_fn=loss_fn, accum_steps=args.grad_accum_steps,
            device=device, seed=args.seed)
        self.state = self.res.state

        from ..checkpoint.checkpointer import FlashCheckpointer

        self.ckpt = FlashCheckpointer(
            os.path.join(args.output_dir, "checkpoints"),
            job_name=os.getenv("DWT_JOB_NAME", "dwt"),
            wire_dtype=args.ckpt_wire_dtype)
        #: the resume of the last train(): step, tier, seconds
        self.resumed: Dict[str, Any] = {}
        logger.info("trainer hooks absent in the port: %s",
                    "; ".join(_ABSENT_HOOKS))

    # ----------------------------------------------------------------- data

    def _batch_at(self, source, step: int):
        if callable(source):
            return source(step)
        if not hasattr(self, "_iters"):
            self._iters = {}
        it = self._iters.get(id(source))
        if it is None:
            it = iter(source)
            self._iters[id(source)] = it
        try:
            return next(it)
        except StopIteration:
            it = iter(source)  # new epoch
            self._iters[id(source)] = it
            return next(it)

    def _fused_batch(self, s0: int, k: int) -> Dict:
        """K host batches from step `s0` on, stacked on a leading axis."""
        batches = [dict(self._batch_at(self.train_data, s0 + i))
                   for i in range(k)]
        return self.res.place_fused_batch(
            {key: np.stack([np.asarray(b[key]) for b in batches])
             for key in batches[0]})

    # --------------------------------------------------- fused dispatch

    def request_stop(self):
        """Graceful stop at the next fusion boundary (preemption path)."""
        self._preempted = True

    def _on_sigterm(self, signum, frame):
        logger.info("SIGTERM: finishing the in-flight fusion, then "
                    "saving and exiting (graceful preemption)")
        self._preempted = True

    def _hook_cadence(self) -> int:
        """gcd of the active step cadences — K must divide it so every
        hook lands exactly on a fusion boundary."""
        a = self.args
        cad = 0
        for c in (a.logging_steps, a.save_steps,
                  a.eval_steps if self.eval_data is not None else 0,
                  a.flash_stage_steps):
            if c:
                cad = math.gcd(cad, int(c))
        return cad

    def _initial_fused_k(self) -> Optional[int]:
        """args.fused_steps resolved: 1 (off), K (explicit), or None —
        auto-tune after measuring the first unfused steps."""
        a = self.args
        if a.fused_steps >= 1:
            return a.fused_steps
        return None  # auto

    def _dispatch_overhead_s(self) -> float:
        """What one fusion boundary saves: a host round trip to the
        device (enqueue a tiny op, read it back), measured once."""
        if not hasattr(self, "_disp_overhead"):
            import torch

            x = torch.zeros((), device=self.res.device)
            float(x + 1)  # warm
            t0 = time.perf_counter()
            for _ in range(10):
                float(x + 1)
            self._disp_overhead = (time.perf_counter() - t0) / 10
        return self._disp_overhead

    def _autotune_fused_k(self, step_time_s: float) -> int:
        from .train_step import auto_fused_steps

        k = auto_fused_steps(step_time_s, self._dispatch_overhead_s(),
                             cadence=self._hook_cadence())
        if k > 1:
            logger.info("fused_steps auto-tuned to %d "
                        "(measured step %.1fms)", k, step_time_s * 1e3)
        return k

    # ------------------------------------------------- boundary consumer

    def _consume_boundary(self, job: Dict[str, Any]) -> float:
        """One logging boundary's host work — on the metrics pump thread
        (inline when async_metrics=False or with callbacks).  The ONE
        readback per fusion lives here."""
        step = job["step"]
        loss = float(job["metrics"]["loss"])
        tps = job["steps"] * job["tokens_per_step"] / \
            max(job["dt_s"], 1e-9)
        logger.info("step %d loss=%.4f tokens/s=%.0f", step, loss, tps)
        self.ctx.report_step(step)
        if self.ctx.mc is not None:
            try:  # buffered verb; telemetry never kills the run
                self.ctx.mc.report_goodput_ledger(job["ledger"])
            except Exception:  # noqa: BLE001
                pass
        for cb in self.callbacks:
            cb(step, {"loss": loss, "tokens_per_sec": tps})
        return loss

    # ---------------------------------------------------------------- train

    def _resume(self) -> int:
        """Auto-resume from the newest verified checkpoint (or, with the
        agent's one-shot ``DWT_ROLLBACK_BEFORE_STEP``, the newest committed
        one before it); returns the step to start from."""
        from ..common.constants import NodeEnv

        try:
            rb = int(os.getenv(NodeEnv.ROLLBACK_BEFORE_STEP, "-1"))
        except ValueError:  # empty/garbage env: resume normally,
            rb = -1        # don't wedge the restart loop
        t0 = time.monotonic()
        restored = self.ckpt.load_checkpoint(
            self.state, before_step=rb if rb >= 0 else None)
        if restored is None:
            return 0
        start_step = int(self.state.step)
        if rb >= 0:
            self._rework_until = rb
        rep = self.ckpt.last_restore_report
        self.resumed = {"step": start_step, "tier": rep.get("tier"),
                        "seconds": time.monotonic() - t0}
        logger.info("resumed from step %d (tier=%s%s)", start_step,
                    rep.get("tier", "?"),
                    ", degraded" if rep.get("fallbacks") else "")
        if rep.get("fallbacks") and self.ctx.mc is not None:
            # checkpoint-health event: the master's event stream is where
            # operators see that a tier was corrupt and which generation
            # actually served the resume
            self.ctx.mc.report_node_event(
                "ckpt-health",
                f"degraded resume: tier={rep.get('tier')} "
                f"step={rep.get('step')} "
                f"fallbacks={rep.get('fallbacks')}",
                level="warning")
        return start_step

    def train(self) -> Dict[str, float]:
        import signal as _signal

        from ..telemetry.ledger import get_ledger
        from ..telemetry.recorder import get_recorder

        a = self.args
        led = get_ledger()
        led.start()
        # rollback rework ceiling: steps below this were trained before a
        # loss-spike rollback and are re-executed ("rework", not goodput)
        self._rework_until = -1
        start_step = self._resume() if a.resume else 0

        last_loss = float("nan")
        metrics = None
        t_log = time.monotonic()
        steps_since_log = 0
        self._preempted = False
        prev_sigterm = None
        if a.graceful_preemption:
            try:
                prev_sigterm = _signal.signal(_signal.SIGTERM,
                                              self._on_sigterm)
            except ValueError:  # not the main thread: leave the default
                prev_sigterm = None
        fused_k = self._initial_fused_k()
        step_time_s = 0.0
        step = start_step
        # goodput ledger: the trainer owns productive / dispatch_overhead /
        # data_stall / compile / rework; the checkpoint engine credits
        # ckpt_stage/persist + restore tiers; master_client credits
        # degraded.  All accounting happens HERE at fusion boundaries from
        # host-side timers, never via an extra device readback.  The first
        # dispatch at each fusion width warms the device (kernel loads,
        # cuBLAS handles, allocator) and is credited as compile.
        compiled = set()
        self._pump = _MetricsPump(
            self, enabled=a.async_metrics and not self.callbacks)
        try:
            while step < a.max_steps and not self._preempted:
                t_iter0 = time.monotonic()
                if fused_k is None and step - start_step >= 2:
                    # two unfused steps measured (the first warms up):
                    # decide K, then fuse the rest of the run
                    fused_k = self._autotune_fused_k(step_time_s)
                self._fused_k_active = fused_k or 0
                k_eff = min(fused_k or 1, a.max_steps - step)
                s0 = step
                with led.window("data_stall"):
                    if k_eff > 1:
                        batch = self._fused_batch(s0, k_eff)
                    else:
                        batch = self.res.place_batch(
                            dict(self._batch_at(self.train_data, s0)))
                data_s = time.monotonic() - t_iter0
                t_blk0 = time.monotonic()
                t0 = time.perf_counter()
                self.state, metrics = self.res.fused_train_step(k_eff)(
                    self.state, batch)
                if fused_k is None:
                    # auto-tune measurement: sync so the timing is the
                    # real step, not the async dispatch
                    float(metrics["loss"])
                    step_time_s = time.perf_counter() - t0
                blk_s = time.monotonic() - t_blk0
                if k_eff not in compiled:
                    compiled.add(k_eff)
                    led.account("compile", blk_s)
                    credited_blk = blk_s
                else:
                    credited_blk = min(blk_s, self._dispatch_overhead_s())
                    led.account("dispatch_overhead", credited_blk)
                step = s0 + k_eff
                steps_since_log += k_eff
                hooks_excl_s = 0.0  # save/eval time: credited elsewhere
                # ---- boundary hooks: K divides every active cadence, so
                # these fire exactly as in the unfused loop ----
                if a.logging_steps and step % a.logging_steps == 0:
                    dt = time.monotonic() - t_log
                    t_log = time.monotonic()
                    tokens_per_step = a.seq_len * getattr(
                        self.train_data, "batch_size", a.global_batch_size)
                    self._pump.submit({
                        "step": step, "metrics": metrics, "dt_s": dt,
                        "steps": steps_since_log,
                        "tokens_per_step": tokens_per_step,
                        "ledger": led.snapshot(),
                    })
                    steps_since_log = 0
                saved = False
                if a.save_steps and step % a.save_steps == 0:
                    t_h = time.monotonic()
                    self._save(step)
                    hooks_excl_s += time.monotonic() - t_h
                    saved = True
                if a.flash_stage_steps and not saved and \
                        step % a.flash_stage_steps == 0:
                    # shm staging (save_to_memory): the agent's
                    # save-on-failure persists this boundary if the next
                    # fusion never completes
                    from ..checkpoint.checkpointer import StorageType

                    t_h = time.monotonic()
                    self.ckpt.save_checkpoint(
                        step, self.state.tree(),
                        storage_type=StorageType.MEMORY)
                    hooks_excl_s += time.monotonic() - t_h
                if a.eval_steps and self.eval_data is not None and \
                        step % a.eval_steps == 0:
                    t_h = time.monotonic()
                    eval_loss = self.evaluate()
                    hooks_excl_s += time.monotonic() - t_h
                    logger.info("step %d eval_loss=%.4f", step, eval_loss)
                # the rest of the iteration is the fused window itself
                window_s = max(0.0, (time.monotonic() - t_iter0) - data_s
                               - credited_blk - hooks_excl_s)
                led.account(
                    "rework" if s0 < self._rework_until else "productive",
                    window_s)
            if self._preempted and step < a.max_steps:
                logger.info("preempted at fusion boundary %d — saving and "
                            "exiting", step)
        except BaseException:
            # fault flight dump: ring buffer + ledger snapshot land next
            # to the checkpoints so post-mortem tooling finds them
            get_recorder().flush(self.ckpt.checkpoint_dir, "fault")
            raise
        finally:
            # flush queued boundaries + join BEFORE the final cumulative
            # ledger ship, so latest-wins ordering holds at the master
            self._pump.stop()
            pump_loss = self._pump.last_loss()
            if pump_loss == pump_loss:
                last_loss = pump_loss
            if self._preempted:
                get_recorder().flush(self.ckpt.checkpoint_dir, "sigterm")
            if self.ctx.mc is not None:
                try:  # final cumulative snapshot (latest-wins at master)
                    self.ctx.mc.report_goodput_ledger(led.snapshot())
                except Exception:  # noqa: BLE001
                    pass
            if prev_sigterm is not None:
                try:
                    _signal.signal(_signal.SIGTERM, prev_sigterm)
                except ValueError:
                    pass
            if a.save_on_exit:
                final = int(self.state.step)
                if getattr(self, "_last_saved_step", -1) != final:
                    # don't re-stage a step the cadence save just staged:
                    # two concurrent saves of one step race on the same
                    # shard files
                    self._save(final)
                self.ckpt.wait_latest_checkpoint(600)
        if last_loss != last_loss and metrics is not None:
            last_loss = float(metrics["loss"])  # only short runs never log
        return {"final_step": a.max_steps, "final_loss": last_loss,
                "stopped_at": step}

    def _save(self, step: int):
        from ..checkpoint.checkpointer import StorageType

        # world shape + fused-K travel in the staging extras and land in
        # the committed generation's manifest (checkpoint/integrity.py);
        # one device, so no mesh
        extra = {"mesh_shape": {},
                 "fused_steps": int(getattr(self, "_fused_k_active", 0)
                                    or self.args.fused_steps)}
        blocked = self.ckpt.save_checkpoint(
            step, self.state.tree(), storage_type=StorageType.DISK,
            extra_meta=extra)
        self._last_saved_step = step
        logger.info("checkpoint step %d staged (blocked %.3fs)", step,
                    blocked)

    # ----------------------------------------------------------------- eval

    def evaluate(self) -> float:
        """Mean loss over up to max_eval_batches of eval_data."""
        import torch

        if self.eval_data is None:
            raise ValueError("no eval_data")
        losses = []
        with torch.no_grad():
            for i in range(self.args.max_eval_batches):
                try:
                    batch = self.res.place_batch(
                        dict(self._batch_at(self.eval_data, i)))
                except StopIteration:  # pragma: no cover
                    break
                losses.append(float(self.res.loss_fn(self.state.params,
                                                     batch)))
        return float(np.mean(losses)) if losses else float("nan")
