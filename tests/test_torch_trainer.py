"""Port parity: the Trainer against the JAX package's Trainer.

GPT nano in float32 on the CPU, from the same parameters (the JAX
Trainer's initial ones, through `convert`) and on the same batches
(numpy, seeded by step), with warmup, cosine decay to 0.1, clip at 1.0
and weight decay 0.1 — the JAX Trainer's optimizer chain against the
port's `clip_adamw`:

- the lr at every count for "cosine", "linear" and "constant" equals the
  optax schedule's within 1e-6 relative (both float32; optax's cos runs
  in XLA, the port's in numpy, so the last bit may differ);
- the losses of 8 steps agree within RTOL = 1e-4 relative, the bound
  tests/test_torch_train_step.py states and explains (Adam's first
  updates are sign-like, so an entry whose gradient sits within rounding
  of zero moves by a full lr on one side and not the other); for the
  same reason the final parameters agree within the sum over the steps of
  2 lr(t) per entry, and within 1e-4 of their norm over the whole tree;
- the state tree's names, in order, equal JAX's ``flatten_state_dict``
  of the JAX Trainer's state (``opt_state/1/0/...``,
  ``opt_state/1/2/count``);
- a JAX Trainer checkpoint resumes in the port Trainer and a port one in
  the JAX Trainer, every leaf bitwise;
- fused K = 2 is bitwise K = 1; SIGTERM saves at the boundary; the knobs
  whose hooks are not ported raise.

The JAX side runs once, in a module-scoped fixture.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_wuqiong_tpu.checkpoint.ckpt_saver import (
    AsyncCheckpointSaver as JaxSaver,
)
from dlrover_wuqiong_tpu.checkpoint.shm_handler import (
    flatten_state_dict as jax_flatten,
)
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.trainer.trainer import Trainer as JaxTrainer
from dlrover_wuqiong_tpu.trainer.trainer import TrainingArgs as JaxArgs
from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
    AsyncCheckpointSaver,
)
from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
    flatten_state_dict,
)
from dlrover_wuqiong_tpu_torch.convert import load_params
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger
from dlrover_wuqiong_tpu_torch.trainer.trainer import (
    Trainer,
    TrainingArgs,
    make_schedule,
)
from torch_threads import one_torch_thread  # noqa: F401

VOCAB, SEQ, BATCH, STEPS = 512, 32, 8, 8
RTOL = 1e-4
KNOBS = dict(max_steps=STEPS, global_batch_size=BATCH, seq_len=SEQ,
             learning_rate=1e-3, weight_decay=0.1, warmup_steps=3,
             lr_schedule="cosine", min_lr_ratio=0.1, logging_steps=1,
             save_steps=4, fused_steps=1, save_on_exit=False)


def _data(step):
    x = np.random.default_rng([7, step]).integers(0, VOCAB, (BATCH, SEQ + 1))
    return {"input_ids": x[:, :-1], "labels": x[:, 1:]}


def _jax_model():
    return jgpt.GPT(dataclasses.replace(
        jgpt.GPTConfig.nano(), dtype=jnp.float32, use_flash_attention=False,
        remat=False))


def _port_model():
    return tgpt.GPT(dataclasses.replace(tgpt.GPTConfig.nano(),
                                        dtype=torch.float32, remat=False))


class _Job:
    """DWT_JOB_NAME for the Trainers built inside (each its own saver)."""

    def __init__(self, name):
        self.name, self.prev = name, None

    def __enter__(self):
        self.prev = os.environ.get("DWT_JOB_NAME")
        os.environ["DWT_JOB_NAME"] = f"{self.name}-{os.getpid()}"

    def __exit__(self, *exc):
        if self.prev is None:
            os.environ.pop("DWT_JOB_NAME", None)
        else:
            os.environ["DWT_JOB_NAME"] = self.prev


def _jax_flat(state):
    return {k: np.asarray(v) for k, v in jax_flatten(state).items()}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer's 8 steps: initial params, per-step losses, the
    final state (flat), and its checkpoint directory."""
    out = str(tmp_path_factory.mktemp("jax-trainer"))
    JaxSaver.reset()
    losses = []
    with _Job("tt-jax"):
        tr = JaxTrainer(_jax_model(), JaxArgs(
            output_dir=out, strategy=[("fsdp", {})], perf_window_every=0,
            probe_interval=0, **KNOBS), _data,
            callbacks=[lambda s, m: losses.append((s, m["loss"]))])
        init = jax.tree_util.tree_map(np.asarray, tr.state.params)
        tr.train()
        assert tr.ckpt.wait_latest_checkpoint(60)
        final = _jax_flat(tr.state)
        tr.ckpt.close()
    JaxSaver.reset()
    return {"init": init, "losses": losses, "final": final, "dir": out,
            "schedule": tr._make_schedule(optax)}


@pytest.fixture(autouse=True)
def _fresh():
    AsyncCheckpointSaver.reset()
    yield
    AsyncCheckpointSaver.reset()
    reset_ledger()  # a Trainer starts the ledger: later dumps must not


def _port_trainer(out, job, params=None, callbacks=None, **kw):
    with _Job(job):
        tr = Trainer(_port_model(), TrainingArgs(
            output_dir=str(out), **dict(KNOBS, **kw)), _data,
            callbacks=callbacks, device="cpu")
    if params is not None:
        load_params(tr.model, params, device="cpu")
    return tr


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """The port Trainer's 8 steps from the JAX Trainer's initial params."""
    out = tmp_path_factory.mktemp("port-trainer")
    AsyncCheckpointSaver.reset()
    losses = []
    tr = _port_trainer(out, "tt-port", jax_run["init"],
                       callbacks=[lambda s, m: losses.append((s, m["loss"]))])
    tr.train()
    assert tr.ckpt.wait_latest_checkpoint(60)
    final = {k: v.detach().numpy().copy()
             for k, v in flatten_state_dict(tr.state.tree()).items()}
    tr.ckpt.close()
    AsyncCheckpointSaver.reset()
    reset_ledger()
    return {"losses": losses, "final": final, "dir": str(out), "tr": tr}


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_equals_optax(kind):
    knobs = dict(max_steps=20, warmup_steps=4, learning_rate=3e-4,
                 min_lr_ratio=0.1, lr_schedule=kind)
    jtr = JaxTrainer.__new__(JaxTrainer)
    jtr.args = JaxArgs(**knobs)
    want = jtr._make_schedule(optax)
    got = make_schedule(TrainingArgs(**knobs))
    for count in range(24):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=0)
    assert got(0) == 0.0  # warmup from 0: the first update's lr is 0


def test_losses_and_params_match_jax(jax_run, port_run):
    steps_j, lj = zip(*jax_run["losses"])
    steps_t, lt = zip(*port_run["losses"])
    assert steps_t == steps_j == tuple(range(1, STEPS + 1))
    np.testing.assert_allclose(lt, lj, rtol=RTOL)
    sched = jax_run["schedule"]
    bound = sum(2 * float(sched(c)) for c in range(STEPS))
    jp = {k: v for k, v in jax_run["final"].items()
          if k.startswith("params/")}
    tp = {k: v for k, v in port_run["final"].items()
          if k.startswith("params/")}
    assert set(jp) == set(tp)
    diff = sum(float(np.sum((tp[k] - jp[k]) ** 2)) for k in jp) ** 0.5
    norm = sum(float(np.sum(jp[k] ** 2)) for k in jp) ** 0.5
    assert diff <= 1e-4 * norm, (diff, norm)
    worst = max(float(np.max(np.abs(tp[k] - jp[k]))) for k in jp)
    assert worst <= bound, (worst, bound)


def test_state_tree_names_equal_jax(jax_run, port_run):
    assert list(port_run["final"]) == list(jax_run["final"])
    assert "opt_state/1/2/count" in port_run["final"]
    assert float(port_run["final"]["opt_state/1/2/count"]) == STEPS
    assert float(port_run["final"]["opt_state/1/0/count"]) == STEPS


def test_jax_checkpoint_resumes_in_port_trainer(jax_run, tmp_path):
    tr = _port_trainer(jax_run["dir"], "tt-from-jax")
    out = tr.train()  # resumes at STEPS: nothing left to train
    assert out["stopped_at"] == STEPS
    assert tr.resumed["step"] == STEPS and tr.resumed["tier"] == "storage"
    got = {k: v.detach().numpy()
           for k, v in flatten_state_dict(tr.state.tree()).items()}
    assert list(got) == list(jax_run["final"])
    for k, v in jax_run["final"].items():
        np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), k)
    # every torch per-parameter step took the restored count
    assert all(float(s["step"]) == STEPS
               for s in tr.state.opt_state.state.values())
    tr.ckpt.close()


def test_port_checkpoint_resumes_in_jax_trainer(port_run):
    JaxSaver.reset()
    try:
        with _Job("tt-to-jax"):
            jtr = JaxTrainer(_jax_model(), JaxArgs(
                output_dir=port_run["dir"], strategy=[("fsdp", {})],
                perf_window_every=0, probe_interval=0, **KNOBS), _data)
            out = jtr.train()  # resumes at STEPS
        assert out["stopped_at"] == STEPS
        got = _jax_flat(jtr.state)
        assert list(got) == list(port_run["final"])
        for k, v in port_run["final"].items():
            np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), k)
        jtr.ckpt.close()
    finally:
        JaxSaver.reset()


def test_fused_two_is_bitwise_single(tmp_path):
    runs = {}
    for k in (1, 2):
        tr = _port_trainer(tmp_path / f"k{k}", f"tt-k{k}", fused_steps=k,
                           max_steps=6, logging_steps=2, save_steps=0)
        runs[k] = (tr.train()["final_loss"],
                   [p.detach().clone() for p in tr.model.parameters()])
        assert tr._fused_k_active == k
        tr.ckpt.close()
        AsyncCheckpointSaver.reset()
    assert runs[1][0] == runs[2][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[1][1], runs[2][1]))


def test_sigterm_saves_at_the_boundary(tmp_path):
    def on_step(step, m):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    tr = _port_trainer(tmp_path, "tt-sigterm", callbacks=[on_step],
                       save_on_exit=True, save_steps=0)
    out = tr.train()
    assert out["stopped_at"] == 3
    tracker = tmp_path / "checkpoints" / "latest_checkpointed_iteration.txt"
    assert tracker.read_text().strip() == "3"
    assert signal.getsignal(signal.SIGTERM) == prev
    tr.ckpt.close()


@pytest.mark.parametrize("knob,value,item", [
    ("profile_trace_dir", "/nonexistent", "13"),
    ("tune_variants", 1, "15"),
    ("policy_steps", 5, "15"),
])
def test_knobs_of_unported_hooks_raise(knob, value, item, tmp_path):
    with pytest.raises(ValueError, match=f"ROADMAP queue 1 item {item}"):
        Trainer(_port_model(), TrainingArgs(
            output_dir=str(tmp_path), **{knob: value}), _data,
            device="cpu")


def test_training_args_fields_equal_jax():
    port = [(f.name, f.default) for f in dataclasses.fields(TrainingArgs)]
    jax_ = [(f.name, f.default) for f in dataclasses.fields(JaxArgs)]
    assert port == jax_


@pytest.mark.parametrize("name", ["agd", "adamw8bit", "stable_bf16",
                                  "stable_bf16_master"])
def test_trainer_resumes_the_new_optimizers_bitwise(tmp_path, name):
    """The Trainer with AGD, adamw8bit, or the stable_bf16 strategy over
    its own clip_adamw: 8 steps with a disk save at 4 and 8; a second
    Trainer on the same directory resumes at 8 with every leaf of the
    state (names included) bitwise the first's."""
    from dlrover_wuqiong_tpu_torch.optimizers import adamw8bit, agd

    kw = {"agd": dict(optimizer=agd(1e-3, weight_decay=0.1)),
          "adamw8bit": dict(optimizer=adamw8bit(1e-3, weight_decay=0.1)),
          "stable_bf16": dict(strategy=[("stable_bf16", {})]),
          "stable_bf16_master": dict(strategy=[("stable_bf16",
                                                {"master": True})])}[name]
    opt = kw.pop("optimizer", None)

    def trainer(job):
        with _Job(job):
            return Trainer(_port_model(), TrainingArgs(
                output_dir=str(tmp_path), **dict(KNOBS, **kw)), _data,
                optimizer=opt, device="cpu")

    tr = trainer(f"tt-{name}-a")
    out = tr.train()
    assert out["stopped_at"] == STEPS and np.isfinite(out["final_loss"])
    assert tr.ckpt.wait_latest_checkpoint(60)
    want = {k: v.detach().clone()
            for k, v in flatten_state_dict(tr.state.tree()).items()}
    tr.ckpt.close()
    AsyncCheckpointSaver.reset()
    tr2 = trainer(f"tt-{name}-b")
    assert tr2.train()["stopped_at"] == STEPS
    assert tr2.resumed["step"] == STEPS
    got = flatten_state_dict(tr2.state.tree())
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    if name.startswith("stable_bf16"):
        assert {p.dtype for p in tr2.model.parameters()} == {torch.bfloat16}
        # the chain of clip_adamw inside StableBF16State
        assert "opt_state/inner/1/2/count" in got
    tr2.ckpt.close()
