"""Port parity: the flash checkpoint of torch training state.

The port's `checkpoint/` against the JAX package's on the same state:

- the shm segment both write for one flat state is byte-equal (payload,
  every `TensorMeta` field, every digest), and so are the storage files
  (shard file, meta, manifest, tracker), apart from the fields named in
  `MAY_DIFFER`;
- a GPT nano `TrainState` written by either package resumes in the other
  (JAX ``optax.adamw(3e-4)`` against the port's ``adamw(3e-4)``): the
  restored parameters are bitwise the writer's, and the next step agrees
  within tests/test_torch_train_step.py's RTOL = 1e-4 (Adam's updates are
  the same arithmetic rounded in another order);
- a checkpoint JAX wrote from the 8-device CPU mesh assembles from its
  ``#shardN`` leaves;
- a port run saved, restored into a model from another seed and resumed
  is bitwise the uninterrupted run, from the shm and the storage tier;
- tests/test_checkpoint.py's trust-boundary matrix holds against the port
  with the same expectations;
- the SIGKILL drill (checkpoint/drill.py) restores from a dead trainer's
  segment, on the CPU at nano size.

Every test uses its own job name and unlinks its segments; the port's
saver singleton and goodput ledger are reset around each test.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dlrover_wuqiong_tpu.auto.accelerate import (
    auto_accelerate as jax_auto_accelerate,
)
from dlrover_wuqiong_tpu.checkpoint import checkpointer as jck
from dlrover_wuqiong_tpu.checkpoint import ckpt_saver as jsaver
from dlrover_wuqiong_tpu.checkpoint import shm_handler as jshm
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.trainer import train_step as jtrain
from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
    FlashCheckpointer,
    StorageType,
)
from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
    AsyncCheckpointSaver,
    read_last_step,
)
from dlrover_wuqiong_tpu_torch.checkpoint.engine import (
    CheckpointEngine,
    restore_tree,
)
from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    flatten_state_dict,
)
from dlrover_wuqiong_tpu_torch.convert import export_params, load_params
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger
from dlrover_wuqiong_tpu_torch.trainer.train_step import (
    TrainState,
    adamw,
    make_lm_loss,
    make_train_step,
)
from torch_threads import one_torch_thread  # noqa: F401

VOCAB, SEQ, BATCH = 512, 32, 4
RTOL = 1e-4  # tests/test_torch_train_step.py's, for adamw steps
HEADER = 1 << 20
#: segment/meta fields that name the writing process or its directory
MAY_DIFFER = ("_pid", "_ckpt_dir")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _job(tag: str) -> str:
    return f"tt{os.getpid()}-{tag}"


@pytest.fixture(autouse=True)
def _fresh_saver():
    AsyncCheckpointSaver.reset()
    jsaver.AsyncCheckpointSaver.reset()
    reset_ledger()
    yield
    AsyncCheckpointSaver.reset()
    jsaver.AsyncCheckpointSaver.reset()
    reset_ledger()


def _host_batch(step):
    rng = np.random.default_rng(step)
    x = rng.integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    return {"input_ids": x[:, :-1], "labels": x[:, 1:]}


def _torch_batch(step):
    return {k: torch.from_numpy(v.astype(np.int64))
            for k, v in _host_batch(step).items()}


def _cfg():
    return dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                               remat=False)


def _port_state(params):
    return TrainState.create(load_params(tgpt.GPT(_cfg()), params, "cpu"),
                             adamw(3e-4))


_STEP = make_train_step(make_lm_loss())


def _port_steps(state, steps):
    losses = []
    for i in steps:
        state, m = _STEP(state, _torch_batch(i))
        losses.append(m["loss"].item())
    return losses


def _leaf_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_params_close(port_model, jax_params):
    """Every parameter leaf within RTOL of JAX's (relative norm), but the
    key third of each ``c_attn`` bias: it gets no gradient in exact
    arithmetic (a constant added to every score of a row leaves the
    softmax as it is), so its float gradient is rounding noise, which
    Adam turns into up to a full lr step either way.  It is held to 2 lr
    per entry, the most two Adam steps from one state can differ by."""
    want = jshm.flatten_state_dict(jax_params)
    got = flatten_state_dict(export_params(port_model))
    assert set(got) == set(want)
    C = _cfg().n_embd
    for k, w in want.items():
        g = got[k].numpy()
        if k.endswith("attn/c_attn/bias"):
            keys = slice(C, 2 * C)
            assert np.abs(g[keys] - w[keys]).max() <= 2 * 3e-4, k
            g, w = np.delete(g, range(C, 2 * C)), np.delete(w, range(C,
                                                                     2 * C))
        assert _leaf_rel(g, w) <= RTOL, (k, _leaf_rel(g, w))


# ------------------------------------------------------------ JAX side


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX GPT nano with optax.adamw(3e-4): initial params, 2 steps, a
    flash checkpoint of that state on disk, then step 3's loss and
    params.  Shared by the cross-package resume tests."""
    jsaver.AsyncCheckpointSaver.reset()
    cfg = dataclasses.replace(jgpt.GPTConfig.nano(), dtype=jnp.float32,
                              remat=False)
    res = jax_auto_accelerate(jgpt.GPT(cfg), optimizer=optax.adamw(3e-4),
                              devices=jax.devices()[:1])
    p0 = jax.tree_util.tree_map(np.asarray, res.state.params)
    state = res.state
    for i in range(2):
        state, _ = res.train_step(state, res.place_batch(_host_batch(i)))
    ckpt_dir = str(tmp_path_factory.mktemp("jax-ckpt"))
    ck = jck.FlashCheckpointer(ckpt_dir, job_name=_job("jaxrun"),
                               standalone=True)
    ck.save_checkpoint(2, state, storage_type=jck.StorageType.DISK)
    assert ck.wait_latest_checkpoint(60)
    ck.close()
    jsaver.AsyncCheckpointSaver.reset()
    flat2 = {k: np.asarray(v)
             for k, v in jshm.flatten_state_dict(state).items()}
    state, m = res.train_step(state, res.place_batch(_host_batch(2)))
    return {"res": res, "p0": p0, "flat2": flat2, "ckpt_dir": ckpt_dir,
            "loss3": float(m["loss"]),
            "p3": jax.tree_util.tree_map(np.asarray, state.params)}


def _mesh():
    return Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))


# ------------------------------------------------- segment and files


def _flat_state(form: str):
    """float32, bfloat16, int32 and int64 leaves, a 0-d leaf, and a
    nested list, dict and tuple; as numpy (bfloat16 through ml_dtypes,
    for the JAX side) or as torch CPU tensors."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    bf16 = rng.normal(size=(4, 3)).astype(ml_dtypes.bfloat16)
    i32 = np.arange(7, dtype=np.int32)
    i64 = np.array([[1, -2], [3, 1 << 40]], np.int64)
    s0 = np.float32(1.5)
    inner = (np.int32(9), rng.normal(size=(2,)).astype(np.float32))
    state = {"w": f32, "h": bf16, "i": i32, "l": i64, "s": s0,
             "nest": [np.ones(2, np.float32), {"t": inner}]}
    if form == "numpy":
        return state

    def tt(x):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())

    return jax.tree_util.tree_map(tt, state)


def _extra_without(extra):
    return {k: v for k, v in extra.items() if k not in MAY_DIFFER}


@pytest.mark.parametrize("form", ["numpy", "torch"])
def test_segment_bytes_equal_jax(form):
    jh = jshm.SharedMemoryHandler(0, _job(f"segj{form}"))
    th = SharedMemoryHandler(0, _job(f"segt{form}"))
    try:
        jh.save_state_dict(_flat_state("numpy"), step=7,
                           extra_meta={"k": 1, "_ckpt_dir": "/a"})
        th.save_state_dict(_flat_state(form), step=7,
                           extra_meta={"k": 1, "_ckpt_dir": "/b"})
        jhdr, thdr = jh.load_header(), th.load_header()
        assert thdr["metas"] == jhdr["metas"]  # names, dtypes, digests
        assert [(m["name"], m["dtype"]) for m in thdr["metas"]] == [
            ("h", "bfloat16"), ("i", "int32"), ("l", "int64"),
            ("nest/0", "float32"), ("nest/1/t/0", "int32"),
            ("nest/1/t/1", "float32"), ("s", "float32"), ("w", "float32")]
        assert (thdr["step"], thdr["algo"]) == (jhdr["step"], jhdr["algo"])
        assert _extra_without(thdr["extra"]) == _extra_without(
            jhdr["extra"]) == {"k": 1}
        end = max(m["offset"] + m["nbytes"] for m in thdr["metas"])
        assert bytes(th._buf.buf[HEADER:end]) == bytes(
            jh._buf.buf[HEADER:end])
        # each package reads and verifies the other's segment
        assert SharedMemoryHandler(0, _job(f"segj{form}")).verify() == (
            True, "")
        assert jshm.SharedMemoryHandler(0, _job(f"segt{form}")).verify() == (
            True, "")
    finally:
        jh.unlink()
        th.unlink()


def test_storage_files_equal_jax(tmp_path):
    dirs = {"jax": str(tmp_path / "j"), "port": str(tmp_path / "t")}
    savers = {
        "jax": jsaver.AsyncCheckpointSaver(job_name=_job("filj")),
        "port": AsyncCheckpointSaver(job_name=_job("filt"))}
    try:
        jshm.SharedMemoryHandler(0, _job("filj")).save_state_dict(
            _flat_state("numpy"), step=3)
        SharedMemoryHandler(0, _job("filt")).save_state_dict(
            _flat_state("torch"), step=3)
        for k, saver in savers.items():
            saver.save_step_checkpoint(3, dirs[k], commit_timeout=30)
        sd = {k: os.path.join(d, "checkpoint-3") for k, d in dirs.items()}

        def read(k, *parts, mode="rb"):
            with open(os.path.join(sd[k], *parts), mode) as f:
                return f.read()

        assert read("port", "shards_rank0.bin") == read("jax",
                                                        "shards_rank0.bin")
        metas = {k: json.loads(read(k, "meta_rank0.json", mode="r"))
                 for k in sd}
        for m in metas.values():
            m["extra"] = _extra_without(m["extra"])
        assert metas["port"] == metas["jax"]
        mans = {k: json.loads(read(k, "manifest.json", mode="r"))
                for k in sd}
        for m in mans.values():
            del m["created_unix"]  # the commit's wall time
            m["extra"] = _extra_without(m["extra"])
            # seals the meta bytes, which hold the MAY_DIFFER fields
            for r in m["ranks"].values():
                del r["meta_digest"]
        assert mans["port"] == mans["jax"]
        for k in sd:
            assert read(k, ".commit") == b"3"
            assert read(k, ".done", "rank0.done") == b"3"
        assert read_last_step(dirs["port"]) == read_last_step(
            dirs["jax"]) == 3
    finally:
        for saver in savers.values():
            saver.stop()


# ----------------------------------------------- cross-package resume


def test_train_state_tree_has_jax_names(jax_run):
    res = jax_run["res"]
    want = list(jshm.flatten_state_dict(res.state))
    state = _port_state(jax_run["p0"])
    got = list(flatten_state_dict(state.tree()))
    assert got == want and len(got) == 86
    # GPT-2 124M on the meta device: step, 148 params, count, 148 mu and
    # 148 nu; 124,475,904 float32 parameters, 12 bytes each with the moments
    model = tgpt.GPT(tgpt.GPTConfig.gpt2())
    big = TrainState(torch.zeros((), dtype=torch.int64), model,
                     adamw(3e-4)(list(model.parameters())))
    leaves = flatten_state_dict(big.tree())
    assert len(leaves) == 1 + 3 * 148 + 1
    assert sum(t.numel() * t.element_size() for t in leaves.values()) == (
        124_475_904 * 12 + 8 + 4)


# ------------------------------------------------ the optimizers' state

def _jax_optimizers():
    import dlrover_wuqiong_tpu.optimizers.bf16_stable  # noqa: F401
    import dlrover_wuqiong_tpu.optimizers.low_bit  # noqa: F401
    import dlrover_wuqiong_tpu.optimizers.mup  # noqa: F401
    from dlrover_wuqiong_tpu.optimizers.agd import agd as jagd

    jbf = sys.modules["dlrover_wuqiong_tpu.optimizers.bf16_stable"]
    jlow = sys.modules["dlrover_wuqiong_tpu.optimizers.low_bit"]
    jmup = sys.modules["dlrover_wuqiong_tpu.optimizers.mup"]
    base = jax.eval_shape(jgpt.GPT(dataclasses.replace(
        jgpt.GPTConfig.nano(), dtype=jnp.float32, remat=False,
        n_embd=64)).init_params, jax.random.PRNGKey(0))
    return {
        "agd": lambda p: jagd(1e-3, weight_decay=0.1),
        "agd_amsgrad": lambda p: jagd(1e-3, amsgrad=True, clip=1.0),
        "adamw8bit": lambda p: jlow.adamw8bit(1e-3, weight_decay=0.1),
        "stable_bf16": lambda p: jbf.stable_bf16(optax.adamw(3e-4)),
        "stable_bf16_master": lambda p: jbf.stable_bf16(
            optax.adamw(3e-4), master=True),
        "stable_bf16_adamw8bit": lambda p: jbf.stable_bf16(
            jlow.adamw8bit(1e-3)),
        "mup": lambda p: jmup.mup_adam(1e-3, jmup.width_mults(base, p),
                                       weight_decay=0.1),
    }


def _port_optimizer(name, model):
    from dlrover_wuqiong_tpu_torch.optimizers import (
        adamw8bit,
        agd,
        mup_adam,
        stable_bf16,
        width_mults,
    )

    base = tgpt.GPT(dataclasses.replace(_cfg(), n_embd=64))
    return {
        "agd": lambda: agd(1e-3, weight_decay=0.1),
        "agd_amsgrad": lambda: agd(1e-3, amsgrad=True, clip=1.0),
        "adamw8bit": lambda: adamw8bit(1e-3, weight_decay=0.1),
        "stable_bf16": lambda: stable_bf16(adamw(3e-4)),
        "stable_bf16_master": lambda: stable_bf16(adamw(3e-4),
                                                  master=True),
        "stable_bf16_adamw8bit": lambda: stable_bf16(adamw8bit(1e-3)),
        "mup": lambda: mup_adam(1e-3, width_mults(base, model),
                                weight_decay=0.1),
    }[name]()


OPTIMIZERS = ("agd", "agd_amsgrad", "adamw8bit", "stable_bf16",
              "stable_bf16_master", "stable_bf16_adamw8bit", "mup")


def _opt_port_state(name, params):
    """The port's TrainState of GPT nano at `params` with optimizer
    `name`; the stable_bf16 ones on bf16 parameters, as the strategy
    makes them."""
    model = load_params(tgpt.GPT(_cfg()), params, "cpu")
    if name.startswith("stable_bf16"):
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)
    return TrainState.create(model, _port_optimizer(name, model))


@pytest.fixture(scope="module")
def jax_opt_runs(jax_run, tmp_path_factory):
    """Per optimizer, lazily: the JAX TrainState's flat names, 2 jitted
    steps from jax_run's p0 saved to disk through the JAX checkpointer,
    the flat state at step 2, step 3's loss."""
    cache = {}
    opts = _jax_optimizers()

    def get(name):
        if name in cache:
            return cache[name]
        jsaver.AsyncCheckpointSaver.reset()
        model = jgpt.GPT(dataclasses.replace(
            jgpt.GPTConfig.nano(), dtype=jnp.float32, remat=False))
        params = jax.tree_util.tree_map(jnp.asarray, jax_run["p0"])
        if name.startswith("stable_bf16"):
            params = jax.tree_util.tree_map(
                lambda p: p.astype(jnp.bfloat16), params)
        tx = opts[name](params)
        state = jtrain.TrainState.create(params, tx)
        grad = jax.value_and_grad(jtrain.make_lm_loss(model.apply))

        @jax.jit
        def step(st, b):
            loss, g = grad(st.params, b)
            u, o = tx.update(g, st.opt_state, st.params)
            return jtrain.TrainState(st.step + 1, optax.apply_updates(
                st.params, u), o), loss

        names = {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
                 for k, v in jshm.flatten_state_dict(state).items()}
        for i in range(2):
            state, _ = step(state, _host_batch(i))
        ckpt_dir = str(tmp_path_factory.mktemp(f"jax-{name}"))
        ck = jck.FlashCheckpointer(ckpt_dir, job_name=_job(f"jo{name}"),
                                   standalone=True)
        ck.save_checkpoint(2, state, storage_type=jck.StorageType.DISK)
        assert ck.wait_latest_checkpoint(60)
        ck.close()
        jsaver.AsyncCheckpointSaver.reset()
        flat2 = {k: np.asarray(v)
                 for k, v in jshm.flatten_state_dict(state).items()}
        _, loss3 = step(state, _host_batch(2))
        cache[name] = {"names": names, "flat2": flat2,
                       "ckpt_dir": ckpt_dir, "loss3": float(loss3)}
        return cache[name]

    return get


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_tree_has_jax_names(jax_run, jax_opt_runs, name):
    """`TrainState.tree()` of each new optimizer: the names, shapes and
    dtypes JAX's ``flatten_state_dict`` gives the JAX TrainState with the
    same optax optimizer, in its order; but the dtypes of the two counts
    the port keeps as torch does (``step`` int64, torch Adam's ``count``
    float32: a restore casts them)."""
    want = jax_opt_runs(name)["names"]
    state = _opt_port_state(name, jax_run["p0"])
    tree = flatten_state_dict(state.tree())
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tree.items()}
    assert list(got) == list(want)
    torch_counts = {"step"} | {k for k in got if k.endswith("/count")
                               and got[k][1] == "float32"}
    assert torch_counts <= {"step", "opt_state/inner/0/count",
                            "opt_state/0/0/count"}
    for k in got:
        assert got[k][0] == want[k][0], k
        assert k in torch_counts or got[k][1] == want[k][1], k


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_jax_optimizer_checkpoint_resumes_in_port(jax_run, jax_opt_runs,
                                                  name):
    run = jax_opt_runs(name)
    state = _opt_port_state(name, tgpt.init_params(_cfg(), seed=1,
                                                   device="cpu"))
    ck = FlashCheckpointer(run["ckpt_dir"], job_name=_job(f"jr{name}"),
                           standalone=True)
    try:
        ck.load_checkpoint(state)
        assert ck.last_restore_report["step"] == 2
    finally:
        ck.close()
    got = flatten_state_dict(state.tree())
    for k, v in got.items():
        w = run["flat2"][k]
        v = v.detach()
        if v.dtype == torch.bfloat16:
            assert np.array_equal(v.view(torch.int16).numpy(),
                                  w.view(np.int16)), k
        else:
            assert np.array_equal(v.numpy(), w.astype(v.numpy().dtype)), k
    loss3 = _port_steps(state, [2])[0]
    np.testing.assert_allclose(loss3, run["loss3"], rtol=RTOL)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_port_optimizer_checkpoint_resumes_bitwise(jax_run, tmp_path,
                                                   name):
    """2 port steps, a save to shm, a restore into a state built from
    another seed, then one step on each: loss, parameters and every
    state leaf bitwise."""
    state = _opt_port_state(name, jax_run["p0"])
    _port_steps(state, [0, 1])
    ck = FlashCheckpointer(str(tmp_path / "ck"), job_name=_job(f"pp{name}"),
                           standalone=True)
    try:
        ck.save_checkpoint(2, state.tree(), StorageType.MEMORY)
        ck.wait_staging(60)
        fresh = _opt_port_state(name, tgpt.init_params(_cfg(), seed=1,
                                                       device="cpu"))
        ck.load_checkpoint(fresh)
        assert ck.last_restore_report["tier"] == "shm"
    finally:
        ck.close()
    a = _port_steps(state, [2])[0]
    b = _port_steps(fresh, [2])[0]
    assert a == b
    fa, fb = flatten_state_dict(state.tree()), flatten_state_dict(
        fresh.tree())
    assert list(fa) == list(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def test_jax_writes_port_resumes(jax_run):
    state = _port_state(tgpt.init_params(_cfg(), seed=1, device="cpu"))
    ck = FlashCheckpointer(jax_run["ckpt_dir"], job_name=_job("j2t"),
                           standalone=True)
    try:
        ck.load_checkpoint(state)
        rep = ck.last_restore_report
        assert (rep["tier"], rep["step"]) == ("storage", 2), rep
    finally:
        ck.close()
    # params and moments bitwise JAX's; count into every torch step
    want = jax_run["flat2"]
    got = flatten_state_dict(state.tree())
    assert list(got) == list(want)
    for k, v in got.items():
        v = v.detach().numpy()
        assert np.array_equal(v, want[k].astype(v.dtype)), k
    assert int(state.step) == 2 and state.step.dtype == torch.int64
    assert all(float(s["step"]) == 2.0
               for s in state.opt_state.state.values())
    loss3 = _port_steps(state, [2])[0]
    np.testing.assert_allclose(loss3, jax_run["loss3"], rtol=RTOL)
    _assert_params_close(state.params, jax_run["p3"])


def test_port_writes_jax_resumes(jax_run, tmp_path):
    state = _port_state(jax_run["p0"])
    _port_steps(state, [0, 1])
    ckpt_dir = str(tmp_path / "t2j")
    ck = FlashCheckpointer(ckpt_dir, job_name=_job("t2j"), standalone=True)
    ck.save_checkpoint(2, state.tree(), StorageType.DISK)
    assert ck.wait_latest_checkpoint(60)
    ck.close()
    AsyncCheckpointSaver.reset()
    res = jax_run["res"]
    template = jtrain.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, jax_run["p0"]),
        optax.adamw(3e-4))
    jk = jck.FlashCheckpointer(ckpt_dir, job_name=_job("t2jj"),
                               standalone=True)
    try:
        restored = jk.load_checkpoint(template)
        assert jk.last_restore_report["tier"] == "storage"
    finally:
        jk.close()
    assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
    want = flatten_state_dict(export_params(state.params))
    for k, v in jshm.flatten_state_dict(restored.params).items():
        assert np.array_equal(np.asarray(v), want[k].numpy()), k
    port_loss3 = _port_steps(state, [2])[0]
    jstate, m = res.train_step(restored, res.place_batch(_host_batch(2)))
    np.testing.assert_allclose(port_loss3, float(m["loss"]), rtol=RTOL)
    _assert_params_close(state.params,
                         jax.tree_util.tree_map(np.asarray, jstate.params))


def test_sharded_jax_checkpoint_assembles(tmp_path):
    mesh = _mesh()
    rng = np.random.default_rng(0)
    state = {
        "f32_2d": jax.device_put(
            jnp.asarray(rng.normal(size=(8, 8)), jnp.float32),
            NamedSharding(mesh, P("data", "model"))),
        "bf16_row": jax.device_put(
            jnp.asarray(rng.normal(size=(8, 2)), jnp.bfloat16),
            NamedSharding(mesh, P("data", None))),
        "rep": jax.device_put(jnp.arange(6, dtype=jnp.int32),
                              NamedSharding(mesh, P())),
    }
    ckpt_dir = str(tmp_path / "sharded")
    ck = jck.FlashCheckpointer(ckpt_dir, job_name=_job("shj"),
                               standalone=True)
    ck.save_checkpoint(4, state, storage_type=jck.StorageType.DISK)
    assert ck.wait_latest_checkpoint(30)
    names = {m["name"] for m in ck.engine._shm_handler.load_header()[
        "metas"]}
    ck.close()
    jsaver.AsyncCheckpointSaver.reset()
    assert "f32_2d#shard7" in names and "bf16_row#shard3" in names
    assert "rep" in names  # replicas of one whole slice are staged once
    eng = CheckpointEngine(ckpt_dir, job_name=_job("sht"), standalone=True)
    try:
        flat = eng.load()
        assert eng.last_restore["tier"] == "storage"
    finally:
        eng.close()
    np.testing.assert_array_equal(flat["f32_2d"], np.asarray(state["f32_2d"]))
    assert flat["bf16_row"].dtype == torch.bfloat16
    assert np.array_equal(flat["bf16_row"].view(torch.int16).numpy(),
                          np.asarray(state["bf16_row"]).view(np.int16))
    np.testing.assert_array_equal(flat["rep"], np.arange(6))
    template = {"f32_2d": torch.zeros(8, 8),
                "bf16_row": torch.zeros(8, 2, dtype=torch.bfloat16),
                "rep": torch.zeros(6, dtype=torch.int64)}
    restore_tree(template, flat)
    np.testing.assert_array_equal(template["f32_2d"].numpy(),
                                  np.asarray(state["f32_2d"]))
    assert torch.equal(template["bf16_row"], flat["bf16_row"])
    assert template["rep"].tolist() == list(range(6))


# -------------------------------------------------- bitwise resume


def _uninterrupted(tmp_path, tag):
    """Port GPT nano: 3 steps, a save, 2 more steps."""
    state = _port_state(tgpt.init_params(_cfg(), seed=0, device="cpu"))
    _port_steps(state, range(3))
    ck = FlashCheckpointer(str(tmp_path / tag), job_name=_job(tag),
                           standalone=True)
    ck.save_checkpoint(3, state.tree(), StorageType.DISK)
    losses = _port_steps(state, [3, 4])
    assert ck.wait_latest_checkpoint(30)
    return ck, state, losses


@pytest.mark.parametrize("tier,into", [("shm", "tree"),
                                       ("storage", "state")])
def test_bitwise_resume_from_each_tier(tmp_path, tier, into):
    """Restored into the state's tree (every parameter's AdamW step gets
    the count through `load_tree`) or into the state itself."""
    ck, state, losses = _uninterrupted(tmp_path, f"bw{tier}")
    other = _port_state(tgpt.init_params(_cfg(), seed=1, device="cpu"))
    template = other.tree() if into == "tree" else other
    try:
        ck.set_preferred_tier("" if tier == "shm" else "storage")
        assert ck.load_checkpoint(template) is template
        rep = ck.last_restore_report
        assert (rep["tier"], rep["step"]) == (tier, 3), rep
    finally:
        ck.close()
    assert all(float(s["step"]) == 3.0
               for s in other.opt_state.state.values())
    assert _port_steps(other, [3, 4]) == losses
    for a, b in zip(flatten_state_dict(state.tree()).values(),
                    flatten_state_dict(other.tree()).values()):
        assert torch.equal(a, b)


def test_restore_into_fresh_adamw_equals_stepped(tmp_path):
    """torch creates AdamW's state at the first step: restoring into an
    optimizer that never stepped gives the same next step as restoring
    into one that did."""
    ck, _, _ = _uninterrupted(tmp_path, "lazy")
    fresh = _port_state(tgpt.init_params(_cfg(), seed=2, device="cpu"))
    assert not fresh.opt_state.state
    stepped = _port_state(tgpt.init_params(_cfg(), seed=3, device="cpu"))
    _port_steps(stepped, [7])
    try:
        for s in (fresh, stepped):
            ck.load_checkpoint(s)
    finally:
        ck.close()
    assert _port_steps(fresh, [3]) == _port_steps(stepped, [3])
    for a, b in zip(flatten_state_dict(fresh.tree()).values(),
                    flatten_state_dict(stepped.tree()).values()):
        assert torch.equal(a, b)


def test_flight_dump_after_save_carries_ckpt_stage(tmp_path):
    from dlrover_wuqiong_tpu_torch.telemetry.recorder import get_recorder

    ck = FlashCheckpointer(str(tmp_path / "fl"), job_name=_job("fl"),
                           standalone=True)
    try:
        ck.save_checkpoint(1, {"w": torch.ones(64)}, StorageType.MEMORY)
        ck.wait_staging(30)
    finally:
        ck.close()
    with open(get_recorder().flush(str(tmp_path), "test")) as f:
        dump = json.load(f)
    assert dump["ledger"]["states"]["ckpt_stage"] > 0
    assert any(e["name"] == "ckpt:save" for e in dump["events"])


def test_sigkill_drill_restores_from_dead_trainer_segment():
    from dlrover_wuqiong_tpu_torch.checkpoint.drill import sigkill_drill

    r = sigkill_drill(model="nano", device="cpu", batch=2, seq=32)
    assert r["saver_rc"] == -9  # SIGKILLed, no saver survived
    assert (r["tier"], r["restored_step"]) == ("shm", 5)
    assert r["state_step_after_restore"] == 5
    # the resumed step 6 is the one the dead trainer took after its save
    assert r["resumed_losses"][0] == r["saved_losses"][5]
    assert not os.path.exists(f"/dev/shm/{r['job']}_ckpt_shm_0")


# -------------------------------------------- the trust-boundary matrix


def _commit(ck, step, value, shape=(8, 8)):
    ck.save_checkpoint(step, {"w": torch.full(shape, value),
                              "step": torch.tensor(step)},
                       storage_type=StorageType.DISK)
    assert ck.wait_latest_checkpoint(30)


def _wstep():
    return {"w": torch.zeros(8, 8), "step": torch.tensor(0)}


class TestTrustBoundary:
    def test_manifest_roundtrip_across_dtypes(self, tmp_path):
        from dlrover_wuqiong_tpu_torch.checkpoint.integrity import (
            read_manifest,
            verify_storage_step,
        )
        from dlrover_wuqiong_tpu_torch.common.storage import (
            PosixDiskStorage,
        )

        ckpt_dir = str(tmp_path / "prop")
        ck = FlashCheckpointer(ckpt_dir, job_name=_job("tbprop"),
                               standalone=True)
        g = torch.Generator().manual_seed(0)
        state = {"f32_2d": torch.randn(8, 8, generator=g),
                 "bf16_row": torch.randn(8, 2, generator=g).bfloat16(),
                 "i32": torch.arange(16, dtype=torch.int32),
                 "u8": torch.randint(0, 255, (5,), generator=g,
                                     dtype=torch.uint8),
                 "scalar": torch.tensor(42)}
        ck.save_checkpoint(3, state, storage_type=StorageType.DISK)
        assert ck.wait_latest_checkpoint(30)
        storage = PosixDiskStorage()
        v = verify_storage_step(storage, ckpt_dir, 3, per_leaf=True)
        assert v["ok"] and not v["bad_leaves"], v
        m = read_manifest(storage, str(tmp_path / "prop" / "checkpoint-3"))
        assert m["step"] == 3 and m["algo"] and m["ranks"], m
        template = {k: torch.zeros_like(t) for k, t in state.items()}
        ck.engine._shm_handler.mark_empty()  # force the storage tier
        assert ck.load_checkpoint(template) is template
        assert ck.last_restore_report["tier"] == "storage"
        for k, t in state.items():
            assert torch.equal(template[k], t), k
        ck.close()

    def test_torn_manifest_falls_back_and_quarantines(self, tmp_path):
        ckpt_dir = str(tmp_path / "torn")
        ck = FlashCheckpointer(ckpt_dir, job_name=_job("tbtorn"),
                               standalone=True)
        for step, val in ((5, 5.0), (10, 10.0)):
            _commit(ck, step, val)
        mpath = os.path.join(ckpt_dir, "checkpoint-10", "manifest.json")
        raw = open(mpath).read()
        open(mpath, "w").write(raw[:len(raw) // 2])  # graftlint: disable=atomic-publish -- the torn manifest IS the fault under test
        ck.engine._shm_handler.mark_empty()
        restored = ck.load_checkpoint(_wstep())
        rep = ck.last_restore_report
        assert torch.equal(restored["w"], torch.full((8, 8), 5.0))
        assert rep["tier"] == "storage" and rep["step"] == 5
        assert any(f["reason"] == "missing-manifest"
                   for f in rep["fallbacks"])
        qdir = tmp_path / "torn" / ".quarantine" / "checkpoint-10"
        assert qdir.is_dir() and (qdir / ".reason").exists()
        ck.close()

    def test_shm_flip_detected_heals_and_reverifies(self, tmp_path):
        ckpt_dir = str(tmp_path / "flip")
        ck = FlashCheckpointer(ckpt_dir, job_name=_job("tbflip"),
                               standalone=True)
        _commit(ck, 7, 7.0)
        h = ck.engine._shm_handler
        assert h.verify()[0]
        buf = h._buf.buf
        buf[HEADER] = (buf[HEADER] + 1) % 256  # first payload byte
        ok, why = h.verify()
        assert not ok and "digest-mismatch" in why
        restored = ck.load_checkpoint(_wstep())
        rep = ck.last_restore_report
        assert torch.equal(restored["w"], torch.full((8, 8), 7.0))
        assert rep["tier"] == "storage" and rep["healed"]
        assert any(f["tier"] == "shm" for f in rep["fallbacks"])
        ck.load_checkpoint(_wstep())
        assert ck.last_restore_report["tier"] == "shm"
        ck.close()

    def test_corrupt_shm_never_persists(self, tmp_path):
        ckpt_dir = str(tmp_path / "nop")
        ck = FlashCheckpointer(ckpt_dir, job_name=_job("tbnop"),
                               standalone=True)
        _commit(ck, 1, 1.0)
        ck.save_checkpoint(2, {"w": torch.full((8, 8), 2.0),
                               "step": torch.tensor(2)},
                           storage_type=StorageType.MEMORY)
        ck.wait_staging(30)
        ck.engine._shm_handler._buf.buf[HEADER] ^= 0xFF
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        saver.save_step_checkpoint(2, ckpt_dir, commit_timeout=3)
        assert read_last_step(ckpt_dir) == 1
        assert not os.path.exists(os.path.join(ckpt_dir, "checkpoint-2",
                                                ".commit"))
        ck.close()

    def test_metric_registry_records_saves_and_integrity_events(
            self, tmp_path):
        """The blocking and persist seconds of a save, and one integrity
        event for the corrupt shm tier and one for the degraded restore,
        land in the process's metric registry under the job's labels."""
        from dlrover_wuqiong_tpu_torch.master.metrics import get_registry

        job = _job("tbmetric")
        ck = FlashCheckpointer(str(tmp_path / "metric"), job_name=job,
                               standalone=True)
        blocked = ck.save_checkpoint(4, {"w": torch.full((8, 8), 4.0),
                                         "step": torch.tensor(4)},
                                     storage_type=StorageType.DISK)
        assert ck.wait_latest_checkpoint(30)
        reg = get_registry()
        assert reg.get_samples("dwt_ckpt_seconds",
                               {"job": job, "kind": "blocking"}) == [blocked]
        persist = reg.get_samples("dwt_ckpt_seconds",
                                  {"job": job, "kind": "persist"})
        assert len(persist) == 1 and persist[0] > 0
        ck.engine._shm_handler._buf.buf[HEADER] ^= 0xFF
        ck.load_checkpoint(_wstep())
        assert ck.last_restore_report["tier"] == "storage"
        for tier in ("shm", "degraded-restore"):
            assert reg.get_counter("dwt_ckpt_integrity_events",
                                   {"job": job, "tier": tier}) == 1.0, tier
        ck.set_preferred_tier("replica")  # the ring's tier (replica.py)
        assert ck.engine.preferred_tier == "replica"
        with pytest.raises(ValueError, match="disk"):
            ck.set_preferred_tier("disk")  # no such tier
        ck.close()


class TestRollbackBeforeStep:
    def test_load_before_step_picks_pre_spike_commit(self, tmp_path):
        ckpt_dir = str(tmp_path / "rb")
        ck = FlashCheckpointer(ckpt_dir, job_name=_job("rb1"),
                               standalone=True)
        for step in (5, 10, 15):
            ck.save_checkpoint(step, {"w": torch.full((4,), float(step))},
                               storage_type=StorageType.DISK)
            assert ck.wait_latest_checkpoint(30)
        assert ck.engine.committed_steps() == [5, 10, 15]
        template = {"w": torch.zeros(4)}
        restored = ck.load_checkpoint(template, before_step=12)
        assert torch.equal(restored["w"], torch.full((4,), 10.0))
        assert ck.engine.committed_steps() == [5, 10]
        assert ck.last_step() == 10
        restored = ck.load_checkpoint(template, before_step=5)
        assert torch.equal(restored["w"], torch.full((4,), 10.0))
        ck.close()

    def test_partial_step_not_committed_and_not_assembled(self, tmp_path):
        ckpt_dir = str(tmp_path / "rbp")
        ck = FlashCheckpointer(ckpt_dir, job_name=_job("rb2"),
                               standalone=True)
        for step in (5, 10):
            ck.save_checkpoint(step, {"w": torch.full((4,), float(step))},
                               storage_type=StorageType.DISK)
            assert ck.wait_latest_checkpoint(30)
        src, dst = (os.path.join(ckpt_dir, f"checkpoint-{s}")
                    for s in (5, 8))
        shutil.copytree(src, dst)
        os.remove(os.path.join(dst, ".commit"))
        assert ck.engine.committed_steps() == [5, 10]
        restored = ck.load_checkpoint({"w": torch.zeros(4)}, before_step=9)
        assert torch.equal(restored["w"], torch.full((4,), 5.0))
        ck.close()


_MID_PERSIST_SAVER = r"""
import os, sys
import torch

from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
    FlashCheckpointer, StorageType)

ckpt_dir = sys.argv[1]
ck = FlashCheckpointer(ckpt_dir, job_name=os.environ["DWT_JOB_NAME"],
                       standalone=True)
ck.save_checkpoint(1, {"w": torch.full((8, 8), 1.0), "step": torch.tensor(1)},
                   storage_type=StorageType.DISK)
assert ck.wait_latest_checkpoint(60)
os.environ["DWT_CKPT_CRASH_POINT"] = sys.argv[2]
ck.save_checkpoint(2, {"w": torch.full((8, 8), 2.0), "step": torch.tensor(2)},
                   storage_type=StorageType.DISK)
ck.wait_latest_checkpoint(60)
"""


@pytest.mark.parametrize("crash_point", ["after-bin", "before-manifest"])
def test_sigkill_mid_persist_restores_previous_generation(tmp_path,
                                                          crash_point):
    """The saver dies between the shard file and the manifest (and
    between the done-files and the manifest): the torn generation is
    invisible or quarantined, restore serves step 1, and the dead run's
    segment is reaped by the next saver's sweeper."""
    ckpt_dir = str(tmp_path / "mp")
    job = _job(f"mp{crash_point[0]}")
    script = tmp_path / "saver.py"
    script.write_text(_MID_PERSIST_SAVER)
    env = dict(os.environ, DWT_JOB_NAME=job,
               DWT_SOCKET_DIR=tempfile.mkdtemp(prefix="dwt-mp-"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run([sys.executable, str(script), ckpt_dir,
                           crash_point], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 137, proc.stdout + proc.stderr
    assert not os.path.exists(os.path.join(ckpt_dir, "checkpoint-2",
                                           "manifest.json"))
    ck = FlashCheckpointer(ckpt_dir, job_name=f"{job}-v", standalone=True)
    try:
        assert not os.path.exists(f"/dev/shm/{job}_ckpt_shm_0")
        restored = ck.load_checkpoint(_wstep())
        rep = ck.last_restore_report
        assert int(restored["step"]) == 1
        assert torch.equal(restored["w"], torch.full((8, 8), 1.0))
        assert rep["step"] == 1 and rep["tier"] == "storage"
    finally:
        ck.close()


def test_stale_segment_sweeper_reaps_dead_spares_live():
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        sweep_stale_segments,
    )

    dead, live = _job("swd"), _job("swl")
    code = ("import torch;"
            "from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import "
            "SharedMemoryHandler;"
            f"h = SharedMemoryHandler(0, {dead!r});"
            "h.save_state_dict({'w': torch.ones(4)}, step=1);"
            "h.close()")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60,
                   env=dict(os.environ, PYTHONPATH=REPO))
    assert os.path.exists(f"/dev/shm/{dead}_ckpt_shm_0")
    h = SharedMemoryHandler(0, live)
    h.save_state_dict({"w": torch.ones(4)}, step=1)
    try:
        reaped = sweep_stale_segments("some-other-job")
        assert f"{dead}_ckpt_shm_0" in reaped
        assert not os.path.exists(f"/dev/shm/{dead}_ckpt_shm_0")
        assert os.path.exists(f"/dev/shm/{live}_ckpt_shm_0")
        assert f"{live}_ckpt_shm_0" not in sweep_stale_segments(live)
    finally:
        h.unlink()


def test_teardown_flush_persists_memory_only_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "flush")
    ck = FlashCheckpointer(ckpt_dir, job_name=_job("fl1"), standalone=True)
    ck.save_checkpoint(4, {"w": torch.arange(8, dtype=torch.float32)},
                       storage_type=StorageType.MEMORY)
    ck.close()
    AsyncCheckpointSaver.reset()  # saver.stop() flushes the staged step
    assert read_last_step(ckpt_dir) == 4
    eng = CheckpointEngine(ckpt_dir, job_name=_job("fl2"), standalone=True)
    try:
        np.testing.assert_array_equal(eng.load_from_storage()["w"],
                                      np.arange(8))
    finally:
        eng.close()


class TestMultiNodeCommit:
    def test_tracker_waits_for_all_world_shards(self, tmp_path):
        import threading

        path = str(tmp_path / "mn")
        saver0 = AsyncCheckpointSaver(job_name=_job("mn0"),
                                      local_shard_num=1, node_rank=0,
                                      world_shard_num=2)
        saver1 = AsyncCheckpointSaver(job_name=_job("mn1"),
                                      local_shard_num=1, node_rank=1,
                                      world_shard_num=2)
        try:
            SharedMemoryHandler(0, _job("mn0")).save_state_dict(
                {"w": torch.ones(4)}, step=3)
            SharedMemoryHandler(0, _job("mn1")).save_state_dict(
                {"w": torch.ones(4) * 2}, step=3)
            done0 = threading.Event()

            def _node0_save():
                saver0.save_step_checkpoint(3, path, commit_timeout=30)
                done0.set()

            t = threading.Thread(target=_node0_save, daemon=True)
            t.start()
            time.sleep(1.5)  # node 0 alone: commit must still be waiting
            assert not done0.is_set()
            assert not os.path.exists(
                os.path.join(path, "latest_checkpointed_iteration.txt"))
            saver1.save_step_checkpoint(3, path)  # rank != 0 never commits
            assert done0.wait(timeout=30)
            t.join(timeout=30)
            assert read_last_step(path) == 3
        finally:
            saver0.stop()
            saver1.stop()

    def test_node1_global_rank_offset(self, tmp_path):
        path = str(tmp_path / "gr")
        saver = AsyncCheckpointSaver(job_name=_job("gr1"), local_shard_num=1,
                                     node_rank=1, world_shard_num=2)
        try:
            SharedMemoryHandler(0, _job("gr1")).save_state_dict(
                {"w": torch.zeros(2)}, step=1)
            saver.save_step_checkpoint(1, path)
            sdir = os.path.join(path, "checkpoint-1")
            assert os.path.exists(os.path.join(sdir, "meta_rank1.json"))
            assert os.path.exists(os.path.join(sdir, ".done", "rank1.done"))
        finally:
            saver.stop()


def test_bf16_wire_contract(tmp_path):
    """bf16 wire staging: float32 leaves come back as their bf16 round
    trip, bf16 and integer leaves bit-exactly, into the template's
    dtypes."""
    ckpt_dir = str(tmp_path / "wire")
    ck = FlashCheckpointer(ckpt_dir, job_name=_job("wire"), standalone=True,
                           wire_dtype="bf16")
    f32 = torch.linspace(0.0, 1.0, 64).reshape(8, 8)
    bf16 = torch.linspace(-1.0, 1.0, 64).reshape(8, 8).bfloat16()
    ints = torch.arange(8, dtype=torch.int32)
    state = {"f32": f32, "bf16": bf16, "ints": ints}
    ck.save_checkpoint(3, state, storage_type=StorageType.DISK)
    assert ck.wait_latest_checkpoint(30)
    meta = json.loads((tmp_path / "wire" / "checkpoint-3" /
                       "meta_rank0.json").read_text())
    dtypes = {t["name"]: t["dtype"] for t in meta["tensors"]}
    assert dtypes == {"f32": "bfloat16", "bf16": "bfloat16",
                      "ints": "int32"}
    template = {"f32": torch.zeros(8, 8), "bf16": torch.zeros(
        8, 8, dtype=torch.bfloat16), "ints": torch.zeros(8, dtype=torch.int32)}
    for tier in ("", "storage"):
        ck.set_preferred_tier(tier)
        restored = ck.load_checkpoint(template)
        assert restored["f32"].dtype == torch.float32
        assert torch.equal(restored["f32"], f32.bfloat16().float())
        assert torch.equal(restored["bf16"], bf16)
        assert torch.equal(restored["ints"], ints)
    ck.close()


# ------------------------------------------------- sharded states

#: the mesh plans whose checkpoints are held against JAX's (4 devices)
SHARDED = {"fsdp": [("fsdp", {})],
           "tp_fsdp": [("tensor_parallel", {"size": 2}), ("fsdp", {})]}


def _jax_mesh_state(strategy):
    res = jax_auto_accelerate(
        jgpt.GPT(jgpt.GPTConfig.nano()), optimizer=optax.adamw(1e-2),
        devices=jax.devices()[:4],
        strategy=list(strategy) + [("half", {"enabled": False})])
    return res.state


def _jax_refs(state):
    return {(e, tuple(g), tuple(tuple(i) for i in idx))
            for name, leaf in jshm.flatten_state_dict(state).items()
            for e, _, g, idx in jshm._leaf_refs(name, leaf)}


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """JAX's leaves for each plan on 4 host devices and a JAX fsdp
    checkpoint; the port's world of 4 writing, resuming, and reading
    JAX's; a world of 2 reading the port's fsdp checkpoint."""
    import torch_world as tw

    base = tmp_path_factory.mktemp("sharded")
    jax_states = {k: _jax_mesh_state(s) for k, s in SHARDED.items()}
    jax_dir = str(base / "jax_fsdp")
    jsaver.AsyncCheckpointSaver.reset()
    ck = jck.FlashCheckpointer(jax_dir, job_name=_job("jshw"),
                               standalone=True)
    ck.save_checkpoint(0, jax_states["fsdp"],
                       storage_type=jck.StorageType.DISK)
    assert ck.wait_latest_checkpoint(60)
    ck.close()
    jsaver.AsyncCheckpointSaver.reset()
    dirs = {k: str(base / k) for k in SHARDED}
    w4 = tw.run_world(4, tw.ckpt_write_world, list(SHARDED.items()), dirs,
                      _job("w4"), jax_dir)
    w2 = tw.run_world(2, tw.ckpt_read_world, SHARDED["fsdp"], dirs["fsdp"],
                      _job("w2"))
    return {"jax_refs": {k: _jax_refs(s) for k, s in jax_states.items()},
            "jax_fsdp": {k: np.asarray(v) for k, v in
                         jshm.flatten_state_dict(jax_states["fsdp"]).items()},
            "w4": w4, "w2": w2, "dirs": dirs}


@pytest.mark.parametrize("key", sorted(SHARDED))
def test_sharded_leaves_are_jax_names_and_indices(sharded_runs, key):
    """The #shardN names, global shapes and indices the port's 4 ranks
    write together are those JAX writes for the same plan; a replicated
    piece is written once."""
    refs = [r[key]["refs"] for r in sharded_runs["w4"]]
    union = [x for rank in refs for x in rank]
    assert len(union) == len(set(union))
    assert set(union) == sharded_runs["jax_refs"][key]
    assert any("#shard3" in e for e, _, _ in union)


@pytest.mark.parametrize("key", sorted(SHARDED))
def test_sharded_checkpoint_resumes_bitwise_in_its_world(sharded_runs, key):
    for r in sharded_runs["w4"]:
        got = r[key]
        assert got["tier"] == "storage" and got["step"] == 4
        assert got["resumed"] == got["after"]
        assert got["bitwise"]


def test_sharded_checkpoint_resumes_in_smaller_worlds(sharded_runs):
    """The fsdp-4 checkpoint from storage into a world of 2 (fsdp 2) and
    into a world of 1 (the unsharded build): bitwise the saved state."""
    import torch_world as tw

    saved = sharded_runs["w4"][0]["fsdp"]["saved"]
    got2 = sharded_runs["w2"][0]["restored"]
    assert sorted(got2) == sorted(saved)
    assert all(tw.np_equal(got2[n], saved[n]) for n in saved)
    assert all(r["step"] == 3 and np.isfinite(r["loss"])
               for r in sharded_runs["w2"])
    one = tw._fresh([])
    ck = FlashCheckpointer(sharded_runs["dirs"]["fsdp"], job_name=_job("w1"),
                           standalone=True)
    try:
        assert ck.load_checkpoint(one.state.tree()) is not None
    finally:
        ck.close()
    got1 = tw.restored_global(one)
    assert all(tw.np_equal(got1[n], saved[n]) for n in saved)
    assert int(one.state.step) == 2


def test_jax_fsdp_checkpoint_resumes_in_port_world(sharded_runs):
    """A checkpoint JAX wrote from fsdp over 4 host devices restores
    into the port's fsdp build in a world of 4, bitwise."""
    got = sharded_runs["w4"][0]["jax"]
    want = sharded_runs["jax_fsdp"]
    for n, v in got.items():
        assert np.array_equal(v, want[n]), n
