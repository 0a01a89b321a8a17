"""Port parity: torch DCP interop and the sharded layouts of adamw8bit's
quantized state.

`checkpoint/dcp_compat.py` is the counterpart of JAX's
`checkpoint/orbax_compat.py` (whose tests/test_checkpoint.py::
TestOrbaxInterop it follows in semantics: an export of a committed
flash checkpoint, a load onto another mesh, an import back into the
flash layout).  In gloo worlds of 4 and 2 CPU processes
(`torch_world.dcp_write_world`, `torch_world.dcp_read_world`) and in
this process (a world of 1):

- JAX's fsdp flash checkpoint (4 host devices, one ``optax.adamw``
  step) exported to DCP by the port's world of 4 loads in worlds of 4,
  2 and 1 bitwise equal to JAX's values; `import_dcp` writes it back
  into a flash dir that a fresh build resumes bitwise; `export_dcp`
  raises ``FileNotFoundError`` on a dir with no commit;
- adamw8bit over fsdp 4 (`parallel.fsdp` layouts): GPT nano, whose
  ``Shard(0)`` kernels are 256-aligned runs (layout A) and whose
  ``Shard(1)`` kernels are not (layout B), and GPT nano 80 wide, whose
  attention kernels are unaligned ``Shard(0)`` runs (layout B), saved
  by flash and by DCP,
  restore bitwise in their own world (codes, scales, the next step);
  in a world of 2 a moment laid out A on both meshes comes back bitwise
  and any other within ``QUANT_TOL`` of its leaf's absmax (dequantized,
  then quantized in the new pieces' blocks);
- distinct codes planted on each of the 4 ranks all come back from DCP
  (a rank's piece is no replicated tensor that one rank writes);
- JAX's adamw8bit fsdp checkpoint assembles onto the port's layout-A
  pieces bitwise (its layout-B pieces within ``QUANT_TOL``), and JAX
  restores the port's layout-A leaves.
"""

import os
import tempfile

import jax
import numpy as np
import optax
import pytest
import torch

import torch_world as tw
from dlrover_wuqiong_tpu.auto.accelerate import (
    auto_accelerate as jax_auto_accelerate,
)
from dlrover_wuqiong_tpu.checkpoint import checkpointer as jck
from dlrover_wuqiong_tpu.checkpoint import ckpt_saver as jsaver
from dlrover_wuqiong_tpu.checkpoint.shm_handler import (
    flatten_state_dict as jax_flatten,
)
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.optimizers import low_bit as jlow
from dlrover_wuqiong_tpu_torch.checkpoint import dcp_compat
from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
    AsyncCheckpointSaver,
)
from dlrover_wuqiong_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_wuqiong_tpu_torch.optimizers.low_bit import dequantize_rows
from torch_threads import one_torch_thread  # noqa: F401

#: a value requantized into another block moves by at most its new
#: block's absmax / 127 (the sqrt map's half code step, 1/254 in sqrt
#: space, times 2 sqrt(|x| / absmax) <= 2), plus rounding
QUANT_TOL = 1.01 / 127


def _jax_state(optimizer, steps):
    res = jax_auto_accelerate(
        jgpt.GPT(jgpt.GPTConfig.nano()), optimizer=optimizer,
        devices=jax.devices()[:4],
        strategy=[("fsdp", {}), ("half", {"enabled": False})])
    state = res.state
    for b in tw.host_batches(steps):
        state, _ = res.train_step(state, res.place_batch(b))
    return res, state


def _jax_save(state, ckdir, job):
    jsaver.AsyncCheckpointSaver.reset()
    ck = jck.FlashCheckpointer(ckdir, job_name=job, standalone=True)
    ck.save_checkpoint(int(state.step), state,
                       storage_type=jck.StorageType.DISK)
    assert ck.wait_latest_checkpoint(60)
    ck.close()
    jsaver.AsyncCheckpointSaver.reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dcp")
    job = f"dc{next(tempfile._get_candidate_names())}"
    jax_dirs = {"fsdp": str(base / "jax_fsdp"),
                "adamw8bit": str(base / "jax_8bit")}
    _, fsdp = _jax_state(optax.adamw(1e-2), 1)
    _jax_save(fsdp, jax_dirs["fsdp"], f"{job}-jf")
    res8, q8 = _jax_state(jlow.adamw8bit(1e-3), 2)
    _jax_save(q8, jax_dirs["adamw8bit"], f"{job}-j8")
    dirs = {k: str(base / k) for k in (
        "jax_dcp", "imported", "flash_nano", "flash_n_embd80", "dcp_nano",
        "dcp_n_embd80", "plant")}
    w4 = tw.run_world(4, tw.dcp_write_world, jax_dirs, dirs, f"{job}-w4")
    w2 = tw.run_world(2, tw.dcp_read_world, dirs, f"{job}-w2")
    return {"jax_fsdp": {k: np.asarray(v)
                         for k, v in jax_flatten(fsdp).items()},
            "jax_step": int(fsdp.step),
            "jax8": {k: np.asarray(v) for k, v in jax_flatten(q8).items()},
            "jax8_res": res8, "dirs": dirs, "w4": w4, "w2": w2}


def _equal_jax(got, want):
    assert got and all(np.array_equal(v, want[n]) for n, v in got.items())


def test_jax_fsdp_export_loads_bitwise_in_worlds_of_4_2_1(runs):
    want = runs["jax_fsdp"]
    for r in runs["w4"]:
        if r["exported"] is not None:
            _equal_jax(r["exported"], want)
    _equal_jax(runs["w2"][0]["exported"], want)
    one = tw._fresh([])
    dcp_compat.load_dcp(runs["dirs"]["jax_dcp"], one.state)
    _equal_jax(tw.restored_global(one), want)
    assert int(one.state.step) == runs["jax_step"]


def test_import_dcp_writes_a_flash_checkpoint_that_resumes_bitwise(runs):
    """`import_dcp` of the export into a new flash dir; a fresh fsdp
    build restores it (the values JAX's) and takes the same step as
    the build that loaded the DCP checkpoint itself."""
    r0 = runs["w4"][0]
    _equal_jax(r0["imported"], runs["jax_fsdp"])
    for r in runs["w4"]:
        assert r["imported_step"] == runs["jax_step"]
        assert r["resumed"][0] == r["resumed"][1]
    steps = sorted(os.listdir(runs["dirs"]["imported"]))
    assert "checkpoint-5" in steps


def test_export_without_a_commit_raises(tmp_path):
    AsyncCheckpointSaver.reset()
    try:
        with pytest.raises(FileNotFoundError, match="no committed flash"):
            dcp_compat.export_dcp(str(tmp_path / "empty"),
                                  str(tmp_path / "out"), tw._fresh([]).state,
                                  job_name=f"dce{os.getpid()}")
    finally:
        AsyncCheckpointSaver.reset()


def test_piece_keys_round_trip():
    key = dcp_compat._piece_key("opt_state/0/mu/wte/embedding/0", 3,
                                [[96, 128], [0, 256]], [128, 256])
    assert key == ("opt_state/0/mu/wte/embedding/0#shard3"
                   "[96:128,0:256]of[128,256]")
    assert dcp_compat._parse_piece(key) == (
        "opt_state/0/mu/wte/embedding/0", [[96, 128], [0, 256]], [128, 256])
    assert dcp_compat._parse_piece("step") is None


def _rule(ranks, n):
    """Layout A iff every piece of leaf `n` is a run of its flattening
    on a 256-element boundary, a multiple of 256 long or ending the
    leaf: cut on dim 0 only."""
    pieces = [moments[n] for moments in ranks]
    shape = [max(idx[d][1] for idx, _, _ in pieces)
             for d in range(len(pieces[0][0]))]
    inner = int(np.prod(shape[1:]))
    for idx, _, _ in pieces:
        (a, b), rest = idx[0], idx[1:]
        if any(r != [0, s] for r, s in zip(rest, shape[1:])):
            return "B"
        if (a * inner) % 256 or ((b - a) * inner % 256 and b != shape[0]):
            return "B"
    return "A"


@pytest.mark.parametrize("key", ["nano", "n_embd80"])
def test_quantized_layouts(runs, key):
    """Each sharded leaf's state is laid out by the rule (`_rule`), and
    both layouts occur: GPT nano's Shard(1) kernels are B and its
    Shard(0) kernels A; 80 wide, the attention kernels' Shard(0) pieces
    (20 rows of 240) are B too."""
    q = runs["w4"][0][f"quant_{key}"]
    ranks = [r[f"quant_{key}"]["moments"] for r in runs["w4"]]
    assert q["layouts"] == {n: _rule(ranks, n) for n in q["layouts"]}
    assert set(q["layouts"].values()) == {"A", "B"}
    assert q["layouts"]["h_0.mlp.c_fc.kernel"] == "A"
    assert q["layouts"]["h_0.attn.c_attn.kernel"] == (
        "A" if key == "nano" else "B")


@pytest.mark.parametrize("key", ["nano", "n_embd80"])
@pytest.mark.parametrize("via", ["flash", "dcp"])
def test_quantized_state_restores_bitwise_in_its_world(runs, key, via):
    """Saved over fsdp 4 and restored into fresh builds (another seed) in
    the same world: each rank's codes and scales bitwise, and the next
    step's loss and parameters bitwise the original's."""
    for r in runs["w4"]:
        q = r[f"quant_{key}"]
        digest, loss, params = q["restored"][via]
        assert digest == q["saved"]
        assert (loss, params) == q["next"]


def _assemble(ranks, which):
    """{name: the global moment} from each rank's (index, mu, nu)."""
    shapes = {}
    for moments in ranks:
        for n, (index, _, _) in moments.items():
            stops = [b for _, b in index]
            shapes[n] = [max(a, b) for a, b in zip(stops, shapes.get(
                n, stops))]
    out = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    for moments in ranks:
        for n, (index, mu, nu) in moments.items():
            out[n][tuple(slice(a, b) for a, b in index)] = \
                mu if which == "mu" else nu
    return out


@pytest.mark.parametrize("key", ["nano", "n_embd80"])
@pytest.mark.parametrize("via", ["flash", "dcp"])
def test_quantized_state_onto_another_mesh(runs, key, via):
    """The fsdp-4 saves restored over fsdp 2: every layout-A moment
    bitwise, a layout-B one within ``QUANT_TOL`` of its leaf's absmax."""
    saved = [r[f"quant_{key}"]["moments"] for r in runs["w4"]]
    got = [r[f"quant_{key}_{via}"][0] for r in runs["w2"]]
    written = runs["w4"][0][f"quant_{key}"]["layouts"]
    read = runs["w2"][0][f"quant_{key}_{via}"][1]
    assert "A" in read.values() and "B" in read.values()
    for which in ("mu", "nu"):
        want, have = _assemble(saved, which), _assemble(got, which)
        assert sorted(want) == sorted(have)
        for n, w in want.items():
            if written.get(n, "A") == read.get(n, "A") == "A":
                assert np.array_equal(have[n], w), (which, n)
            else:
                bound = QUANT_TOL * np.abs(w).max()
                assert np.abs(have[n] - w).max() <= bound, (which, n)


def test_planted_codes_of_every_rank_come_back(runs):
    """Each rank's codes filled with rank + 1 before the DCP save: the
    global codes read back hold every rank's value over its rows."""
    planted = runs["w4"][0]["planted"]
    seen = set()
    for rank, r in enumerate(runs["w4"]):
        for name, index in r["planted_index"].items():
            rows = planted[name][tuple(slice(a, b) for a, b in index)]
            assert rows.numel() and bool((rows == rank + 1).all()), name
            seen.add(rank)
    assert seen == {0, 1, 2, 3}


def _jax_moment(flat, path, which):
    q = torch.from_numpy(flat[f"opt_state/0/{which}/{path}/0"].copy())
    s = torch.from_numpy(flat[f"opt_state/0/{which}/{path}/1"].copy())
    return q, s


def test_jax_adamw8bit_checkpoint_assembles_on_port_pieces(runs):
    """JAX's adamw8bit fsdp checkpoint (its whole leaves' blocks)
    restored over the port's fsdp 4: a layout-A piece's moments are rows
    of JAX's codes and scales, bitwise; a layout-B piece's are JAX's
    moment quantized in the piece's blocks, within ``QUANT_TOL``."""
    flat = runs["jax8"]
    ranks = [r["jax8"][0] for r in runs["w4"]]
    layouts = runs["w4"][0]["jax8"][1]
    assert "A" in layouts.values()
    got = {w: _assemble(ranks, w) for w in ("mu", "nu")}
    for n in got["mu"]:
        for which in ("mu", "nu"):
            have = got[which][n]
            q, s = _jax_moment(flat, n.replace(".", "/"), which)
            want = dequantize_rows(q, s, have.size).reshape(
                have.shape).numpy()
            if layouts.get(n, "A") == "A":
                assert np.array_equal(have, want), (which, n)
            else:
                bound = QUANT_TOL * np.abs(want).max()
                assert np.abs(have - want).max() <= bound, (which, n)


def test_jax_restores_the_ports_adamw8bit_checkpoint(runs):
    """The port's adamw8bit checkpoint (GPT nano over fsdp 4, step 2)
    restores into JAX's adamw8bit fsdp state on 4 host devices: every
    layout-A leaf's codes and scales (JAX's shapes) are the port's,
    bitwise.  A layout-B leaf has shapes of the port's own, which JAX
    does not read."""
    ckdir = runs["dirs"]["flash_nano"]
    AsyncCheckpointSaver.reset()
    eng = CheckpointEngine(ckdir, job_name=f"dcr{os.getpid()}",
                           standalone=True)
    try:
        port = eng.load_from_storage()
    finally:
        eng.close()
        AsyncCheckpointSaver.reset()
    jsaver.AsyncCheckpointSaver.reset()
    ck = jck.FlashCheckpointer(ckdir, job_name=f"dcj{os.getpid()}",
                               standalone=True)
    try:
        state = ck.load_checkpoint(runs["jax8_res"].state)
    finally:
        ck.close()
        jsaver.AsyncCheckpointSaver.reset()
    got = {k: np.asarray(v) for k, v in jax_flatten(state).items()}
    shapes = {k: v.shape for k, v in runs["jax8"].items()}
    quant = [k for k in got if ("/mu/" in k or "/nu/" in k)
             and np.asarray(port[k]).shape == shapes[k]]
    assert "opt_state/0/mu/h_0/attn/c_attn/kernel/0" in quant
    for k in quant:
        assert np.array_equal(got[k], np.asarray(port[k])), k
    assert int(state.step) == 2
