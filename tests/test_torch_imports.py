"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

- Importing every module of dlrover_wuqiong_tpu_torch (in a fresh
  interpreter) loads no ``jax``/``flax``/``optax`` module and no module of
  the JAX package, and starts no CUDA context.
- An AST scan of the package finds no such import anywhere, including
  imports deferred into function bodies.
- Entry points default to ``cuda`` and raise where CUDA is absent; that
  includes the training path (`auto_accelerate`, `GPT.init_params`) and
  the flash-attention kernels, which never take a CPU tensor.
- The kernel build holds both CUDA sources and uses the sm_90a target,
  IEEE division and accurate transcendentals (no fast math).
- The flash checkpoint restores into the template's own tensors on their
  device, asks nowhere whether CUDA is available, and raises for a leaf
  on another device; its copies of the JAX package's jax-free modules
  import no ``ml_dtypes`` either.
- The elastic launcher's process (``run``: the master, the agent and its
  checkpoint saver) never touches ``torch.cuda``, through a worker's
  failure and restart; the `Trainer` defaults to ``cuda``.
- The journaled master's process (``python -m
  dlrover_wuqiong_tpu_torch.master``, a ``--standby-of`` standby too),
  the sharding client, the standby tailer and the incident timeline
  import no ``torch``, no numpy and nothing of JAX; the master-kill and
  master-failover drills default to ``cuda``.
- The optimizers (``optimizers``: AGD, int8-state Adam, WSAM, stable
  bf16, muP, the leaf-wise step and the offload) are among the modules
  imported and scanned.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from dlrover_wuqiong_tpu_torch import _build
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dlrover_wuqiong_tpu_torch")
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "ml_dtypes",
                   "dlrover_wuqiong_tpu")


#: the serving worker's control plane: each keeps its own copy of what it
#: needs from the JAX package's jax-free modules
CONTROL_PLANE = ("common.serialize", "common.comm", "common.log",
                 "common.util", "common.global_context", "common.messages",
                 "telemetry.recorder", "telemetry.spans", "master.journal",
                 "master.serve_queue", "master.servicer", "master.master",
                 "agent.master_client", "serving.worker", "serving.__main__",
                 "chaos")

#: the flash checkpoint and the copies it needs (bfloat16 and float8 move
#: as integer views: no ml_dtypes)
CHECKPOINT = ("common.constants", "common.multi_process", "common.storage",
              "telemetry.ledger", "master.metrics", "checkpoint.integrity",
              "checkpoint.shm_handler", "checkpoint.ckpt_saver",
              "checkpoint.engine", "checkpoint.checkpointer",
              "checkpoint.drill", "checkpoint.replica")

#: the elastic trainer: the launcher, the master's training managers, the
#: agent, and the worker side
ELASTIC = ("common.node", "master.error_monitor", "master.job_manager",
           "master.net_topology", "master.rendezvous", "master.kv_store",
           "master.speed_monitor", "agent.elastic_agent", "run",
           "trainer.elastic", "trainer.trainer", "trainer.drill")


#: the journaled master and dataset sharding: the master process and the
#: worker's sharding client
MASTER_JOURNAL = ("master.journal", "master.dataset_splitter",
                  "master.task_manager", "master.__main__",
                  "agent.sharding_client")

#: the warm standby and the incident timeline
STANDBY = ("master.standby", "telemetry.timeline",
           "telemetry.incident_report")
#: the optimizers and the leaf-wise step they share with the offload
OPTIMIZERS = ("optimizers", "optimizers.leaf", "optimizers.agd",
              "optimizers.low_bit", "optimizers.wsam",
              "optimizers.bf16_stable", "optimizers.mup")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_ROOTS


def _package_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return sorted(mods)


#: the mesh strategies' modules (ROADMAP items 8a, 8b and 8c), the DCP
#: interop of their checkpoints (item 6c) and the RL hybrid engine
PARALLEL = ("parallel.mesh", "parallel.sharding", "parallel.fsdp",
            "parallel.long_context", "parallel.local_sgd",
            "parallel.pipeline", "rl.hybrid",
            "checkpoint.dcp_compat", "common.storage")


def test_import_loads_no_jax_and_no_cuda():
    code = (
        "import importlib, json, sys, torch\n"
        f"mods = {_package_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps({'mods': sorted(sys.modules),"
        " 'cuda': torch.cuda.is_initialized()}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in rec["mods"] if _forbidden(m)]
    assert leaked == []
    assert rec["cuda"] is False
    for mod in ("serving.engine", "ops.flash_attention", "models.gpt",
                "models.llama", "models.attention", "models.fp8",
                "models.moe", "ops.remat",
                "trainer.train_step", "auto.accelerate") + CONTROL_PLANE \
            + CHECKPOINT + ELASTIC + MASTER_JOURNAL + STANDBY + OPTIMIZERS \
            + PARALLEL:
        assert f"dlrover_wuqiong_tpu_torch.{mod}" in rec["mods"]


def test_ast_scan_finds_no_forbidden_import():
    seen, scanned = [], []
    for mod in _package_modules():
        path = os.path.join(REPO, *mod.split(".")) + (
            ".py" if os.path.isfile(os.path.join(REPO, *mod.split("."))
                                    + ".py") else os.sep + "__init__.py")
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            seen.extend(names)
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"
        scanned.append(mod)
    assert "torch" in seen  # the scan did walk the package
    for mod in CONTROL_PLANE + CHECKPOINT + ELASTIC + MASTER_JOURNAL \
            + STANDBY:
        assert f"dlrover_wuqiong_tpu_torch.{mod}" in scanned


@pytest.mark.parametrize("mod", ["master.__main__",
                                 "agent.sharding_client",
                                 "master.standby", "telemetry.timeline",
                                 "telemetry.incident_report"])
def test_master_process_modules_import_no_torch(mod):
    """A master restart pays the interpreter and the replay, not torch's
    import: the master's entry point and the sharding client load no
    ``torch``, no numpy and nothing of JAX."""
    code = ("import importlib, json, sys\n"
            f"importlib.import_module('dlrover_wuqiong_tpu_torch.{mod}')\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in mods if _forbidden(m)
           or m.split(".")[0] in ("torch", "numpy")]
    assert bad == []


def test_standby_process_imports_no_torch(tmp_path):
    """``python -m dlrover_wuqiong_tpu_torch.master --standby-of ...``
    tails (an absent primary here), gives up after its budget, and has
    loaded no ``torch``, no numpy and nothing of JAX on the way."""
    code = ("import json, sys\n"
            "from dlrover_wuqiong_tpu_torch.master.__main__ import main\n"
            "rc = main(['--port=0', '--standby-of=127.0.0.1:1',\n"
            f"           '--journal-dir={tmp_path / 'mirror'}',\n"
            "           '--lease-ttl=0.3', '--max-seconds=0.5'])\n"
            "print(json.dumps([rc, sorted(sys.modules)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rc, mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0
    assert "dlrover_wuqiong_tpu_torch.master.standby" in mods
    bad = [m for m in mods if _forbidden(m)
           or m.split(".")[0] in ("torch", "numpy")]
    assert bad == []


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU a default-device call raises; nothing falls back."""
    from dlrover_wuqiong_tpu_torch import resolve_device
    from dlrover_wuqiong_tpu_torch.models.gpt import GPTConfig, init_params
    from dlrover_wuqiong_tpu_torch.serving import ServeSpec, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig.nano()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, params, ServeSpec())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serving_worker_entry_points_default_to_cuda(monkeypatch):
    """The worker's command line (``--device`` defaults to ``cuda``) and
    the drain drill build on the card; without a GPU the worker raises
    before it dials the master."""
    import inspect

    from dlrover_wuqiong_tpu_torch import chaos
    from dlrover_wuqiong_tpu_torch.serving import __main__ as worker_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker_main.main(["--master", "127.0.0.1:1"])
    for drill in (chaos.serve_drain, chaos.ckpt_corrupt, chaos.master_kill,
                  chaos.master_kill_reference, chaos.master_failover):
        assert inspect.signature(drill).parameters["device"].default == \
            "cuda"


def test_training_entry_points_default_to_cuda(monkeypatch):
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        auto_accelerate(GPT(GPTConfig.nano()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPT(GPTConfig.nano()).init_params()
    x = torch.zeros((1, 64, 64), dtype=torch.bfloat16)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tfa._fa_forward_kernel(x, x, x, True, 0.125)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tfa._fa_backward_kernel(x, x, x, x, x[..., 0].float(), x, True,
                                0.125, None, "fused")
    assert sum(tfa.LAUNCHES.values()) == 0


def test_llama_entry_points_default_to_cuda(monkeypatch):
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        init_params,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Llama(LlamaConfig.nano()).init_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(LlamaConfig.nano())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        auto_accelerate(Llama(LlamaConfig.nano()))


def _check_nvcc_command(monkeypatch, name):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command(name, "out.so")
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert not any("fast_math" in c or "fast-math" in c or "ftz" in c
                   for c in cmd)
    assert cmd[-1].endswith(os.path.join("csrc", f"{name}.cu"))


def test_nvcc_command_targets_sm90a_without_fast_math(monkeypatch):
    _check_nvcc_command(monkeypatch, "int8_blockwise")


def test_flash_attention_builds_with_sm90a_without_fast_math(monkeypatch):
    _check_nvcc_command(monkeypatch, "flash_attention")


def test_sources_hold_both_kernel_files():
    assert set(_build.SOURCES) == {"int8_blockwise", "flash_attention"}
    assert {os.path.basename(p) for p in _build.SOURCES.values()} == {
        "int8_blockwise.cu", "flash_attention.cu"}


def test_library_path_keyed_by_source_hash():
    p1 = _build.library_path("int8_blockwise")
    assert p1 == _build.library_path("int8_blockwise")
    assert os.path.dirname(p1) == _build.BUILD_DIR
    assert os.path.basename(p1).startswith("int8_blockwise-")
    for src in _build.SOURCES.values():
        assert os.path.isfile(os.path.join(PKG, src))


def test_checkpoint_restores_on_template_device_without_fallback(
        monkeypatch, tmp_path):
    """A restore writes into the template's own tensors, on their device,
    with a narrower stored dtype (bf16 wire) upcast there; nothing in
    checkpoint/ asks whether CUDA is available, and a leaf on another
    device raises rather than moving."""
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
        FlashCheckpointer,
        StorageType,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        AsyncCheckpointSaver,
    )
    from dlrover_wuqiong_tpu_torch.checkpoint.engine import restore_tree
    from dlrover_wuqiong_tpu_torch.telemetry.ledger import reset_ledger

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    AsyncCheckpointSaver.reset()
    ck = FlashCheckpointer(str(tmp_path), job_name=f"ti{os.getpid()}",
                           standalone=True, wire_dtype="bf16")
    try:
        state = {"w": torch.linspace(0, 1, 16), "n": torch.tensor(3)}
        ck.save_checkpoint(1, state, StorageType.DISK)
        assert ck.wait_latest_checkpoint(30)
        template = {"w": torch.zeros(16), "n": torch.tensor(0)}
        ptrs = {k: t.data_ptr() for k, t in template.items()}
        assert ck.load_checkpoint(template) is template
        assert {k: t.data_ptr() for k, t in template.items()} == ptrs
        assert template["w"].device.type == "cpu"
        assert template["w"].dtype == torch.float32
        assert torch.equal(template["w"], state["w"].bfloat16().float())
        meta = {"w": torch.zeros(16, device="meta"), "n": torch.tensor(0)}
        with pytest.raises(ValueError, match="meta"):
            ck.save_checkpoint(2, meta, StorageType.MEMORY)
        with pytest.raises(ValueError, match="meta"):
            restore_tree(meta, {"w": state["w"].numpy(), "n": 3})
    finally:
        ck.close()
        AsyncCheckpointSaver.reset()
        reset_ledger()  # the save started it: later dumps must not see it
    assert torch.cuda.is_initialized() is False
    for f in sorted(os.listdir(os.path.join(PKG, "checkpoint"))):
        if f.endswith(".py"):
            with open(os.path.join(PKG, "checkpoint", f)) as src:
                assert "is_available" not in src.read(), f


def test_trainer_defaults_to_cuda(monkeypatch, tmp_path):
    import inspect

    from dlrover_wuqiong_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_wuqiong_tpu_torch.trainer import drill
    from dlrover_wuqiong_tpu_torch.trainer.trainer import (
        Trainer,
        TrainingArgs,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(Trainer).parameters["device"].default is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(GPT(GPTConfig.nano()), TrainingArgs(
            output_dir=str(tmp_path)), lambda step: {})
    for fn in (drill.elastic_drill, drill.node_loss_drill,
               drill.uninterrupted_losses):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


#: a worker that fails once, then succeeds: the launcher goes through
#: the restart path (persist, failure report, rendezvous, relaunch)
_FLAKY_WORKER = """
import os, sys
sys.exit(3 if os.environ["DWT_RESTART_COUNT"] == "0" else 0)
"""

_WATCH_CUDA = """
import json, sys, torch
touched = []
for name in ("is_available", "init", "_lazy_init", "device_count",
             "current_device", "set_device", "synchronize"):
    def spy(*a, _name=name, _fn=getattr(torch.cuda, name), **k):
        touched.append(_name)
        return _fn(*a, **k)
    setattr(torch.cuda, name, spy)
from dlrover_wuqiong_tpu_torch import run
rc = run.main(["--standalone", "--max_restarts=1", "--log_dir", "logs",
               sys.argv[1]])
print(json.dumps({"rc": rc, "touched": touched,
                  "initialized": torch.cuda.is_initialized()}))
"""


def test_launcher_process_never_touches_cuda(tmp_path):
    """``run --standalone`` — master, agent, checkpoint saver — through
    a failed worker and its restart, with every ``torch.cuda`` entry
    that could start a context watched."""
    worker = tmp_path / "worker.py"
    worker.write_text(_FLAKY_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DWT_MASTER_ADDR")}
    env.update(PYTHONPATH=REPO, DWT_JOB_NAME=f"tcuda-{os.getpid()}",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _WATCH_CUDA, str(worker)],
                         env=env, cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec == {"rc": 0, "touched": [], "initialized": False}
    assert "worker failed with exit code 3" in out.stderr
