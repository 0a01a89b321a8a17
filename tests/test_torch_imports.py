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
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from dlrover_wuqiong_tpu_torch import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dlrover_wuqiong_tpu_torch")
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "dlrover_wuqiong_tpu")


#: the serving worker's control plane: each keeps its own copy of what it
#: needs from the JAX package's jax-free modules
CONTROL_PLANE = ("common.serialize", "common.comm", "common.log",
                 "common.util", "common.global_context", "common.messages",
                 "telemetry.recorder", "telemetry.spans", "master.journal",
                 "master.serve_queue", "master.servicer", "master.master",
                 "agent.master_client", "serving.worker", "serving.__main__",
                 "chaos")


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
                "models.llama", "models.attention", "models.fp8", "ops.remat",
                "trainer.train_step", "auto.accelerate") + CONTROL_PLANE:
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
    for mod in CONTROL_PLANE:
        assert f"dlrover_wuqiong_tpu_torch.{mod}" in scanned


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
    assert inspect.signature(
        chaos.serve_drain).parameters["device"].default == "cuda"


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
