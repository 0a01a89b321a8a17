"""Converts parameters between a flax tree, the port's tensor tree and a model.

Parity: the trees that dlrover_wuqiong_tpu/models/gpt.py:204
(`GPT.init_params`) and dlrover_wuqiong_tpu/models/llama.py:208
(`Llama.init_params`) return; GPT's as consumed by
dlrover_wuqiong_tpu/rl/generation.py:91 (`forward_step`) and by the
serving engine's ``sync_from_trainer``
(dlrover_wuqiong_tpu/serving/engine.py).

- `params_from_jax`: a flax tree of numpy arrays -> the same nested dict of
  tensors (the serving engine's input).
- `load_params`: such a tree (numpy arrays or tensors) -> the parameters
  of a port model (``models.gpt.GPT``, ``models.llama.Llama``), matched by
  path (``h_0/attn/c_attn/kernel`` is the parameter
  ``h_0.attn.c_attn.kernel``, ``layers_0/attention/q_proj/kernel`` the
  parameter ``layers_0.attention.q_proj.kernel``).
- `export_params`: a model's parameters -> the nested dict (for GPT, the
  one ``ServingEngine.sync_from_trainer`` takes), as detached copies.
- `load_pipelined` / `export_pipelined`: JAX's ``PipelinedLM`` layout
  (dlrover_wuqiong_tpu/parallel/pipeline.py:573-587, ``{non-layer...,
  "blocks": stacked}``) into and out of one pipeline stage
  (`parallel.pipeline.PipelinedLM`).

The paths stay the same (``h_<i>/attn/c_attn/kernel``, ``ln_1/scale``,
``wte/embedding``, ``embed_tokens/embedding``, ...) and so does every
layout: a Dense kernel stays ``(in, out)``, because the int8 store
quantizes the flattened row-major kernel in 256-element blocks and a
transposed kernel would quantize into other blocks, scales and values.
The caller hands over numpy arrays (``np.asarray`` of each jax leaf); this
module imports no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    `device` (default ``cuda``), values and dtypes unchanged."""
    device = resolve_device(device)

    def rec(node):
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(device)

    return rec(tree)


@torch.no_grad()
def load_params(model: torch.nn.Module, tree: Mapping, device=None):
    """Put every parameter of `model` on `device` (default ``cuda``) with the
    value of the same path in `tree`; returns `model`.  The tree must hold
    exactly the model's parameters, with the same shapes."""
    device = resolve_device(device)
    flat = _flatten(tree)
    names = dict(model.named_parameters())
    if set(flat) != set(names):
        raise ValueError(
            f"parameter tree does not match the model: missing "
            f"{sorted(set(names) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(names))}")
    srcs = {}
    for name, p in names.items():
        src = flat[name]
        if not torch.is_tensor(src):
            src = torch.from_numpy(np.array(src, copy=True))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(p.shape)}")
        srcs[name] = src
    model.to_empty(device=device)
    for name, p in model.named_parameters():
        p.copy_(srcs[name])
    return model


@torch.no_grad()
def export_params(model: torch.nn.Module) -> Dict[str, Any]:
    """`model`'s parameters as a nested flax-layout dict of detached
    copies (a live trainer keeps updating its own tensors in place)."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().clone()
    return tree


@torch.no_grad()
def load_pipelined(stage: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """A JAX ``PipelinedLM`` tree (``{non-layer..., "blocks": stacked}``,
    the stacked axis in the stage's ``_order``) into a materialized
    `parallel.pipeline.PipelinedLM` stage: each parameter of the stage
    (a DTensor's local piece) gets its value.  Returns `stage`."""
    from .parallel.fsdp import is_dtensor, local_piece

    flat = _flatten(stage.to_flat_params(dict(tree)))
    for name, p in stage.named_parameters():
        src = flat[name]
        if not torch.is_tensor(src):
            src = torch.from_numpy(np.array(src, copy=True))
        dst = p.to_local() if is_dtensor(p) else p
        dst.copy_(local_piece(p, src.to(dst.device, dst.dtype)))
    return stage


@torch.no_grad()
def export_pipelined(stage: torch.nn.Module) -> Dict[str, Any]:
    """A `parallel.pipeline.PipelinedLM` stage's parameters in JAX's
    pipelined layout: the non-layer leaves and ``blocks`` stacked over
    this stage's rows (`PipelinedLM.stage_rows`), detached copies; a
    sharded leaf is gathered (a collective: every rank calls it)."""
    from .parallel.fsdp import is_dtensor
    from .parallel.pipeline import stack_layer_params
    from .trainer.train_step import nest

    tree = nest({n: (p.full_tensor() if is_dtensor(p) else p).detach()
                 .clone() for n, p in stage.named_parameters()})
    blocks = [tree.pop(f"{stage._prefix}_{i}") for i in stage.stage_layers]
    tree["blocks"] = stack_layer_params(blocks)
    return tree
