"""Converts a flax parameter tree into the port's tree of torch tensors.

Parity: the tree that dlrover_wuqiong_tpu/models/gpt.py:204
(`GPT.init_params`) returns, as consumed by
dlrover_wuqiong_tpu/rl/generation.py:91 (`forward_step`).

The paths stay the same (``h_<i>/attn/c_attn/kernel``, ``ln_1/scale``,
``wte/embedding``, ...) and so does every layout: a Dense kernel stays
``(in, out)``, because the int8 store quantizes the flattened row-major
kernel in 256-element blocks and a transposed kernel would quantize into
other blocks, scales and values.  The caller hands over numpy arrays
(``np.asarray`` of each jax leaf); this module imports no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    `device` (default ``cuda``), values and dtypes unchanged."""
    device = resolve_device(device)

    def rec(node):
        if isinstance(node, Mapping):
            return {k: rec(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(device)

    return rec(tree)
