"""muP — maximal-update parametrization for width-transferable HPs.

Parity: dlrover_wuqiong_tpu/optimizers/mup.py — `classify_param` (:45),
`width_mults` (:57), `mup_init` (:87), the lr table `_lr_factor` (:103),
`mup_adam` (:134), `mup_sgd` (:144) and `mup_attn_scale` (:150).

A parameter's path is its flax path, "/"-joined (``h_0/attn/c_attn/
kernel``): the port's module names with "." read as "/".  Base shapes
come from a small "base" model; each parameter gets a width multiplier
and a role (input / hidden / output / finite):

- `mup_init` divides the initial hidden and output weights by
  sqrt(mult), in place;
- `mup_adam` / `mup_sgd` give each parameter the lr of the μP table as
  its param group's lr (Adam: hidden and output lr / mult; SGD: input
  lr * mult, output lr / mult).  That is optax's ``chain(adamw,
  scale_by_mup)``: torch's decoupled decay scales with the group's lr
  too, as optax's factor scales the decayed update;
- attention uses 1/d scores instead of 1/sqrt(d) (`mup_attn_scale`).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import torch

_INPUT_RE = re.compile(
    r".*(wte|wpe|embed|embedding|input_proj)", re.IGNORECASE)
_OUTPUT_RE = re.compile(r".*(lm_head|output|head)/", re.IGNORECASE)


def classify_param(path: str, base_shape: Tuple[int, ...],
                   shape: Tuple[int, ...]) -> str:
    """'input' | 'hidden' | 'output' | 'finite' (μP Table 8 roles)."""
    grown = [i for i, (b, s) in enumerate(zip(base_shape, shape)) if b != s]
    if not grown or len(shape) < 2:
        return "finite"  # biases, norms, scalars: width-independent
    if _INPUT_RE.match(path):
        return "input"
    if _OUTPUT_RE.match(path):
        return "output"
    return "hidden"


def _shapes(model: Any) -> "OrderedDict[str, Tuple[int, ...]]":
    """{flax path: shape} of a module's parameters, in its order, or of
    a nested dict of arrays (flax's sorted order)."""
    if isinstance(model, torch.nn.Module):
        return OrderedDict((n.replace(".", "/"), tuple(p.shape))
                           for n, p in model.named_parameters())
    out: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        else:
            out["/".join(path)] = tuple(node.shape)

    walk(model, [])
    return out


def width_mults(base: Any, model: Any) -> "OrderedDict[str, Dict]":
    """{flax path: {"mult", "role"}} in `model`'s parameter order: mult is
    the fan-in growth against `base` (modules or nested dicts of
    arrays); the "infinite" dims are the ones that differ."""
    sb, st = _shapes(base), _shapes(model)
    if len(sb) != len(st):
        raise ValueError("base and target models differ in structure")
    info: "OrderedDict[str, Dict]" = OrderedDict()
    for (_, bs), (path, ts) in zip(sb.items(), st.items()):
        role = classify_param(path, bs, ts)
        if len(ts) >= 2 and role != "finite":
            # fan_in is the second-to-last dim for kernels (in, out);
            # embeddings (vocab, emb) take the feature dim as the width
            fan_idx = len(ts) - 2 if role != "input" else len(ts) - 1
            mult = ts[fan_idx] / max(1, bs[fan_idx])
        else:
            mult = 1.0
        info[path] = {"mult": float(mult), "role": role}
    return info


@torch.no_grad()
def mup_init(model: torch.nn.Module, mults: Dict[str, Dict]
             ) -> torch.nn.Module:
    """Rescale `model`'s initial weights in place per μP: hidden and
    output weights / sqrt(mult) (the root taken in float32, in the
    weight's dtype, as jnp does).  Returns `model`."""
    for name, p in model.named_parameters():
        m = mults[name.replace(".", "/")]
        if m["role"] in ("hidden", "output") and m["mult"] != 1.0:
            root = torch.sqrt(torch.tensor(m["mult"], dtype=torch.float32))
            p.div_(root.to(device=p.device, dtype=p.dtype))
    return model


def lr_factor(role: str, mult: float, adam: bool) -> float:
    if mult == 1.0 or role == "finite":
        return 1.0
    if adam:
        # μP Table 8 (Adam): hidden & output lr ∝ 1/mult; input const
        return 1.0 / mult if role in ("hidden", "output") else 1.0
    # SGD: input ∝ mult, hidden const, output ∝ 1/mult
    if role == "input":
        return mult
    if role == "output":
        return 1.0 / mult
    return 1.0


def lr_table(mults: Dict[str, Dict], adam: bool = True) -> Dict[str, float]:
    """{flax path: its lr factor}."""
    return OrderedDict((k, lr_factor(m["role"], m["mult"], adam))
                       for k, m in mults.items())


def _groups(params, mults: Dict[str, Dict], lr: float, adam: bool):
    """One param group per lr factor, in the parameters' order."""
    params = list(params)
    if len(params) != len(mults):
        raise ValueError(f"{len(params)} parameters, {len(mults)} mults: "
                         f"the mults come from width_mults(base, model)")
    groups: "OrderedDict[float, list]" = OrderedDict()
    for p, f in zip(params, lr_table(mults, adam).values()):
        groups.setdefault(f, []).append(p)
    return [{"params": ps, "lr": lr * f} for f, ps in groups.items()]


def mup_adam(learning_rate: float, mults: Dict[str, Dict], b1: float = 0.9,
             b2: float = 0.999, eps: float = 1e-8,
             weight_decay: float = 0.0):
    """MuAdam: a factory ``params -> torch.optim.AdamW`` (Adam when
    weight_decay is 0, as JAX chains optax.adam) with the μP lr of each
    parameter; `params` in the order of `mults`."""
    def make(params):
        groups = _groups(params, mults, learning_rate, adam=True)
        if weight_decay:
            opt = torch.optim.AdamW(groups, betas=(b1, b2), eps=eps,
                                    weight_decay=weight_decay)
        else:
            opt = torch.optim.Adam(groups, betas=(b1, b2), eps=eps)
        # the checkpoint tree: chain(adam(w), scale_by_mup) puts the Adam
        # node at opt_state/0/0
        opt.optax_state = lambda adam: ((adam,),)
        return opt
    return make


def mup_sgd(learning_rate: float, mults: Dict[str, Dict],
            momentum: Optional[float] = None):
    """MuSGD: a factory ``params -> torch.optim.SGD`` with the μP lr of
    each parameter."""
    def make(params):
        return torch.optim.SGD(_groups(params, mults, learning_rate,
                                       adam=False),
                               momentum=momentum or 0.0)
    return make


def mup_attn_scale(head_dim: int) -> float:
    """μP attention: 1/d scores instead of 1/sqrt(d)."""
    return 1.0 / head_dim
