"""Slot-based continuous-batching decode engine.

Parity: dlrover_wuqiong_tpu/serving/engine.py — `ServeSpec` (:67),
`_quantize_tree` (:106), `_materialize` (:139), `_sample_rows` (:163) and
`ServingEngine` (:181) with admit, decode_window, retire, free_slots and
sync_from_trainer, and the same validation errors.  `serve_step_cache_key`
and `note_train_step_served` key XLA executables; eager PyTorch has
nothing to key, so they are not ported.

The cache is a fixed ``(max_slots, max_len)`` ring of per-layer (k, v)
buffers on the device; the per-slot registers (next token, position,
active mask, sampling key, temperature) live on the host and ride into
each dispatch.  Two kinds of dispatch:

- ``admit`` prefills one prompt straight into its slot's rows of the ring
  (one `forward_step` over the ``prompt_len`` real tokens) and samples the
  first token at absolute position ``prompt_len``.  Its one host readback
  is that token (the time-to-first-token mark).
- ``decode_window`` runs ``fused_tokens`` one-token steps over all slots
  with tokens and positions kept on the device; inactive rows are frozen
  with ``torch.where``.  Its one host readback is the ``(K, S)`` token
  block.

Stale cache state (a previous tenant's kv, positions past a prompt) is
harmless by WRITE-THEN-ATTEND: a row attends position p only once its
own forward at p has overwritten p.  Every op is row-independent, so a
request's tokens are a pure function of (weights, prompt, seed), whatever
batch it shares.

Sampling noise: JAX's threefry bits cannot be reproduced in torch, so the
port draws its noise from a counter-based hash of (request key, absolute
position, vocab index) computed on the device, and samples by Gumbel-max.
That keeps the same purity property; temperature <= 0 is greedy argmax.

With ``quant="int8"`` every ≥2-D float leaf (all 50 matrices of GPT-2,
``wte`` and ``wpe`` included) is stored as blockwise int8 and
`_materialize` dequantizes it on every dispatch, as the JAX programs do,
so the dequantize kernel is on the hot path.  The int8 leaves live in one
flat store, quantized in one grouped call per engine build (and per
`sync_from_trainer`): each leaf's ``{"q", "s"}`` is a row-range view of
one (R, 256) int8 q and one (R, 1) scale, and a dispatch dequantizes all
R rows in one launch, each leaf a view of its output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.gpt import GPTConfig
from ..ops.quantization import (
    dequantize_int8_blockwise,
    fp8_dequantize,
    fp8_quantize,
    quantize_int8_blockwise_grouped,
)
from ..rl.generation import forward_step, init_caches

_QUANT_MODES = ("", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Static shape parameters of one serving engine.  ``top_k`` is
    engine-wide rather than per request."""

    max_slots: int = 4        # batch rows / concurrent requests
    max_len: int = 128        # per-slot KV length (prompt + generated)
    max_prompt_len: int = 32  # longest admissible prompt
    fused_tokens: int = 8     # K decode steps per dispatch
    quant: str = ""           # "" | "int8" | "fp8" decode weights
    top_k: int = 0            # 0 = full softmax


# ------------------------------------------------------------ quant store


#: the store's key of the flat int8 (q, scales) its int8 leaves view
_INT8_FLAT = "__int8_flat__"


def _quantize_tree(params: Dict, mode: str, device) -> Tuple[Dict, Dict]:
    """Split params into a (store, meta) pair on `device`: `store` holds the
    tensors, `meta` the dequantize recipe per leaf ((mode, size, shape), or
    None for a leaf kept as it is).  int8 leaves are quantized together
    into one flat store, kept under `_INT8_FLAT`; each leaf's q and s are
    views of its rows."""
    store: Dict = {}
    meta: Dict = {}
    int8: List = []  # (parent dict, key, tensor) of each int8 leaf

    def rec(src, dst, mdst):
        for k, v in src.items():
            if isinstance(v, dict):
                dst[k], mdst[k] = {}, {}
                rec(v, dst[k], mdst[k])
                continue
            arr = torch.as_tensor(v).to(device)
            # quantize matrices/embeddings; 1-D leaves (bias, LN) stay
            # exact — they are tiny and scale-sensitive
            if mode and arr.dim() >= 2 and arr.is_floating_point():
                if mode == "int8":
                    int8.append((dst, k, arr))
                else:
                    q, s = fp8_quantize(arr)
                    dst[k] = {"q": q, "s": s}
                mdst[k] = (mode, arr.numel(), tuple(arr.shape))
            else:
                dst[k] = arr
                mdst[k] = None

    rec(params, store, meta)
    if int8:
        arrs = [a for _, _, a in int8]
        if len({a.dtype for a in arrs}) > 1:
            # one dtype per grouped call: float32 holds every bf16 or f16
            # value exactly, and the rows are quantized in float32 anyway
            arrs = [a.float() for a in arrs]
        q, s, first = quantize_int8_blockwise_grouped(arrs)
        store[_INT8_FLAT] = (q, s)
        for (dst, k, _), r0, r1 in zip(int8, first,
                                       first[1:] + [q.shape[0]]):
            dst[k] = {"q": q[r0:r1], "s": s[r0:r1]}
    return store, meta


def _materialize(store: Dict, meta: Dict, dtype) -> Dict:
    """Dequantize the store into a forward-ready param tree; runs once per
    dispatch.  The flat int8 store is dequantized in one call, and each
    int8 leaf is a view of the result.  Unquantized ≥2-D float leaves are
    cast to `dtype` here, once per dispatch instead of at every use in
    every step; the forward casts them to `dtype` anyway, so the values
    are the same."""
    flat = None
    if _INT8_FLAT in store:
        q, s = store[_INT8_FLAT]
        flat = dequantize_int8_blockwise(q, s, q.numel(), (q.numel(),),
                                         dtype=dtype)
    return _fill(store, meta, dtype, flat)


def _fill(store: Dict, meta: Dict, dtype, flat) -> Dict:
    out: Dict = {}
    for k, m in meta.items():
        if isinstance(m, dict):
            out[k] = _fill(store[k], m, dtype, flat)
        elif m is None:
            leaf = store[k]
            if leaf.dim() >= 2 and leaf.is_floating_point():
                leaf = leaf.to(dtype)
            out[k] = leaf
        else:
            mode, size, shape = m
            leaf = store[k]
            if mode == "int8":
                # a leaf's q is a row range of the flat q: its storage
                # offset is its first value's index in `flat`
                start = leaf["q"].storage_offset()
                out[k] = flat[start:start + size].view(shape)
            else:
                out[k] = fp8_dequantize(leaf["q"], leaf["s"],
                                        dtype=dtype).reshape(shape)
    return out


def _skeleton(tree: Dict) -> Dict:
    return {k: _skeleton(v) if isinstance(v, dict) else None
            for k, v in tree.items()}


# ------------------------------------------------------------ sampling

_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit avalanche hash of values held in int64 (tensor or int); both
    multipliers are below 2**31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def _request_key(seed: int) -> int:
    """A request's 32-bit sampling key from its (up to 64-bit) seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return _mix32((seed & _M32) ^ _mix32(seed >> 32))


def _gumbel_noise(keys: torch.Tensor, positions: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """(S, vocab) float32 Gumbel noise, a pure function of each row's
    (key, absolute position) and the vocab index."""
    k = _mix32(keys ^ _mix32(positions & _M32))
    v = torch.arange(vocab, device=keys.device)
    h = _mix32(_mix32(k[:, None] ^ v[None, :]))
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))   # in (0, 1)
    return -torch.log(-torch.log(u))


def _sample_rows(logits: torch.Tensor, keys: torch.Tensor,
                 positions: torch.Tensor, temps: torch.Tensor,
                 top_k: int) -> torch.Tensor:
    """Per-row sampling: logits (S, V), keys (S,) int64 request keys,
    positions (S,) absolute positions of the tokens being sampled, temps
    (S,).  temp <= 0 means greedy.  Both branches are computed and
    selected with ``torch.where``."""
    logits = logits.float()
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    noise = _gumbel_noise(keys, positions, logits.shape[-1])
    sampled = torch.argmax(scaled + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temps > 0, sampled, greedy)


# ------------------------------------------------------------- engine


class ServingEngine:
    """Owns the KV ring (device) + slot registers (host).

    `device` defaults to ``cuda`` and raises without a GPU.  ``dispatches``
    counts admits plus decode windows.
    """

    def __init__(self, cfg: GPTConfig, params: Dict, spec: ServeSpec,
                 device=None):
        if spec.quant not in _QUANT_MODES:
            raise ValueError(f"quant mode {spec.quant!r} not in "
                             f"{_QUANT_MODES}")
        if spec.max_len > cfg.block_size:
            raise ValueError(f"max_len {spec.max_len} exceeds model "
                             f"block_size {cfg.block_size}")
        if not (0 < spec.max_prompt_len <= spec.max_len):
            raise ValueError("need 0 < max_prompt_len <= max_len")
        if spec.max_slots < 1 or spec.fused_tokens < 1:
            raise ValueError("need max_slots >= 1 and fused_tokens >= 1")
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        with torch.no_grad():
            self._store, self._meta = _quantize_tree(params, spec.quant,
                                                     self.device)
        S = spec.max_slots
        self.caches = init_caches(cfg, S, spec.max_len, device=self.device)
        # host-side slot registers
        self.tok = np.zeros(S, np.int64)
        self.pos = np.zeros(S, np.int64)
        self.active = np.zeros(S, bool)
        self.keys = np.zeros(S, np.int64)
        self.temps = np.ones(S, np.float32)
        self.dispatches = 0

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    # ------------------------------------------------------------- host API

    def free_slots(self) -> List[int]:
        return [i for i in range(self.spec.max_slots)
                if not self.active[i]]

    @torch.no_grad()
    def admit(self, slot: int, prompt: List[int], seed: int,
              temperature: float = 1.0, max_new_tokens: int = 0) -> int:
        """Admit a request into a free slot; returns its FIRST generated
        token (the one readback of an admit, and the TTFT mark)."""
        cfg, spec = self.cfg, self.spec
        plen = len(prompt)
        if not (0 < plen <= spec.max_prompt_len):
            raise ValueError(f"prompt length {plen} not in "
                             f"(0, {spec.max_prompt_len}]")
        if plen + max(1, max_new_tokens) > spec.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len {spec.max_len}")
        if self.active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        key = _request_key(seed)
        params = _materialize(self._store, self._meta, cfg.dtype)
        token = self._on_device(np.asarray(prompt, np.int64))[None]
        # the slot's rows of the ring, as views: the prefill writes in place
        rows = [(k[slot:slot + 1], v[slot:slot + 1]) for k, v in self.caches]
        logits, _ = forward_step(cfg, params, token, rows, 0)
        # the token at absolute position t is sampled with position t: the
        # first generated token sits at prompt_len
        first = _sample_rows(
            logits, self._on_device(np.array([key], np.int64)),
            self._on_device(np.array([plen], np.int64)),
            self._on_device(np.array([temperature], np.float32)),
            spec.top_k)
        first_tok = int(first[0])  # boundary readback (TTFT mark)
        self.dispatches += 1
        self.tok[slot] = first_tok
        self.pos[slot] = plen
        self.active[slot] = True
        self.keys[slot] = key
        self.temps[slot] = temperature
        return first_tok

    def retire(self, slot: int):
        """Free a slot — host write only; the row freezes on the next
        dispatch and the next tenant overwrites its cache."""
        self.active[slot] = False

    @torch.no_grad()
    def decode_window(self) -> np.ndarray:
        """One K-token dispatch over all slots.

        Returns the (K, S) token block — the single host readback of the
        window; rows of inactive slots are garbage and must be masked by
        the caller's slot bookkeeping.
        """
        cfg, spec = self.cfg, self.spec
        params = _materialize(self._store, self._meta, cfg.dtype)
        tok = self._on_device(self.tok)
        pos = self._on_device(self.pos)
        active = self._on_device(self.active)
        keys = self._on_device(self.keys)
        temps = self._on_device(self.temps)
        last = spec.max_len - 1
        steps = []
        for _ in range(spec.fused_tokens):
            pos_s = pos.clamp_max(last)
            logits, _ = forward_step(cfg, params, tok[:, None], self.caches,
                                     pos_s)
            nxt = pos_s + 1
            sampled = _sample_rows(logits, keys, nxt, temps, spec.top_k)
            # frozen slots: pos/tok do not advance
            tok = torch.where(active, sampled, tok)
            pos = torch.where(active, nxt, pos)
            steps.append(sampled)
        out = torch.stack(steps).cpu().numpy()  # the ONE readback per window
        self.dispatches += 1
        k = spec.fused_tokens
        act = self.active
        if act.any():
            self.tok[act] = out[-1, act]
            self.pos[act] += k
        return out

    def sync_from_trainer(self, params: Dict):
        """Weight refresh from a live trainer.  In-flight requests keep
        their caches and continue under the new weights."""
        with torch.no_grad():
            store, meta = _quantize_tree(params, self.spec.quant,
                                         self.device)
        if (_skeleton(store), meta) != (_skeleton(self._store), self._meta):
            raise ValueError("refreshed params have a different tree "
                             "structure — build a new engine")
        self._store = store
