#!/usr/bin/env python3
"""Where a Llama-3 8B training step's time goes as its depth grows.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 llama_depth_profile.py

Trains Llama-3 8B at its full published width (``LlamaConfig.llama3_8b()``)
with 2, 4 and 8 layers, as ``chip_smoke.py`` phase 4c does: through
``auto_accelerate(..., optimizer=adamw(3e-4))``, bf16 compute over float32
masters, remat "full", the flash route, B = 1, T = 4096, one fixed batch
of seeded tokens.  At each depth: 2 warm-up steps, 3 timed steps, peak
memory, then a profile of 3 steps (``chip_smoke.profile_steps``: device
time by kind).  Then a least-squares line ``t = fixed + per_layer * L``
for the step, each kind and the peak memory; its worst residual says
whether the depths lie on it.  From the lines: the time of each kind and
its share of the device time at the published 32 layers, which one card
cannot hold (float32 state alone is 128 GB), beside the shares measured
at 4 layers; and the depth at which the peak reaches the card's memory.
The embedding and the untied head are counted once whatever the depth,
so a cut depth gives them, the loss and their share of AdamW more weight
than the full model gives them.

Prints the card's ``nvidia-smi`` line and one JSON object; the same object
goes to ``chiprun_out/llama_depth_profile.json``.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FULL_DEPTH = 32
DEPTHS = (2, 4, 8)  # 8 layers peak at ~56 GB of the card's 80


def fit(xs, ys):
    """Least-squares ``y = a + b x``: (a, b, worst |residual|)."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    a = my - b * mx
    return a, b, max(abs(a + b * x - y) for x, y in zip(xs, ys))


def run_depth(torch, tfa, chip_smoke, layers: int) -> dict:
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models.llama import Llama, LlamaConfig
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=layers)
    res = auto_accelerate(Llama(cfg), optimizer=adamw(3e-4), seed=0)
    batch = chip_smoke.train_batch(torch, cfg.vocab_size,
                                   b=chip_smoke.LLAMA_B, t=chip_smoke.LLAMA_T)
    chip_smoke.run_steps(torch, tfa, res, batch, 2)  # cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms, launches = chip_smoke.run_steps(torch, tfa, res,
                                                       batch, 3)
    peak = torch.cuda.max_memory_allocated()
    chip_smoke.check(all(x == x and abs(x) < float("inf")
                         for x in losses + norms),
                     f"{layers} layers: non-finite loss or grad norm")
    chip_smoke.expect_launches(launches, 3, layers, 2, "split",
                               f"{layers} layers")
    prof = chip_smoke.profile_steps(
        torch, res, batch, 3, ms, f"llama_depth_profile_{layers}.txt")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": layers, "params": cfg.num_params(), "ms_per_step": ms,
            "max_memory_allocated_bytes": peak, "losses": losses,
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "device_ms_per_step_by_kind": prof["device_ms_per_step_by_kind"]}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("llama_depth_profile: torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    import chip_smoke
    from dlrover_wuqiong_tpu_torch.models.llama import LlamaConfig
    from dlrover_wuqiong_tpu_torch.ops import flash_attention as tfa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    runs = [run_depth(torch, tfa, chip_smoke, n) for n in DEPTHS]
    xs = [r["layers"] for r in runs]
    lines = {}
    series = {"ms_per_step": [r["ms_per_step"] for r in runs],
              "device_busy_ms_per_step": [r["device_busy_ms_per_step"]
                                          for r in runs],
              "max_memory_allocated_bytes": [
                  r["max_memory_allocated_bytes"] for r in runs]}
    kinds = list(runs[0]["device_ms_per_step_by_kind"])
    for k in kinds:
        series[k] = [r["device_ms_per_step_by_kind"][k] for r in runs]
    for name, ys in series.items():
        a, b, worst = fit(xs, ys)
        lines[name] = {"fixed": a, "per_layer": b, "worst_residual": worst,
                       "at_32_layers": a + b * FULL_DEPTH}
    at32 = {k: lines[k]["at_32_layers"] for k in kinds}
    busy32 = sum(at32.values())
    measured = {r["layers"]: {k: v / r["device_busy_ms_per_step"]
                              for k, v in r["device_ms_per_step_by_kind"]
                              .items()} for r in runs}
    full = LlamaConfig.llama3_8b()
    embed_head = 2 * full.vocab_size * full.hidden_size
    mem = lines["max_memory_allocated_bytes"]
    total_mem = torch.cuda.get_device_properties(0).total_memory
    out = {
        "card": card, "batch": chip_smoke.LLAMA_B,
        "seq": chip_smoke.LLAMA_T,
        "runs": runs, "lines": lines,
        "device_share_by_kind_measured": measured,
        "device_share_by_kind_at_32_layers_computed": {
            k: v / busy32 for k, v in at32.items()},
        "embed_and_head_share_of_params": {
            str(n): embed_head / dataclasses.replace(
                full, num_layers=n).num_params()
            for n in sorted(set(xs + [FULL_DEPTH]))},
        "layers_that_fit_the_card": int(
            (total_mem - mem["fixed"]) // mem["per_layer"]),
        "card_memory_bytes": total_mem}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           "llama_depth_profile.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
