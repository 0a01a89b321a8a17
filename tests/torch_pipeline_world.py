"""Rank functions of the pipeline-parallel tests (tests/test_torch_pipeline*.py):
each runs in a gloo world of `torch_world.run_world` and imports no JAX.

A case is ``(key, family, overrides, strategy, steps, accum[,
kwargs])``: a nano model in float32 with config `overrides`, built by
the port's `auto_accelerate` over `strategy` (and `kwargs`) with
``adamw(1e-2)``, `accum` outer microbatches a step, loaded with JAX's initial
pipelined tree through `convert.load_pipelined`.  Each rank returns,
for every case: the logits of one forward on its rows (and their global
row and column indices), the loss and every leaf's gradient of one
`value_and_grad_fn` call (the global mean, after
`MeshState.reduce_grads`), the names and index ranges of its state
(`PipelinedLM.state_layout`), then the metrics of `steps` train steps and
the final leaves.  Gradients and leaves are gathered over the stage's
other dims, keyed by the inner model's names.
"""

import os
import pickle
import time

import numpy as np
import torch

import torch_world as tw


def batches(steps: int, accum: int = 1):
    """`torch_world.host_batches`, with a leading axis of `accum` outer
    microbatches when accum > 1."""
    out = tw.host_batches(steps)
    if accum == 1:
        return out
    return [{k: v.reshape(accum, -1, *v.shape[1:]) for k, v in b.items()}
            for b in out]


def _full(t):
    from dlrover_wuqiong_tpu_torch.parallel.fsdp import is_dtensor

    t = t.full_tensor() if is_dtensor(t) else t
    return t.detach().float().numpy().copy()


def build(family, overrides, strategy, init=None, **kw):
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.convert import load_pipelined

    res = auto_accelerate(tw.port_model(family, **(overrides or {})),
                          optimizer=tw.port_optimizer("adamw"),
                          device="cpu", seed=0,
                          strategy=list(strategy)
                          + [("half", {"enabled": False})], **kw)
    if init is not None:
        load_pipelined(res.model, init)
    return res


def one_case(res, steps: int, accum: int):
    from dlrover_wuqiong_tpu_torch.parallel.pipeline import PipelinedLM

    model = res.model
    b = tw.host_batches(1)[0]
    B, T = b["input_ids"].shape
    rows = np.repeat(np.arange(B)[:, None], T, 1)
    cols = np.repeat(np.arange(T)[None, :], B, 0)
    placed = res.place_batch({"input_ids": b["input_ids"], "rows": rows,
                              "cols": cols}, batch_axis=0)
    with torch.no_grad():
        logits = model(placed["input_ids"])
    logits = _full(logits)
    out = {"logits": logits, "rows": placed["rows"].numpy(),
           "cols": placed["cols"].numpy(),
           "stage": model.stage if isinstance(model, PipelinedLM) else 0,
           "layout": model.state_layout()
           if isinstance(model, PipelinedLM) else None}
    # one gradient of the step's own value_and_grad, reduced as the step
    # reduces it
    mesh = res.state.mesh_state
    res.state.opt_state.zero_grad(set_to_none=True)
    first = batches(1, accum)[0]
    placed = res.place_batch(first)
    if accum == 1:
        loss = res.value_and_grad_fn(model, placed)
    else:
        loss = sum(res.value_and_grad_fn(model, {k: v[i] for k, v in
                                                 placed.items()})
                   for i in range(accum)) / accum
    mesh.reduce_grads()
    out["loss"] = float(mesh.mean(loss))
    grads = {}
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[n] = _full(g) / (accum if accum > 1 else 1)
    out["grads"] = grads
    res.state.opt_state.zero_grad(set_to_none=True)
    metrics = []
    for bt in batches(steps, accum):
        res.state, m = res.train_step(res.state, res.place_batch(bt))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    out["metrics"] = metrics
    out["params"] = {n: _full(p) for n, p in model.named_parameters()} \
        if steps else {}
    return out


def exported_rows_equal(model, init) -> bool:
    """Does `convert.export_pipelined` of the stage give `init`'s leaves,
    its rows of the stacked blocks (None without an init)?"""
    from dlrover_wuqiong_tpu_torch.convert import _flatten, export_pipelined

    if init is None:
        return None
    got = _flatten(export_pipelined(model))
    want = _flatten(init)
    lo, hi = model.stage_rows()
    return sorted(got) == sorted(want) and all(
        np.array_equal(got[n].numpy(), want[n][lo:hi] if
                       n.startswith("blocks.") else want[n]) for n in want)


def write_inits(path: str, inits) -> None:
    """Hand `inits` to a world waiting in `pipeline_cases` (written whole,
    then renamed into place)."""
    with open(path + ".part", "wb") as f:
        pickle.dump(inits, f)
    os.replace(path + ".part", path)


def _await_inits(path: str, deadline_s: float = tw.WORLD_DEADLINE_S):
    end = time.monotonic() + deadline_s
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"no initial trees at {path}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def pipeline_cases(rank, world, cases, inits, refusals=None):
    """Every case of `cases` on this rank (module docstring), then the
    messages of `refusals` ({key: (family, overrides, strategy,
    auto_accelerate kwargs)}).  `inits` is {key: JAX's initial tree}, or
    the path `write_inits` fills once JAX has built the cases (the world
    starts and imports the port meanwhile)."""
    if isinstance(inits, str):
        import dlrover_wuqiong_tpu_torch.auto.accelerate  # noqa: F401
        import dlrover_wuqiong_tpu_torch.parallel.pipeline  # noqa: F401

        inits = _await_inits(inits)
    out = {}
    for case in cases:
        key, family, overrides, strategy, steps, accum = case[:6]
        kw = case[6] if len(case) > 6 else {}
        res = build(family, overrides, strategy, inits.get(key), **kw)
        exported = exported_rows_equal(res.model, inits.get(key))
        out[key] = one_case(res, steps, accum)
        out[key]["export_equal"] = exported
        out[key]["plan"] = res.strategy.plan.describe()
    out["refusals"] = {}
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate

    for key, (family, overrides, strategy, kw) in (refusals or {}).items():
        try:
            auto_accelerate(tw.port_model(family, **overrides), device="cpu",
                            strategy=strategy, **kw)
        except (ValueError, NotImplementedError) as e:
            out["refusals"][key] = f"{type(e).__name__}: {e}"
        else:
            out["refusals"][key] = None
    return out


def zero_loss(params, batch):
    """A whole-batch loss_fn (what 1F1B refuses)."""
    return 0.0


SMOOTHING = 0.1


def _smoothed_ce(logits, labels):
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    uniform = -logp.mean(-1)
    return ((1 - SMOOTHING) * nll + SMOOTHING * uniform).mean()


def smoothed_head_loss(hp, h, labels):
    """GPT's label-smoothed head loss for one microbatch (1F1B's
    ``head_loss``; tests/test_pipeline.py:720's)."""
    x = hp["ln_f"](h)
    return _smoothed_ce(x @ hp["wte"].embedding.to(x.dtype).t(), labels)


def smoothed_loss(model, batch):
    """The same loss over the whole batch (gpipe's ``loss_fn``)."""
    return _smoothed_ce(model(batch["input_ids"]), batch["labels"])


# ------------------------------------------------------------ hybrid engine


def hybrid_world(rank, world, params, prompts, batch, decode_tp):
    """`rl.hybrid.HybridEngine` over the world (fsdp -> tp x dp): this
    rank's local piece of every leaf after `place_train` and after two
    `sync_to_decode` calls (the second's wall time and bytes), of the
    prompts and of the train batch; the message of a decode_tp of 3."""
    from dlrover_wuqiong_tpu_torch.convert import _flatten
    from dlrover_wuqiong_tpu_torch.rl.hybrid import HybridEngine

    eng = HybridEngine(decode_tp=decode_tp, device="cpu")
    train = eng.place_train(params)
    dec = eng.sync_to_decode(train)
    again = eng.sync_to_decode(train)

    def pieces(tree):
        return {n: t.to_local().numpy().copy()
                for n, t in _flatten(tree).items()}

    same = all(np.array_equal(a, b) for a, b in
               zip(pieces(dec).values(), pieces(again).values()))
    return {"train": pieces(train), "decode": pieces(dec), "same": same,
            "sync_s": eng.last_sync_s, "bytes": eng.last_sync_bytes,
            "prompts": eng.place_prompts(prompts).to_local().numpy(),
            "batch": eng.place_batch_train(batch).to_local().numpy(),
            "train_shape": dict(zip(eng.train_mesh.mesh_dim_names,
                                    eng.train_mesh.shape)),
            "decode_shape": dict(zip(eng.decode_mesh.mesh_dim_names,
                                     eng.decode_mesh.shape)),
            "refusal": _refusal(HybridEngine, decode_tp=3, device="cpu")}


def _refusal(fn, **kw) -> str:
    try:
        fn(**kw)
    except ValueError as e:
        return str(e)
    return ""
