"""Gloo worlds of CPU processes for the port's mesh tests.

`run_world(n, fn, *args)` spawns `n` processes, joins them into a
``torch.distributed`` world over gloo (its store a file in the world's
temporary directory: no port to race for), runs ``fn(rank, n, *args)`` on
every rank and returns the ranks' results in rank order.  A rank that
raises ends the world and the call re-raises its traceback; a world that
has not finished by its deadline is killed and the call raises.  Every
rank imports this module and `fn`'s, so neither may import JAX: the JAX
side of a comparison runs in the test process.
"""

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a world may take before its ranks are killed
WORLD_DEADLINE_S = 600


def _entry(rank, world, store_path, outdir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(world: int, fn, *args, deadline_s: float = WORLD_DEADLINE_S):
    """[fn(rank, world, *args) for each rank], run in a gloo world that
    must end within `deadline_s`."""
    with tempfile.TemporaryDirectory() as outdir:
        ctx = mp.spawn(_entry, args=(world, os.path.join(outdir, "store"),
                                     outdir, fn, args),
                       nprocs=world, join=False)
        end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=max(0.0, end - time.monotonic())):
                if time.monotonic() >= end:
                    raise TimeoutError(
                        f"a gloo world of {world} running {fn.__name__} "
                        f"did not end within {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


# ------------------------------------------------------- training cases

VOCAB, SEQ, BATCH, STEPS = 512, 32, 8, 4


def host_batches(steps: int = STEPS, seed: int = 0):
    """The global batches every build trains on (numpy, a fixed seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        x = rng.integers(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": x[:, :-1], "labels": x[:, 1:]})
    return out


def port_model(family: str, **overrides):
    """A nano model in float32, its config fields `overrides` replaced."""
    import dataclasses

    from dlrover_wuqiong_tpu_torch.models import gpt, llama

    if family == "gpt":
        return gpt.GPT(dataclasses.replace(gpt.GPTConfig.nano(),
                                           dtype=torch.float32, **overrides))
    return llama.Llama(dataclasses.replace(llama.LlamaConfig.nano(),
                                           dtype=torch.float32, **overrides))


def port_optimizer(name: str, lr: float = None):
    """The port's optimizer `name` at `lr` (default: adamw 1e-2,
    adamw8bit 1e-3, clip: the Trainer's clipped AdamW at a constant
    1e-2)."""
    from dlrover_wuqiong_tpu_torch.optimizers import adamw8bit
    from dlrover_wuqiong_tpu_torch.trainer.train_step import (
        adamw,
        clip_adamw,
    )

    if name == "adamw":
        return adamw(lr or 1e-2)
    if name == "adam":  # optax.adam: AdamW without decay
        return adamw(lr or 1e-2, weight_decay=0.0)
    if name == "adamw8bit":
        return adamw8bit(lr or 1e-3)
    rate = lr or 1e-2
    assert name == "clip", name
    return clip_adamw(lambda count: rate, 1e-4)


def plant(state, fault: str, rank: int) -> None:
    """A planted fault in a sharded build (a bound that passes a sound
    build must refuse it): ``skip_last``, rank 3 leaves its pieces
    unstepped at the last step; ``no_compensation``, stable_bf16's Kahan
    compensation zeroed after every step; ``local_norm``, the clip reads
    the norm of the rank's own pieces."""
    opt = state.opt_state
    if fault == "skip_last":
        if rank == 3:
            step, calls = opt.step, [0]

            def skipping(*a, **k):
                calls[0] += 1
                return None if calls[0] == STEPS else step(*a, **k)
            opt.step = skipping
    elif fault == "no_compensation":
        kahan = opt.inner
        step = kahan.step

        def dropping(*a, **k):
            out = step(*a, **k)
            for c in kahan.comp:
                c.zero_()
            return out
        kahan.step = dropping
    else:
        assert fault == "local_norm", fault
        opt.norm_fn = None


def train(family, strategy, opt="adamw", init=None, steps=STEPS,
          device="cpu", materialize=True, lr=None, fault=None, rank=0,
          overrides=None):
    """`auto_accelerate` of a nano model in float32 (``half`` off, config
    `overrides`) over `strategy`, `init` (a flat global state) loaded
    through `load_tree`, then `steps` steps on `host_batches`: (result,
    [(loss, grad_norm)]).  `fault` plants one of `plant`'s faults."""
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate

    res = auto_accelerate(port_model(family, **(overrides or {})),
                          optimizer=port_optimizer(opt, lr),
                          device=device, seed=0, materialize=materialize,
                          strategy=list(strategy)
                          + [("half", {"enabled": False})])
    if init is not None:
        res.state.load_tree(init)
    if fault is not None:
        plant(res.state, fault, rank)
    metrics = []
    for b in host_batches(steps):
        res.state, m = res.train_step(res.state, res.place_batch(b))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return res, metrics


def full_params(model):
    """{dotted name: the global value as numpy} (a DTensor gathered)."""
    from dlrover_wuqiong_tpu_torch.parallel.fsdp import is_dtensor

    out = {}
    for n, p in model.named_parameters():
        t = p.full_tensor() if is_dtensor(p) else p
        out[n] = t.detach().float().numpy().copy()
    return out


def aux_loss(model) -> float:
    """The MoE aux loss of the model's last forward (0 without experts)."""
    from dlrover_wuqiong_tpu_torch.models.moe import collect_moe_aux_loss

    return float(collect_moe_aux_loss(getattr(model, "intermediates", {})))


def parity_cases(rank, world, cases, inits, overrides=None):
    """Each case (key, family, strategy, opt, lr), its model config
    `overrides[key]` if any: the metrics on every rank and the final
    global parameters on rank 0."""
    out = {}
    for key, family, strategy, opt, lr in cases:
        res, metrics = train(family, strategy, opt, inits.get(key), lr=lr,
                             overrides=(overrides or {}).get(key))
        params = full_params(res.model)
        out[key] = {"metrics": metrics,
                    "params": params if rank == 0 else None,
                    "plan": res.strategy.plan.describe()}
    return out


def construction_checks(rank, world):
    """GPT nano under fsdp 4 from the port's seeded init: the rank's
    bytes, the moments' placements, its initial pieces against the
    unsharded init, and the materialize=False build's local shapes."""
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate
    from dlrover_wuqiong_tpu_torch.models import gpt
    from dlrover_wuqiong_tpu_torch.parallel.fsdp import (
        is_dtensor,
        local_piece,
        state_bytes,
    )
    from dlrover_wuqiong_tpu_torch.trainer.train_step import adamw

    strategy = [("fsdp", {}), ("half", {"enabled": False})]
    res = auto_accelerate(port_model("gpt"), optimizer=adamw(1e-2),
                          device="cpu", seed=0, strategy=strategy)
    full = dict(gpt.init_leaves(res.model.config, 0, "cpu"))
    params = dict(res.model.named_parameters())
    bitwise = all(torch.equal(
        p.to_local() if is_dtensor(p) else p.detach(),
        local_piece(p, full[n])) for n, p in params.items())
    opt = res.state.opt_state
    moments = [t for p in params.values() for k, t in opt.state[p].items()
               if k != "step"]
    placements_kept = all(
        tuple(opt.state[p][k].placements) == tuple(p.placements)
        for p in params.values() if is_dtensor(p)
        for k in ("exp_avg", "exp_avg_sq"))
    total = sum(3 * t.numel() * 4 for t in full.values())
    mine = state_bytes(list(params.values()) + moments)
    lazy = auto_accelerate(port_model("gpt"), optimizer=adamw(1e-2),
                           device="cpu", seed=0, strategy=strategy,
                           materialize=False)
    lazy_params = dict(lazy.model.named_parameters())
    lazy_opt = lazy.state.opt_state
    lazy_moments = [t for p in lazy_params.values()
                    for k, t in lazy_opt.state[p].items() if k != "step"]

    def local(t):
        return t.to_local() if is_dtensor(t) else t

    return {
        "bitwise_init": bitwise,
        "placements_kept": placements_kept,
        "n_sharded": sum(is_dtensor(p) for p in params.values()),
        "fraction": mine / total,
        "lazy_meta": all(local(t).is_meta for t in
                         list(lazy_params.values()) + lazy_moments),
        "lazy_shapes": {n: tuple(local(p).shape)
                        for n, p in lazy_params.items()},
        "shapes": {n: tuple(local(p).shape) for n, p in params.items()},
        "lazy_bytes": state_bytes(list(lazy_params.values())
                                  + lazy_moments),
        "bytes": mine,
    }


def parallel_module(rank, world, cases, inits):
    """The world-side cases of tests/test_torch_parallel_training.py."""
    return {"parity": parity_cases(rank, world, cases, inits),
            "construction": construction_checks(rank, world)}


FSDP, BF16, OFFLOAD = (("fsdp", {}), ("stable_bf16", {}),
                       ("optimizer_offload", {}))

#: key -> (strategy, optimizer, planted fault or None)
OPTIMIZER_CASES = {
    "adamw8bit": ([FSDP], "adamw8bit", None),
    "adamw8bit_skip_last": ([FSDP], "adamw8bit", "skip_last"),
    "stable_bf16": ([FSDP, BF16], "adamw", None),
    "stable_bf16_skip_last": ([FSDP, BF16], "adamw", "skip_last"),
    "stable_bf16_no_compensation": ([FSDP, BF16], "adamw",
                                    "no_compensation"),
    "adamw": ([FSDP], "adamw", None),
    "offload": ([FSDP, OFFLOAD], "adamw", None),
    "clip": ([FSDP], "clip", None),
    "clip_offload": ([FSDP, OFFLOAD], "clip", None),
    "clip_offload_local_norm": ([FSDP, OFFLOAD], "clip", "local_norm"),
    "clip_stable_bf16": ([FSDP, BF16], "clip", None),
    "clip_stable_bf16_local_norm": ([FSDP, BF16], "clip", "local_norm"),
}


def optimizer_cases(rank, world):
    """Every `OPTIMIZER_CASES` build of GPT nano from the port's seeded
    init: the metrics, and on rank 0 the global parameters."""
    out = {}
    for key, (strategy, opt, fault) in OPTIMIZER_CASES.items():
        res, metrics = train("gpt", strategy, opt, fault=fault, rank=rank)
        params = full_params(res.model)  # a collective: every rank
        out[key] = {"metrics": metrics,
                    "params": params if rank == 0 else None}
        if key == "offload":
            opt = res.state.opt_state
            out[key]["host_state"] = all(
                v.device.type == "cpu" and not hasattr(v, "placements")
                and v.shape == q.shape for q in opt.proxies
                for k, v in opt.inner.state[q].items() if k != "step")
    return out


# ----------------------------------------------------------- comparisons


def split_key_bias(params):
    """(params with GPT's key bias taken out of each ``c_attn.bias``,
    {name: the key bias}).  Its gradient is zero in exact arithmetic (a
    key bias adds the same q.b to a query's every score, and softmax
    ignores that), so each build's Adam moves it by rounding noise, up
    to lr a step."""
    import numpy as np

    out, keys = dict(params), {}
    for n, v in params.items():
        if n.endswith("c_attn.bias"):
            q, k, v_ = np.split(v, 3)
            out[n] = np.concatenate([q, v_])
            keys[n] = k
    return out, keys


def leaf_spread(got, want):
    """The worst leaf's relative L2 distance (key bias apart):
    (distance, name)."""
    import numpy as np

    (got, _), (want, _) = split_key_bias(got), split_key_bias(want)
    return max((float(np.linalg.norm(got[n] - want[n])
                      / np.linalg.norm(want[n])), n) for n in want)


def off_share(got, want, lr, bf16=False):
    """The worst leaf's share of entries (key bias apart) that sit more
    than half an lr step, or 1.5 ulps of the parameter's dtype, away
    from `want`: (share, name).  A sound build moves a few entries so
    (a gradient at rounding size); a rank that skips an update moves a
    quarter of a sharded leaf."""
    import numpy as np

    (got, _), (want, _) = split_key_bias(got), split_key_bias(want)
    out = []
    for n, w in want.items():
        ulp = np.spacing(np.abs(w).astype(np.float32))
        if bf16:
            ulp = ulp * 2.0 ** 16  # 7 mantissa bits, not 23
        limit = np.maximum(lr / 2, 1.5 * ulp)
        out.append((float(np.mean(np.abs(got[n] - w) > limit)), n))
    return max(out)


# ---------------------------------------------------- checkpoint cases


def checkpointer(ckdir, job, rank, world):
    """A rank's `FlashCheckpointer`: its own saver (job ``<job>-r<rank>``,
    node ``rank``), committed once all `world` ranks' shards landed."""
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import (
        FlashCheckpointer,
    )

    return FlashCheckpointer(ckdir, job_name=f"{job}-r{rank}",
                             node_rank=rank, world_shard_num=world)


def leaf_refs(tree):
    """[(name, global shape, index)] this rank writes of `tree`."""
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        _leaf_refs,
        flatten_state_dict,
    )

    return [(e, tuple(g), tuple(tuple(i) for i in idx))
            for name, leaf in flatten_state_dict(tree).items()
            for e, _, g, idx in _leaf_refs(name, leaf)]


def restored_global(res):
    """{checkpoint name: global numpy value} of a state's params and
    AdamW moments (DTensors gathered: a collective on every rank)."""
    from dlrover_wuqiong_tpu_torch.parallel.fsdp import is_dtensor

    names = {id(p): n.replace(".", "/")
             for n, p in res.model.named_parameters()}
    out = {}
    opt = res.state.opt_state
    for p in res.model.parameters():
        for key, t in (("params", p), ("mu", opt.state[p]["exp_avg"]),
                       ("nu", opt.state[p]["exp_avg_sq"])):
            t = t.full_tensor() if is_dtensor(t) else t
            name = (f"params/{names[id(p)]}" if key == "params"
                    else f"opt_state/0/{key}/{names[id(p)]}")
            out[name] = t.detach().numpy().copy()
    return out


def _stop_saver():
    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        AsyncCheckpointSaver,
    )

    AsyncCheckpointSaver.reset()


def ckpt_write_world(rank, world, cases, ckdirs, job, jax_dir):
    """Each case (key, strategy): 2 steps, the names this rank writes, a
    save to storage, 2 more steps; then a fresh build (another seed)
    restores the save and takes the same 2 steps (bitwise).  Then the
    JAX-written checkpoint in `jax_dir` restores into an fsdp build."""
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import StorageType

    out = {}
    for key, strategy in cases:
        res, _ = train("gpt", strategy, steps=2)
        tree = res.state.tree()
        refs = leaf_refs(tree)
        ck = checkpointer(ckdirs[key], f"{job}-{key}", rank, world)
        ck.save_checkpoint(2, tree, StorageType.DISK)
        assert ck.wait_latest_checkpoint(120)
        saved = restored_global(res)
        after = []
        for b in host_batches(4)[2:]:
            res.state, m = res.train_step(res.state, res.place_batch(b))
            after.append((m["loss"].item(), m["grad_norm"].item()))
        want = full_params(res.model)
        # a fresh build from another seed, restored from the save
        fresh = _fresh(strategy)
        assert ck.load_checkpoint(fresh.state.tree()) is not None
        tier = ck.last_restore_report.get("tier")
        resumed = []
        for b in host_batches(4)[2:]:
            fresh.state, m = fresh.train_step(fresh.state,
                                              fresh.place_batch(b))
            resumed.append((m["loss"].item(), m["grad_norm"].item()))
        got = full_params(fresh.model)
        ck.close()
        _stop_saver()
        out[key] = {"refs": refs, "after": after, "resumed": resumed,
                    "tier": tier, "step": int(fresh.state.step),
                    "bitwise": all(np_equal(got[n], want[n]) for n in want),
                    "saved": saved if rank == 0 else None}
    fresh = _fresh([("fsdp", {})])
    ck = checkpointer(jax_dir, f"{job}-jax", rank, world)
    assert ck.load_checkpoint(fresh.state.tree()) is not None
    restored = restored_global(fresh)
    ck.close()
    _stop_saver()
    out["jax"] = restored if rank == 0 else None
    return out


def ckpt_read_world(rank, world, strategy, ckdir, job):
    """A build over `strategy` in this world restores `ckdir` from
    storage: the global state it holds then (rank 0) and one step."""
    fresh = _fresh(strategy)
    ck = checkpointer(ckdir, job, rank, world)
    assert ck.load_checkpoint(fresh.state.tree()) is not None
    restored = restored_global(fresh)
    b = host_batches(4)[2]
    fresh.state, m = fresh.train_step(fresh.state, fresh.place_batch(b))
    ck.close()
    _stop_saver()
    return {"restored": restored if rank == 0 else None,
            "loss": m["loss"].item(), "step": int(fresh.state.step)}


def _fresh(strategy, seed=1, overrides=None):
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate

    return auto_accelerate(port_model("gpt", **(overrides or {})),
                           optimizer=port_optimizer("adamw"), device="cpu",
                           seed=seed, strategy=list(strategy)
                           + [("half", {"enabled": False})])


def np_equal(a, b) -> bool:
    import numpy as np

    return a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------- expert parallel cases


def expert_cases(rank, world, cases, inits, ckdir, job):
    """Each case (key, strategy, overrides, lr): GPT nano with experts
    from `inits[key]`: the metrics and the first forward's aux loss on
    every rank, the final global parameters on rank 0, and the global
    index of this rank's piece of every expert stack.  Then the
    ``ckpt`` build (ep 4 + fsdp): 2 steps, the names this rank writes, a
    save to storage, 2 more steps; a fresh build (another seed)
    restores the save and takes the same 2 steps."""
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import StorageType
    from dlrover_wuqiong_tpu_torch.parallel.fsdp import is_dtensor
    from dlrover_wuqiong_tpu_torch.parallel.sharding import dtensor_layout

    out = {}
    for key, strategy, overrides, lr in cases:
        res, metrics = train("gpt", strategy, init=inits.get(key), lr=lr,
                             steps=1, overrides=overrides)
        aux = aux_loss(res.model)
        for b in host_batches()[1:]:
            res.state, m = res.train_step(res.state, res.place_batch(b))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        layout = {n: dtensor_layout(p)[0] if is_dtensor(p) else None
                  for n, p in res.model.named_parameters()
                  if "experts_" in n}
        params = full_params(res.model)
        out[key] = {"metrics": metrics, "aux": aux, "layout": layout,
                    "params": params if rank == 0 else None,
                    "plan": res.strategy.plan.describe()}
    strategy, overrides = EP_CKPT
    res, _ = train("gpt", strategy, steps=2, overrides=overrides)
    tree = res.state.tree()
    refs = leaf_refs(tree)
    ck = checkpointer(ckdir, job, rank, world)
    ck.save_checkpoint(2, tree, StorageType.DISK)
    assert ck.wait_latest_checkpoint(120)
    after = []
    for b in host_batches(4)[2:]:
        res.state, m = res.train_step(res.state, res.place_batch(b))
        after.append((m["loss"].item(), m["grad_norm"].item()))
    want = full_params(res.model)
    fresh = _fresh(strategy, overrides=overrides)
    assert ck.load_checkpoint(fresh.state.tree()) is not None
    tier = ck.last_restore_report.get("tier")
    resumed = []
    for b in host_batches(4)[2:]:
        fresh.state, m = fresh.train_step(fresh.state, fresh.place_batch(b))
        resumed.append((m["loss"].item(), m["grad_norm"].item()))
    got = full_params(fresh.model)
    ck.close()
    _stop_saver()
    out["ckpt"] = {"refs": refs, "after": after, "resumed": resumed,
                   "tier": tier, "step": int(fresh.state.step),
                   "bitwise": all(np_equal(got[n], want[n]) for n in want)}
    return out


#: GPT nano with 4 experts (a capacity factor of 1: tokens overflow)
MOE = {"moe_experts": 4, "moe_capacity_factor": 1.0}
#: the checkpoint's build: its pieces' names against JAX's, its resume
EP_CKPT = ([("expert_parallel", {"size": 4}), ("fsdp", {})], MOE)


# ------------------------------------------------- sequence parallel cases


def sp_attention(rank, world, q, k, v, impls):
    """Each impl of `impls`, causal and full, over an sp world of `world`
    (this rank's chunk of the global numpy q, k, v (b, h, S, d)): this
    rank's output and its chunk of the gradients of the global sum of
    squares."""
    from dlrover_wuqiong_tpu_torch.parallel.long_context import SP_ATTENTION
    from dlrover_wuqiong_tpu_torch.parallel.mesh import MeshPlan, build_mesh

    mesh = build_mesh(MeshPlan(sp=world), "cpu")
    out = {}
    for impl in impls:
        for causal in (True, False):
            qkv = [torch.from_numpy(x).chunk(world, 2)[rank].clone()
                   .requires_grad_() for x in (q, k, v)]
            o = SP_ATTENTION[impl](*qkv, mesh, causal=causal)
            (o ** 2).sum().backward()
            out[impl, causal] = [o.detach().numpy()] + [
                t.grad.numpy() for t in qkv]
    return out


def long_context_world(rank, world, q, k, v, impls, cases, inits,
                       overrides):
    """The world-side cases of tests/test_torch_long_context.py."""
    return {"attention": sp_attention(rank, world, q, k, v, impls),
            "training": parity_cases(rank, world, cases, inits, overrides)}


# --------------------------------------------------------- local SGD cases


def diloco_batches(steps: int, accum: int = 1):
    """The global batches of a DiLoCo run: `host_batches`, or with
    `accum` > 1 each step's rows as `accum` microbatches (a leading
    axis), every group keeping its own rows of each."""
    import numpy as np

    out = []
    for b in host_batches(steps * accum):
        out.append(b)
    if accum == 1:
        return out
    return [{k: np.stack([out[i * accum + j][k] for j in range(accum)])
             for k in out[0]} for i in range(steps)]


def digest(params) -> str:
    """A hash of a {name: numpy} state (the group's parameters)."""
    import hashlib

    h = hashlib.sha1()
    for n in sorted(params):
        h.update(n.encode())
        h.update(params[n].tobytes())
    return h.hexdigest()


def diloco(strategy, opt, lr, seed=0, overrides=None):
    """`auto_accelerate` of GPT nano in float32 over a local SGD
    `strategy` (its `DiLoCoState` in ``res.state``)."""
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate

    return auto_accelerate(port_model("gpt", **(overrides or {})),
                           optimizer=port_optimizer(opt, lr), device="cpu",
                           seed=seed, strategy=list(strategy)
                           + [("half", {"enabled": False})])


def diloco_run(res, batches):
    """Steps of `res` over `batches`: [(loss, digest of the group's
    parameters)] (a gather over the group on every rank)."""
    out = []
    for b in batches:
        res.state, m = res.train_step(res.state, res.place_batch(b))
        out.append((m["loss"].item(), digest(full_params(res.model))))
    return out


def diloco_world(rank, world, cases, inits, ckcase, ckdirs, job):
    """The world side of tests/test_torch_local_sgd.py.

    Each case (key, strategy, opt, lr, steps, accum) from JAX's initial
    DiLoCo state `inits[key]` (`DiLoCoState.load_tree`): every step's
    loss and group digest, and the group's final parameters on each
    group's first rank; ``host_state`` under optimizer_offload.  Then
    `ckcase` (key, strategy, opt, lr): 3 steps, a flash save and a DCP
    save, 3 more steps; fresh builds (another seed) restore each and
    take the same 3 steps; a fresh build restores JAX's DiLoCo flash
    checkpoint (``ckdirs["jax"]``) and takes 3 steps.  The refusals
    last."""
    from dlrover_wuqiong_tpu_torch.checkpoint import dcp_compat
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import StorageType

    out = {}
    for key, strategy, opt, lr, steps, accum in cases:
        res = diloco(strategy, opt, lr)
        res.state.load_tree(inits[key])
        runs = diloco_run(res, diloco_batches(steps, accum))
        params = full_params(res.model)
        first = res.mesh_state.coord["fsdp"] == 0
        out[key] = {"runs": runs, "params": params if first else None,
                    "group": res.mesh_state.replica}
        if "offload" in key:
            opt_ = res.state.inner_opt_state
            out[key]["host_state"] = all(
                v.device.type == "cpu" and not hasattr(v, "placements")
                and v.shape == q.shape for q in opt_.proxies
                for k, v in opt_.inner.state[q].items() if k != "step")
    key, strategy, opt, lr = ckcase
    batches = diloco_batches(6)
    res = diloco(strategy, opt, lr)
    res.state.load_tree(inits[key])
    before = diloco_run(res, batches[:3])
    ck = checkpointer(ckdirs["port"], f"{job}-port", rank, world)
    ck.save_checkpoint(3, res.state.tree(), StorageType.DISK)
    assert ck.wait_latest_checkpoint(120)
    dcp_compat.save_dcp(ckdirs["dcp"], res.state)
    after = diloco_run(res, batches[3:])
    resumed = {}
    for via in ("flash", "dcp"):
        fresh = diloco(strategy, opt, lr, seed=1)
        if via == "flash":
            assert ck.load_checkpoint(fresh.state) is not None
        else:
            dcp_compat.load_dcp(ckdirs["dcp"], fresh.state)
        resumed[via] = diloco_run(fresh, batches[3:])
        resumed[via + "_step"] = int(fresh.state.step)
    ck.close()
    _stop_saver()
    fresh = diloco(strategy, opt, lr, seed=1)
    wait_for_step(ckdirs["jax"], 3)
    ck = checkpointer(ckdirs["jax"], f"{job}-jax", rank, world)
    assert ck.load_checkpoint(fresh.state) is not None
    ck.close()
    _stop_saver()
    restored = digest(full_params(fresh.model))
    jax_resumed = diloco_run(fresh, batches[3:])
    out["ckpt"] = {"before": before, "after": after, "resumed": resumed,
                   "jax_restored": restored, "jax_resumed": jax_resumed,
                   "group": fresh.mesh_state.replica,
                   "refs": leaf_refs(res.state.tree())}
    out["refusals"] = diloco_refusals()
    return out


def wait_for_step(ckdir, step, timeout=300.0):
    """Block until `ckdir` has committed `step` (a checkpoint another
    process writes meanwhile)."""
    from dlrover_wuqiong_tpu_torch.checkpoint.ckpt_saver import (
        read_last_step,
    )

    end = time.monotonic() + timeout
    while read_last_step(ckdir) < step:
        if time.monotonic() > end:
            raise TimeoutError(f"{ckdir}: step {step} not committed")
        time.sleep(0.1)


def diloco_refusals():
    """{case: the message each refused local_sgd build raises}."""
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate

    base = [("local_sgd", {}), ("data_parallel", {"size": 2}), ("fsdp", {})]
    cases = {
        "no_dp": ([("local_sgd", {}), ("fsdp", {})], {}),
        "fused": (base, {"fused_steps": 2}),
        "abstract": (base, {"materialize": False}),
        "pipeline": (base + [("pipeline_parallel", {"size": 2})], {}),
        "tp": ([("hsdp", {}), ("data_parallel", {"size": 2}),
                ("tensor_parallel", {"size": 2})], {}),
    }
    out = {}
    for key, (strategy, kw) in cases.items():
        try:
            auto_accelerate(port_model("gpt"), device="cpu",
                            strategy=strategy, **kw)
        except (ValueError, NotImplementedError) as e:
            out[key] = f"{type(e).__name__}: {e}"
        else:
            out[key] = None
    return out


# ------------------------------------------------------------ DCP cases

#: GPT nano 80 wide: its attention kernels' Shard(0) pieces are not
#: 256-aligned runs (20 rows of 240 over fsdp 4, 40 over fsdp 2), so
#: adamw8bit lays them out B; its MLP kernels' stay A
UNALIGNED = {"n_embd": 80}
#: the adamw8bit builds of tests/test_torch_dcp.py
QUANT = (("nano", None), ("n_embd80", UNALIGNED))


def quant_moments(res):
    """{param name: (index, mu, nu)}: this rank's piece of each
    adamw8bit moment, dequantized (float32 numpy), with the piece's
    index in the parameter; and {name: "A" | "B"}, the layout its
    checkpoint tree gives each sharded parameter's state."""
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        MeshPiece,
        flatten_state_dict,
    )
    from dlrover_wuqiong_tpu_torch.optimizers.low_bit import (
        dequantize_blockwise,
    )
    from dlrover_wuqiong_tpu_torch.parallel.fsdp import is_dtensor
    from dlrover_wuqiong_tpu_torch.parallel.sharding import dtensor_layout

    opt = res.state.opt_state
    out = {}
    for (n, p), q in zip(res.model.named_parameters(), opt.proxies):
        index = (dtensor_layout(p)[0] if is_dtensor(p)
                 else [[0, s] for s in p.shape])
        mu, nu = opt.inner.qtensors(q)
        out[n] = (index, dequantize_blockwise(mu).numpy().copy(),
                  dequantize_blockwise(nu).numpy().copy())
    layouts = {}
    for name, leaf in flatten_state_dict(res.state.tree()).items():
        if isinstance(leaf, MeshPiece) and name.endswith("/1") and \
                leaf.restore is not None:
            path = name.split("/", 3)[3].rsplit("/", 1)[0]
            layouts[path.replace("/", ".")] = \
                "B" if len(leaf.global_shape) == 2 else "A"
    return out, layouts


def local_quant_digest(res) -> str:
    """A hash of this rank's adamw8bit codes and scales, as they are."""
    import numpy as np

    opt = res.state.opt_state
    arrays = {}
    for i, q in enumerate(opt.proxies):
        for k, v in opt.inner.state[q].items():
            arrays[f"{i}/{k}"] = np.asarray(v.numpy())
    return digest(arrays)


def quant_build(overrides=None, seed=0, strategy=(("fsdp", {}),)):
    """GPT nano over `strategy` with adamw8bit (the optimizer's state
    is its pieces', `LocalShards`)."""
    from dlrover_wuqiong_tpu_torch.auto.accelerate import auto_accelerate

    return auto_accelerate(port_model("gpt", **(overrides or {})),
                           optimizer=port_optimizer("adamw8bit"),
                           device="cpu", seed=seed,
                           strategy=list(strategy)
                           + [("half", {"enabled": False})])


def dcp_write_world(rank, world, jax_dirs, dirs, job):
    """The world of 4 of tests/test_torch_dcp.py.

    - JAX's fsdp flash checkpoint exported to DCP (`export_dcp`) from a
      fresh fsdp build; `import_dcp` of that into a new flash dir, which
      a fresh build resumes; the DCP-loaded and the flash-resumed builds
      each take a step.
    - adamw8bit over fsdp 4 (`QUANT`: both layouts): 2 steps, flash
      and DCP saves, the moments; fresh builds restore each save (codes
      and scales, then a step, against the original's).
    - distinct codes planted on each rank, saved to DCP, read back.
    - JAX's adamw8bit fsdp checkpoint restored onto the port's pieces."""
    from dlrover_wuqiong_tpu_torch.checkpoint import dcp_compat
    from dlrover_wuqiong_tpu_torch.checkpoint.checkpointer import StorageType
    from dlrover_wuqiong_tpu_torch.checkpoint.shm_handler import (
        flatten_state_dict,
    )

    out = {}
    fsdp = [("fsdp", {})]
    exported = _fresh(fsdp)
    dcp_compat.export_dcp(jax_dirs["fsdp"], dirs["jax_dcp"],
                          exported.state, job_name=f"{job}-exp")
    out["exported"] = restored_global(exported)
    imp = _fresh(fsdp, seed=2)
    dcp_compat.load_dcp(dirs["jax_dcp"], imp.state)
    dcp_compat.import_dcp(dirs["jax_dcp"], dirs["imported"], _fresh(
        fsdp, seed=3).state, step=5, job_name=f"{job}-imp")
    back = _fresh(fsdp, seed=4)
    ck = checkpointer(dirs["imported"], f"{job}-back", rank, world)
    assert ck.load_checkpoint(back.state) is not None
    ck.close()
    _stop_saver()
    out["imported"] = restored_global(back)
    out["imported_step"] = int(back.state.step)
    b = host_batches(1)[0]
    metrics = []
    for res in (imp, back):
        res.state, m = res.train_step(res.state, res.place_batch(b))
        metrics.append((m["loss"].item(), m["grad_norm"].item(),
                        digest(full_params(res.model))))
    out["resumed"] = metrics

    for key, overrides in QUANT:
        res = quant_build(overrides)
        for b in host_batches(2):
            res.state, m = res.train_step(res.state, res.place_batch(b))
        ck = checkpointer(dirs[f"flash_{key}"], f"{job}-{key}", rank, world)
        ck.save_checkpoint(2, res.state.tree(), StorageType.DISK)
        assert ck.wait_latest_checkpoint(120)
        dcp_compat.save_dcp(dirs[f"dcp_{key}"], res.state)
        moments, layouts = quant_moments(res)
        saved = local_quant_digest(res)
        nxt = host_batches(3)[2]
        res.state, m = res.train_step(res.state, res.place_batch(nxt))
        want = (m["loss"].item(), digest(full_params(res.model)))
        got = {}
        for via in ("flash", "dcp"):
            fresh = quant_build(overrides, seed=1)
            if via == "flash":
                assert ck.load_checkpoint(fresh.state) is not None
            else:
                dcp_compat.load_dcp(dirs[f"dcp_{key}"], fresh.state)
            digest_ = local_quant_digest(fresh)
            fresh.state, m = fresh.train_step(fresh.state,
                                              fresh.place_batch(nxt))
            got[via] = (digest_, m["loss"].item(),
                        digest(full_params(fresh.model)))
        ck.close()
        _stop_saver()
        out[f"quant_{key}"] = {"moments": moments, "layouts": layouts,
                               "saved": saved, "next": want,
                               "restored": got}

    # distinct codes on each rank: every rank's rows come back
    res = quant_build()
    opt = res.state.opt_state
    for q in opt.proxies:
        opt.inner.state[q]["mu_q"].fill_(rank + 1)
    dcp_compat.save_dcp(dirs["plant"], res.state)
    names = list(dcp_compat.dcp_state_dict(res.state))
    codes = [n for n in flatten_state_dict(res.state.tree())
             if "/mu/" in n and n.endswith("/0")]
    out["planted"] = dcp_compat.read_dcp(dirs["plant"], codes)
    out["planted_index"] = {
        n.split("#")[0]: dcp_compat._parse_piece(n)[1]
        for n in names if "#shard" in n and "/mu/" in n
        and n.split("#")[0].endswith("/0")}

    # JAX's adamw8bit fsdp checkpoint onto the port's pieces
    res = quant_build(seed=1)
    ck = checkpointer(jax_dirs["adamw8bit"], f"{job}-j8", rank, world)
    assert ck.load_checkpoint(res.state) is not None
    ck.close()
    _stop_saver()
    out["jax8"] = quant_moments(res)
    return out


def dcp_read_world(rank, world, dirs, job):
    """The world of 2 of tests/test_torch_dcp.py: JAX's fsdp state from
    the DCP export into fsdp 2, and the adamw8bit saves of the world of
    4 (flash and DCP) into fsdp 2: the moments and the layouts."""
    from dlrover_wuqiong_tpu_torch.checkpoint import dcp_compat

    out = {}
    fresh = _fresh([("fsdp", {})])
    dcp_compat.load_dcp(dirs["jax_dcp"], fresh.state)
    out["exported"] = restored_global(fresh)
    for key, overrides in QUANT:
        for via in ("flash", "dcp"):
            res = quant_build(overrides, seed=1)
            if via == "flash":
                ck = checkpointer(dirs[f"flash_{key}"], f"{job}-{key}",
                                  rank, world)
                assert ck.load_checkpoint(res.state) is not None
                ck.close()
                _stop_saver()
            else:
                dcp_compat.load_dcp(dirs[f"dcp_{key}"], res.state)
            out[f"quant_{key}_{via}"] = quant_moments(res)
    return out
