"""Port parity: pipeline parallelism composed with the mesh's other dims,
in a gloo world of 4 against the JAX package's `auto_accelerate` with the
same strategy on 4 host devices (tests/test_pipeline.py:323-711), in the
order ROADMAP item 8c lists them:

1. pp 2 x fsdp 2 under gpipe, interleaved (v 2) and 1F1B; 1F1B with
   ``grad_accum`` (2 outer microbatches around the pipeline's 2), and
   GPT with 4 experts under gpipe and 1F1B (the MoE aux, each fsdp
   rank its piece of each pipeline microbatch);
2. pp 2 x tp 2 (GPT under gpipe, Llama under 1F1B);
3. pp 2 x sp 2, ring attention, under 1F1B;
4. pp 2 x ep 2, GPT with 4 experts.

Each case as tests/test_torch_pipeline.py holds it (its tolerances),
from JAX's initial tree: the logits, the loss and every leaf's gradient
of one step's `value_and_grad`, and, where the case trains, 2 steps of
adamw(1e-2).  Besides, 1F1B's label-smoothed ``head_loss`` against
JAX's (tests/test_pipeline.py:720), and the port's gpipe with the same
loss over the whole batch against it; and the state's names and index
ranges against JAX's specs under fsdp, tp and ep.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest

import torch_pipeline_world as tpw
from test_torch_pipeline import check_case, check_layout, run_both
from torch_threads import one_torch_thread  # noqa: F401

MOE = {"moe_experts": 4, "moe_capacity_factor": 1.0}
PP2 = {"size": 2}


def _pp(**kw):
    return ("pipeline_parallel", dict(PP2, **kw))


FSDP = ("fsdp", {})
CASES = [
    ("fsdp_gpipe", "gpt", {"n_layer": 4}, [_pp(), FSDP], 2, 1),
    ("fsdp_interleaved", "gpt", {"n_layer": 4},
     [_pp(schedule="interleaved"), FSDP], 0, 1),
    ("fsdp_1f1b", "llama", {"num_layers": 4}, [_pp(schedule="1f1b"), FSDP],
     2, 1),
    ("fsdp_1f1b_accum", "gpt", {"n_layer": 4},
     [_pp(schedule="1f1b", microbatches=2), FSDP,
      ("grad_accum", {"steps": 2})], 2, 2),
    ("fsdp_moe_gpipe", "gpt", dict(MOE, n_layer=4), [_pp(), FSDP], 0, 1),
    ("fsdp_moe_1f1b", "gpt", dict(MOE, n_layer=4),
     [_pp(schedule="1f1b"), FSDP], 0, 1),
    ("tp_gpipe", "gpt", {"n_layer": 4},
     [_pp(), ("tensor_parallel", {"size": 2})], 0, 1),
    ("tp_1f1b", "llama", {"num_layers": 4},
     [_pp(schedule="1f1b"), ("tensor_parallel", {"size": 2})], 0, 1),
    ("sp_ring_1f1b", "gpt", {"n_layer": 4},
     [_pp(schedule="1f1b"), ("sequence_parallel", {"size": 2,
                                                   "impl": "ring"})], 0, 1),
    ("ep_moe", "gpt", dict(MOE, n_layer=4),
     [_pp(), ("expert_parallel", {"size": 2})], 0, 1),
    ("head_loss_1f1b", "gpt", {"n_layer": 4},
     [_pp(schedule="1f1b", head_loss=tpw.smoothed_head_loss), FSDP], 0, 1),
]
#: the port's gpipe with the whole-batch smoothed loss, held against
#: JAX's 1F1B head-loss run
GPIPE_SMOOTHED = ("head_loss_gpipe", "gpt", {"n_layer": 4}, [_pp(), FSDP],
                  0, 1, {"loss_fn": tpw.smoothed_loss})


def jax_smoothed_head_loss(hp, h, labels):
    """tests/test_pipeline.py:735-743's head loss."""
    x = fnn.LayerNorm(dtype=jnp.float32).apply({"params": hp["ln_f"]}, h)
    logits = jnp.einsum("bte,ve->btv", x, hp["wte"]["embedding"])
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
    nll = -jnp.take_along_axis(logp, labels[..., None], -1)[..., 0]
    uniform = -logp.mean(-1)
    return ((1 - tpw.SMOOTHING) * nll + tpw.SMOOTHING * uniform).mean()


def _jax_strategy(strategy):
    out = []
    for name, cfg in strategy:
        if cfg.get("head_loss") is not None:
            cfg = dict(cfg, head_loss=jax_smoothed_head_loss)
        out.append((name, cfg))
    return out


@pytest.fixture(scope="module")
def runs():
    """JAX's runs here while the port's world runs beside them."""
    return run_both(CASES, world_cases=CASES + [GPIPE_SMOOTHED],
                    strategy=_jax_strategy,
                    same_init={GPIPE_SMOOTHED[0]: "head_loss_1f1b"})


@pytest.mark.parametrize("key", [c[0] for c in CASES])
def test_composition_matches_jax(key, runs):
    jax_runs, world = runs
    check_case(key, jax_runs[key], world)


@pytest.mark.parametrize("key", ["fsdp_interleaved", "tp_1f1b", "ep_moe"])
def test_state_names_and_rows_are_jax(key, runs):
    """Each rank's pieces of the pipelined state, the stage's rows of the
    stacked blocks and its fsdp, tp or ep piece within them, are JAX's
    `PipelineShardingPlanner.param_specs` pieces on the same mesh."""
    jax_runs, world = runs
    check_layout(key, jax_runs[key], world)


def test_gpipe_whole_batch_loss_matches_1f1b_head_loss(runs):
    """The port's gpipe with the smoothed loss over the whole batch gives
    JAX's 1F1B head-loss loss and gradients (the JAX test's claim)."""
    jax_runs, world = runs
    want = dict(jax_runs["head_loss_1f1b"])
    want["plan"] = world[0][GPIPE_SMOOTHED[0]]["plan"]
    check_case(GPIPE_SMOOTHED[0], want, world)
