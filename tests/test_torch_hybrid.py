"""Port parity: the RL hybrid engine (`rl/hybrid.py`) against the JAX
package's `HybridEngine` (dlrover_wuqiong_tpu/rl/hybrid.py).

In a gloo world of 4 (`torch_world.run_world`), GPT nano's parameters
(JAX's float32 init) placed on the train mesh (fsdp 4) and synced onto
the decode mesh (tp 2 x dp 2): each rank's piece of every leaf, after
`place_train` and after `sync_to_decode`, bitwise the shard that JAX's
engine on the same devices puts on the device of the same index; so are
the prompts over dp and the train batch over the data dims.  A second
sync gives the same pieces, its wall time is read, and its bytes are
each rank's decode pieces less what the rank held: no rank gathers a
whole leaf.  The refusal of a decode_tp that does not divide the world
is JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_pipeline_world as tpw
import torch_world as tw
from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.rl.hybrid import HybridEngine as JaxHybridEngine
from torch_threads import one_torch_thread  # noqa: F401

DECODE_TP = 2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _shards(x, devices):
    by_dev = {s.device: np.asarray(s.data) for s in x.addressable_shards}
    return [by_dev[d] for d in devices]


@pytest.fixture(scope="module")
def runs():
    """JAX's placements here while the port's world runs beside them."""
    from concurrent.futures import ThreadPoolExecutor

    devs = jax.devices()[:4]
    # jitted: the eager init takes ~10x longer; any seeded tree will do
    params = jax.jit(jgpt.GPT(jgpt.GPTConfig.nano()).init_params)(
        jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 512, (8, 6)).astype(np.int32)
    batch = rng.normal(size=(8, 5)).astype(np.float32)
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(tw.run_world, 4, tpw.hybrid_world, params,
                            prompts, batch, DECODE_TP)
        eng = JaxHybridEngine(devs, decode_tp=DECODE_TP)
        train = eng.place_train(jax.tree.map(jnp.asarray, params))
        dec = eng.sync_to_decode(train)
        want = {"train": {n: _shards(v, devs)
                          for n, v in _flat(train).items()},
                "decode": {n: _shards(v, devs)
                           for n, v in _flat(dec).items()},
                "prompts": _shards(eng.place_prompts(jnp.asarray(prompts)),
                                   devs),
                "batch": _shards(eng.place_batch_train(jnp.asarray(batch)),
                                 devs),
                "train_shape": dict(eng.train_mesh.shape),
                "decode_shape": dict(eng.decode_mesh.shape)}
        return want, world.result(), params


@pytest.mark.parametrize("which", ["train", "decode"])
def test_pieces_are_jax_shards_bitwise(which, runs):
    want, world, _ = runs
    for rank, got in enumerate(world):
        assert sorted(got[which]) == sorted(want[which])
        for n, ref in want[which].items():
            assert got[which][n].shape == ref[rank].shape, (which, n, rank)
            assert np.array_equal(got[which][n], ref[rank]), (which, n, rank)


def test_meshes_are_jax(runs):
    want, world, _ = runs
    for got in world:
        assert {k: v for k, v in got["train_shape"].items() if v > 1} == \
            {k: v for k, v in want["train_shape"].items() if v > 1}
        assert {k: v for k, v in got["decode_shape"].items() if v > 1} == \
            {k: v for k, v in want["decode_shape"].items() if v > 1}


@pytest.mark.parametrize("which", ["prompts", "batch"])
def test_batches_are_jax_shards(which, runs):
    want, world, _ = runs
    for rank, got in enumerate(world):
        assert np.array_equal(got[which], want[which][rank]), (which, rank)


def test_sync_is_piecewise_and_timed(runs):
    """The second sync repeats the first bitwise; its bytes are the decode
    pieces each rank lacked, below one gathered copy of every leaf per
    rank."""
    want, world, params = runs
    flat = {n: np.asarray(v) for n, v in _flat(params).items()}
    whole = sum(v.nbytes for v in flat.values())
    lacking = 0
    for rank, got in enumerate(world):
        assert got["same"] and got["sync_s"] > 0.0
        for n, dec in got["decode"].items():
            held = got["train"][n]
            if held.shape == flat[n].shape:
                continue  # replicated on the train mesh: held already
            lacking += dec.nbytes
    assert all(got["bytes"] == world[0]["bytes"] for got in world)
    assert 0 < world[0]["bytes"] <= lacking < 4 * whole


def test_refuses_as_jax(runs):
    with pytest.raises(ValueError) as jerr:
        JaxHybridEngine(jax.devices()[:4], decode_tp=3)
    assert all(got["refusal"] == str(jerr.value) for got in runs[1])
