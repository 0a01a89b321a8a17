"""The optimizers that step each rank's pieces under fsdp 4, in a gloo
world of 4 CPU processes, against the port's unsharded build of the
same optimizer, from the port's seeded init (GPT nano, 4 steps).

One world runs every case (`torch_world.run_world`,
`torch_world.optimizer_cases`).  Each build is held by two readings of
every leaf (GPT's key bias apart, `torch_world.split_key_bias`): its
relative L2 distance (`torch_world.leaf_spread`) and the share of its
entries more than half an lr step, or 1.5 ulps of the parameter's dtype,
away (`torch_world.off_share`).  `BOUNDS` sets each limit between the
sound build's reading and the readings of planted faults
(`torch_world.plant`), which `test_planted_fault_breaks_a_bound` reads
in the same world: a rank that skips its last update, the Kahan
compensation dropped, a clip that reads the rank's own norm.
"""

import numpy as np
import pytest
import torch

import torch_world as tw
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5


@pytest.fixture(scope="module")
def world():
    return tw.run_world(4, tw.optimizer_cases)


#: case -> (loss rtol, leaf relative L2, off share), each limit between
#: the sound build's reading and the planted faults' (this file, GPT
#: nano, 4 steps):
#: - adamw8bit (lr 1e-3): sound 8.6e-5 / 1.5e-2 / 4.5e-3 (the relative
#:   L2 is mostly the documented block difference,
#:   `test_low_bit_blocks_of_a_piece`); a rank skipping its last update
#:   reads 1.4e-2 / 1.3e-1 in the last two;
#: - stable_bf16 and clip_stable_bf16 (bf16 parameters, lr 1e-2): sound
#:   1.3e-4 / 1.1e-2 / 1.2e-3; a skipped last update reads 4.6e-2 /
#:   1.1e-1 in the last two, the compensation dropped 1.0e-2 / 1.6e-2,
#:   the clip at the rank's own norm 1.8e-3 / 1.3e-1 / 7.0e-2;
#: - clip and clip_offload (float32, lr 1e-2): sound 1.5e-7 / 6.6e-6 /
#:   0; the clip at the rank's own norm 1.9e-3 / 1.2e-1 / 6.3e-2.
BOUNDS = {
    "adamw8bit": (1e-3, 3e-2, 2e-2),
    "stable_bf16": (1e-3, 2e-2, 5e-3),
    "clip": (1e-5, 1e-4, 1e-3),
    "clip_offload": (1e-5, 1e-4, 1e-3),
    "clip_stable_bf16": (1e-3, 2e-2, 5e-3),
}
#: fault case -> the sound case whose bounds it must break
FAULTS = {
    "adamw8bit_skip_last": "adamw8bit",
    "stable_bf16_skip_last": "stable_bf16",
    "stable_bf16_no_compensation": "stable_bf16",
    "clip_offload_local_norm": "clip_offload",
    "clip_stable_bf16_local_norm": "clip_stable_bf16",
}


def _lr(opt):
    return 1e-3 if opt == "adamw8bit" else 1e-2


@pytest.fixture(scope="module")
def references():
    """The port's unsharded build of each sound case's optimizer."""
    out = {}
    for key in BOUNDS:
        strategy, opt, _ = tw.OPTIMIZER_CASES[key]
        res, metrics = tw.train("gpt", [s for s in strategy if s[0] not in
                                        ("fsdp", "optimizer_offload")], opt)
        out[key] = {"metrics": metrics,
                    "params": tw.full_params(res.model)}
    return out


def _readings(key, case, world, references):
    """(worst loss rtol over the steps, leaf spread, off share) of the
    world's `case` against the unsharded build of `key`."""
    got = world[0][case]
    want = references[key]
    g, w = np.asarray(got["metrics"]), np.asarray(want["metrics"])
    loss = float(np.max(np.abs(g[:, 0] - w[:, 0]) / np.abs(w[:, 0])))
    strategy, opt, _ = tw.OPTIMIZER_CASES[key]
    bf16 = ("stable_bf16", {}) in strategy
    return (loss, tw.leaf_spread(got["params"], want["params"]),
            tw.off_share(got["params"], want["params"], _lr(opt), bf16))


@pytest.mark.parametrize("key", sorted(BOUNDS))
def test_optimizer_under_fsdp_matches_the_unsharded_build(key, world,
                                                          references):
    """Each rank steps its pieces (AdamW over DTensors, or
    `optimizers.leaf.LocalShards`); every rule is elementwise but
    adamw8bit's blocks, which differ only on pieces that are not
    256-aligned runs of the leaf's flattening; the clip reads the global
    norm (`parallel.fsdp.MeshState.global_norm`) through every
    wrapper."""
    got = world[0][key]
    want = references[key]
    for r in world[1:]:
        assert r[key]["metrics"] == got["metrics"]
    (loss0, norm0), (want_loss0, want_norm0) = (got["metrics"][0],
                                                want["metrics"][0])
    np.testing.assert_allclose(loss0, want_loss0, rtol=RTOL)
    # a bf16 gradient's entries are each rounded once more on a rank
    # (its own sum) and differ by up to one ulp, 2^-8 relative
    bf16 = "stable_bf16" in key
    np.testing.assert_allclose(norm0, want_norm0,
                               rtol=2.0 ** -8 if bf16 else RTOL)
    loss, spread, share = _readings(key, key, world, references)
    loss_rtol, spread_max, share_max = BOUNDS[key]
    assert loss <= loss_rtol, (key, loss)
    assert spread[0] <= spread_max, (key, spread)
    assert share[0] <= share_max, (key, share)
    if key.startswith("clip"):
        # the clip acts at every step of these batches
        assert min(m[1] for m in want["metrics"]) > 1.0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_breaks_a_bound(fault, world, references):
    """Each planted fault (`torch_world.plant`) reads outside at least
    one bound that its sound case holds."""
    key = FAULTS[fault]
    loss, spread, share = _readings(key, fault, world, references)
    loss_rtol, spread_max, share_max = BOUNDS[key]
    assert (loss > loss_rtol or spread[0] > spread_max
            or share[0] > share_max), (fault, loss, spread, share)


@pytest.mark.parametrize("key", ["adamw", "clip"])
def test_offload_under_fsdp_is_the_on_device_step(key, world):
    """optimizer_offload under fsdp 4: each rank's optimizer state is its
    local pieces in host memory between steps (`LocalShards`), and the
    steps are bitwise fsdp's on-device optimizer over the DTensors, the
    clip's global norm included."""
    off = "offload" if key == "adamw" else "clip_offload"
    for r in world:
        got, want = r[off], r[key]
        assert got["metrics"] == want["metrics"]
    assert world[0]["offload"]["host_state"]
    got, want = (world[0][k]["params"] for k in (off, key))
    assert all(np.array_equal(got[n], want[n]) for n in want)


def test_low_bit_blocks_of_a_piece():
    """The documented difference: a piece that is a 256-aligned run of
    the leaf's flattening (fsdp's Shard(0) of a (128, 384) kernel over 4)
    quantizes into exactly the leaf's blocks; a Shard(1) piece does not,
    and `LocalShards` names such leaves in a warning."""
    from dlrover_wuqiong_tpu_torch.optimizers.leaf import _aligned_run
    from dlrover_wuqiong_tpu_torch.optimizers.low_bit import (
        BLOCK,
        quantize_blockwise,
    )

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 384)).astype(np.float32))
    whole = quantize_blockwise(x)
    row = quantize_blockwise(x[32:64])
    assert _aligned_run([[32, 64], [0, 384]], [128, 384], BLOCK)
    lo = 32 * 384 // BLOCK
    assert torch.equal(row.q, whole.q[lo:lo + row.q.shape[0]])
    assert torch.equal(row.scale, whole.scale[lo:lo + row.q.shape[0]])
    col = quantize_blockwise(x[:, 96:192])
    assert not _aligned_run([[0, 128], [96, 192]], [128, 384], BLOCK)
    assert not torch.equal(col.scale, whole.scale[:col.scale.shape[0]])
