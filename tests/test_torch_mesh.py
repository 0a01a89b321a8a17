"""Port parity: mesh planning and the sharding specs, without a process
group.

- `MeshPlan`, `auto_plan` and `hybrid_slice_plan` against JAX's on the
  same arguments: the plans, and the error messages word for word.
- Every parameter's spec for GPT nano, Llama nano and GPT nano with
  experts equals JAX's ``ShardingPlanner.param_specs`` on an 8-device
  host mesh (fsdp 8; fsdp 4 x tp 2; dp 2 x fsdp 2 x tp 2), with and
  without the MoE rules.
- `placements` and `_add_fsdp` cases, and `spec_index` against the
  slices JAX's ``NamedSharding`` gives each device.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import llama as jllama
from dlrover_wuqiong_tpu.parallel import mesh as jmesh
from dlrover_wuqiong_tpu.parallel import sharding as jsharding
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.models import llama as tllama
from dlrover_wuqiong_tpu_torch.parallel import mesh as tmesh
from dlrover_wuqiong_tpu_torch.parallel import sharding as tsharding
from torch_threads import one_torch_thread  # noqa: F401

GIB = 1 << 30
AUTO_CASES = {
    "small": dict(num_devices=8, num_params=124_000_000),
    "none": dict(num_devices=4),
    "70b_tp": dict(num_devices=64, num_params=70_000_000_000,
                   hbm_per_device=95 * GIB),
    "long_seq": dict(num_devices=16, num_params=8_000_000_000,
                     seq_len=131072, hbm_per_device=80 * GIB),
    "experts": dict(num_devices=16, num_params=1_000_000_000,
                    num_experts=8),
    "reclaim_sp": dict(num_devices=8, num_params=8_000_000_000,
                       seq_len=131072, hbm_per_device=16 * GIB),
    "reclaim_ep": dict(num_devices=8, num_params=8_000_000_000,
                       num_experts=8, hbm_per_device=16 * GIB),
    "no_fit": dict(num_devices=1, num_params=8_000_000_000,
                   hbm_per_device=80 * GIB),
    "no_fit_8": dict(num_devices=8, num_params=400_000_000_000,
                     hbm_per_device=16 * GIB),
}


def _call(fn, **kw):
    try:
        return fn(**kw).sizes()
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_auto_plan_matches_jax(case):
    kw = AUTO_CASES[case]
    assert _call(tmesh.auto_plan, **kw) == _call(jmesh.auto_plan, **kw)


def test_auto_plan_raises_does_not_fit():
    got = _call(tmesh.auto_plan, **AUTO_CASES["no_fit"])
    assert got[0] == "error" and "does not fit" in got[1]


@pytest.mark.parametrize("args", [(2, 4), (2, 8, 2), (4, 8, 2, 2), (3, 6)])
def test_hybrid_slice_plan_and_mesh_plan_match_jax(args):
    t, j = tmesh.hybrid_slice_plan(*args), jmesh.hybrid_slice_plan(*args)
    assert t.sizes() == j.sizes()
    assert t.describe() == j.describe()
    assert t.num_devices == j.num_devices and t.data_axes == j.data_axes
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh._largest_pow2_leq(args[1]) == jmesh._largest_pow2_leq(
        args[1])
    for n in (t.num_devices, t.num_devices + 1):
        try:
            j.validate(n)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            t.validate(n)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want
    assert tmesh.MeshPlan().describe() == jmesh.MeshPlan().describe()


MESHES = {"fsdp8": (1, 1, 8, 1, 1, 1), "fsdp4_tp2": (1, 1, 4, 1, 1, 2),
          "dp2_fsdp2_tp2": (2, 1, 2, 1, 1, 2)}
MODELS = {
    "gpt": (lambda: jgpt.GPT(jgpt.GPTConfig.nano()),
            lambda: tgpt.GPT(tgpt.GPTConfig.nano())),
    "llama": (lambda: jllama.Llama(jllama.LlamaConfig.nano()),
              lambda: tllama.Llama(tllama.LlamaConfig.nano())),
    "gpt_moe": (lambda: jgpt.GPT(dataclasses.replace(
        jgpt.GPTConfig.nano(), moe_experts=4)),
        lambda: tgpt.GPT(dataclasses.replace(tgpt.GPTConfig.nano(),
                                             moe_experts=4))),
}


def _jax_mesh(shape):
    return Mesh(np.array(jax.devices()[:8]).reshape(shape),
                jmesh.AXIS_ORDER)


@pytest.mark.parametrize("moe", [False, True], ids=["dense_rules",
                                                     "moe_rules"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_param_specs_match_jax(model, mesh, moe):
    jm, tm = MODELS[model]
    jmodel = jm()
    params = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    jplanner = jsharding.ShardingPlanner(_jax_mesh(MESHES[mesh]))
    tplanner = tsharding.ShardingPlanner(dict(zip(tmesh.AXIS_ORDER,
                                                  MESHES[mesh])))
    if moe:
        jplanner.with_moe()
        tplanner.with_moe()
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jplanner.param_specs(params),
            is_leaf=lambda x: isinstance(x, P))[0]:
        want[jsharding.path_of(path).replace("/", ".")] = tuple(spec)
    got = tplanner.param_specs(tm())
    assert got == want


def test_placements_and_add_fsdp():
    from torch.distributed.tensor import Replicate, Shard

    names = tmesh.AXIS_ORDER
    pl = tsharding.placements(("fsdp", "tp"), None, names)
    assert pl == [Replicate(), Replicate(), Shard(0), Replicate(),
                  Replicate(), Shard(1)]
    assert tsharding.placements((("dp", "fsdp"), None), None, names)[:3] \
        == [Shard(0), Replicate(), Shard(0)]
    assert tsharding.placements((), None, names) == [Replicate()] * 6
    sizes = {"fsdp": 4}
    jm = _jax_mesh((1, 1, 4, 1, 1, 2))
    for spec, shape, min_size in (
            ((), (1024, 512), 2 ** 16),       # largest divisible dim
            ((None,), (512,), 2 ** 16),       # below the size floor
            ((None,), (65536,), 2 ** 16),
            (("tp", None), (1024, 64), 2 ** 10),
            (("fsdp", None), (1024, 512), 2 ** 16),  # already there
            ((None, None), (6, 10), 1)):      # nothing divisible
        got = tsharding._add_fsdp(spec, shape, sizes, min_size)
        want = jsharding._add_fsdp(P(*spec), shape, jm, min_size)
        assert got == tuple(want), (spec, shape)


@pytest.mark.parametrize("spec", [("fsdp", "tp"), ("tp", "fsdp"),
                                  (("dp", "fsdp"), None), (None, "tp")])
def test_spec_index_is_jax_device_slices(spec):
    shape = (16, 8)
    jm = _jax_mesh((2, 1, 2, 1, 1, 2))
    arr = jax.device_put(np.zeros(shape, np.float32),
                         NamedSharding(jm, P(*spec)))
    sizes = dict(zip(tmesh.AXIS_ORDER, (2, 1, 2, 1, 1, 2)))
    coords = np.argwhere(np.ones((2, 1, 2, 1, 1, 2)))
    by_device = {s.device: s.index for s in arr.addressable_shards}
    for dev, c in zip(jm.devices.reshape(-1), coords):
        idx = tsharding.spec_index(shape, spec, sizes,
                                   dict(zip(tmesh.AXIS_ORDER, c)))
        want = [[sl.start or 0, sl.stop if sl.stop is not None else n]
                for sl, n in zip(by_device[dev], shape)]
        assert idx == want


def test_batch_spec_raises_for_a_sequence_mesh():
    """A sequence dim over sp no longer raises (ROADMAP item 8b is
    ported): the batch specs of a mesh with sp 2 are JAX's."""
    planner = tsharding.ShardingPlanner({"sp": 2})
    jm = jmesh.build_mesh(jmesh.MeshPlan(sp=2, fsdp=4))
    jplanner = jsharding.ShardingPlanner(jm)
    for args in ((2,), (2, 1), (3, 2, 1)):
        want = tuple(jplanner.batch_spec(*args))
        assert planner.batch_spec(*args) == want, args
    assert planner.batch_spec(2, seq_axis=1) == (("dp", "fsdp"), "sp")
