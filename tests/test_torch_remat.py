"""Port parity: the five remat policies on GPT nano and Llama nano.

- For each policy ("full", "dots", "offload_dots", "save_names",
  "offload_names") and each family, float32: the loss and every gradient
  bitwise the port's remat-off run (a policy changes what is kept, not
  what is computed, and the CPU recomputes in the same order), and within
  test_torch_gpt.py's tolerances of JAX's (logits and loss 1e-4,
  gradients 1e-4 absolute plus 1e-3 relative).  JAX's reference runs with
  remat off: remat is numerically neutral there too, and the offload
  policies need a host memory space the JAX CPU backend need not have.
- What each policy keeps and what it recomputes, counted by a
  ``TorchDispatchMode`` around the forward and the backward: the
  projections' 2-D products (``aten.mm``) run again in the backward under
  "full" and the *_names policies (all but each block's last, after which
  torch's recompute stops early), and not under "dots"/"offload_dots";
  anchors are ops only under the *_names policies, two a block, and none
  runs again in the backward.
- The offload policies copy to the host exactly the tensors they keep:
  the projections' products, or the anchored ``attn_out``/``mlp_out``
  (and only the ones named), and bring back only such tensors.
- Dropout under remat draws the same masks in the recompute: the
  gradients of a dropout run with remat equal those without, for the same
  generator seed; the deterministic path (dropout > 0, the default)
  equals JAX's model.
- An unknown policy raises JAX's message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlrover_wuqiong_tpu.models import gpt as jgpt
from dlrover_wuqiong_tpu.models import llama as jllama
from dlrover_wuqiong_tpu.ops import remat as jremat
from dlrover_wuqiong_tpu_torch.convert import load_params
from dlrover_wuqiong_tpu_torch.models import gpt as tgpt
from dlrover_wuqiong_tpu_torch.models import llama as tllama
from dlrover_wuqiong_tpu_torch.ops import remat as tremat
from torch_threads import one_torch_thread  # noqa: F401

B, T = 2, 32
POLICIES = ["full", "dots", "offload_dots", "save_names", "offload_names"]
FAMILIES = {
    "gpt": (jgpt.GPT, jgpt.GPTConfig, tgpt.GPT, tgpt.GPTConfig),
    "llama": (jllama.Llama, jllama.LlamaConfig, tllama.Llama,
              tllama.LlamaConfig),
}
#: projections in a block: GPT c_attn, attn c_proj, c_fc, mlp c_proj;
#: Llama q, k, v, o, gate, up, down
DENSE_PER_BLOCK = {"gpt": 4, "llama": 7}
MM = torch.ops.aten.mm


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (B, T + 1))
    labels = ids[:, 1:].copy()
    labels[0, :5] = -1
    return ids[:, :-1], labels


@pytest.fixture(scope="module")
def jparams():
    out = {}
    for fam, (jm, jc, _, _) in FAMILIES.items():
        cfg = dataclasses.replace(jc.nano(), dtype=jnp.float32)
        out[fam] = jax.tree_util.tree_map(
            np.asarray, jax.jit(jm(cfg).init_params)(jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def jax_ref(jparams, batch):
    """JAX's float32 logits, loss and grads, remat off, per family."""
    ids, labels = (jnp.asarray(x) for x in batch)
    out = {}
    for fam, (jm, jc, _, _) in FAMILIES.items():
        model = jm(dataclasses.replace(jc.nano(), dtype=jnp.float32,
                                       remat=False))

        def loss_fn(p):
            logits = model.apply({"params": p}, ids)
            return jgpt.cross_entropy_loss(logits, labels), logits

        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jparams[fam])
        out[fam] = (np.asarray(logits), float(loss),
                    {k: np.asarray(v) for k, v in _paths(grads).items()})
    return out


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))

    def count(self, packet):
        return sum(f.overloadpacket is packet for f in self.ops)


def _run(fam, params, batch, count=False, **kw):
    """(logits, loss, grads, forward ops, backward ops) of the port."""
    _, _, tm, tc = FAMILIES[fam]
    model = load_params(tm(dataclasses.replace(tc.nano(), dtype=torch.float32,
                                               **kw)), params, device="cpu")
    ids, labels = (torch.from_numpy(x) for x in batch)
    fwd, bwd = _Count(), _Count()
    with fwd if count else _nothing():
        logits = model(ids)
        loss = tgpt.cross_entropy_loss(logits, labels)
    with bwd if count else _nothing():
        loss.backward()
    return (logits.detach().numpy(), loss.item(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            fwd, bwd)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def port_off(jparams, batch):
    return {fam: _run(fam, jparams[fam], batch, count=True, remat=False)
            for fam in FAMILIES}


@pytest.mark.parametrize("fam", sorted(FAMILIES))
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_is_bitwise_remat_off_and_matches_jax(
        jparams, batch, jax_ref, port_off, fam, policy):
    tremat.reset_offload_bytes()
    logits, loss, grads, fwd, bwd = _run(fam, jparams[fam], batch,
                                         count=True, remat=True,
                                         remat_policy=policy)
    ol, oloss, ograds, ofwd, obwd = port_off[fam]
    assert np.array_equal(logits, ol) and loss == oloss
    assert sorted(grads) == sorted(ograds)
    for name in grads:
        assert torch.equal(grads[name], ograds[name]), name
    jl, jloss, jg = jax_ref[fam]
    np.testing.assert_allclose(logits, jl, atol=1e-4, rtol=1e-4)
    assert abs(loss - jloss) <= 1e-4
    for name in jg:
        np.testing.assert_allclose(grads[name].numpy(), jg[name], atol=1e-4,
                                   rtol=1e-3, err_msg=name)

    # what the policy kept and what it ran again
    layers = len([n for n in grads if n.endswith("input_norm.scale")
                  or n.endswith("ln_1.scale")])
    dense = DENSE_PER_BLOCK[fam] * layers
    anchor = torch.ops.dwt.checkpoint_name
    assert fwd.count(MM) == ofwd.count(MM)
    rerun = bwd.count(MM) - obwd.count(MM)
    # the recompute stops once every kept-for-backward tensor is back, so
    # a block's last projection (whose output no backward needs) does
    # not run again
    assert rerun == (0 if policy.endswith("dots") else dense - layers)
    assert fwd.count(anchor) == (2 * layers if policy.endswith("names")
                                 else 0)
    assert bwd.count(anchor) == 0
    offloaded = tremat.OFFLOAD_BYTES
    if policy.startswith("offload_"):
        assert offloaded["d2h"] > 0 and 0 < offloaded["h2d"] <= \
            offloaded["d2h"]
    else:
        assert offloaded == {"d2h": 0, "h2d": 0}


def _host_copies(monkeypatch):
    """Shapes of the tensors the offload policies copy each way."""
    seen = {"d2h": [], "h2d": []}
    to_host, to_device = tremat._to_host, tremat._to_device

    def spy_host(t):
        seen["d2h"].append(tuple(t.shape))
        return to_host(t)

    def spy_device(held):
        seen["h2d"].append(tuple(held[0].shape))
        return to_device(held)

    monkeypatch.setattr(tremat, "_to_host", spy_host)
    monkeypatch.setattr(tremat, "_to_device", spy_device)
    return seen


def test_offload_names_copies_only_the_named_anchors(jparams, batch,
                                                     monkeypatch):
    seen = _host_copies(monkeypatch)
    tremat.reset_offload_bytes()
    _run("gpt", jparams["gpt"], batch, remat=True,
         remat_policy="offload_names")
    C = tgpt.GPTConfig.nano().n_embd
    layers = tgpt.GPTConfig.nano().n_layer
    assert seen["d2h"] == [(B, T, C)] * (2 * layers)
    assert seen["h2d"] and set(seen["h2d"]) == {(B, T, C)}
    assert tremat.OFFLOAD_BYTES["d2h"] == 2 * layers * B * T * C * 4
    # one name: only its anchor leaves the device
    seen["d2h"].clear()
    seen["h2d"].clear()
    _run("gpt", jparams["gpt"], batch, remat=True,
         remat_policy="offload_names", remat_names=("attn_out",))
    assert seen["d2h"] == [(B, T, C)] * layers


def test_offload_dots_copies_only_the_projections(jparams, batch,
                                                  monkeypatch):
    seen = _host_copies(monkeypatch)
    _run("gpt", jparams["gpt"], batch, remat=True,
         remat_policy="offload_dots")
    C = tgpt.GPTConfig.nano().n_embd
    per_block = [(B * T, 3 * C), (B * T, C), (B * T, 4 * C), (B * T, C)]
    assert seen["d2h"] == per_block * tgpt.GPTConfig.nano().n_layer
    assert seen["h2d"] and set(seen["h2d"]) <= set(per_block)


@pytest.mark.parametrize("policy", ["full", "dots", "offload_names"])
def test_dropout_under_remat_draws_the_same_masks(jparams, policy):
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (B, T)))
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tgpt.GPTConfig.nano(), dtype=torch.float32,
                                  dropout=0.25, remat=remat,
                                  remat_policy=policy)
        model = load_params(tgpt.GPT(cfg), jparams["gpt"], device="cpu")
        gen = torch.Generator().manual_seed(11)
        out = model(ids, deterministic=False, generator=gen)
        (out.float() ** 2).mean().backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for name in grads[False]:
        assert torch.equal(grads[True][name], grads[False][name]), name
    # dropout did act: the deterministic path gives other gradients
    model = load_params(tgpt.GPT(cfg), jparams["gpt"], device="cpu")
    (model(ids).float() ** 2).mean().backward()
    assert not torch.equal(model.h_0.attn.c_attn.kernel.grad,
                           grads[True]["h_0.attn.c_attn.kernel"])


def test_dropout_semantics_are_flax():
    x = torch.ones(4096)
    gen = torch.Generator().manual_seed(0)
    y = tgpt.dropout(x, 0.25, gen)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    assert torch.equal(tgpt.dropout(x, 1.0, gen), torch.zeros_like(x))
    assert tgpt.dropout(x, 0.25, None) is x


def test_dropout_deterministic_path_matches_jax(jparams, batch, jax_ref):
    logits, loss, grads, _, _ = _run("gpt", jparams["gpt"], batch,
                                     dropout=0.1, remat=True)
    jl, jloss, jg = jax_ref["gpt"]
    np.testing.assert_allclose(logits, jl, atol=1e-4, rtol=1e-4)
    assert abs(loss - jloss) <= 1e-4
    for name in jg:
        np.testing.assert_allclose(grads[name].numpy(), jg[name], atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_anchor_is_identity_outside_a_named_policy():
    x = torch.randn(3, 4)
    assert tremat.checkpoint_name(x, "attn_out") is x


def test_unknown_policy_raises_the_jax_message():
    with pytest.raises(ValueError) as jerr:
        jremat.resolve_remat_policy("everything")
    with pytest.raises(ValueError) as terr:
        tremat.resolve_remat_policy("everything")
    assert str(terr.value) == str(jerr.value)
    assert tremat.MODEL_CHECKPOINT_NAMES == jremat.MODEL_CHECKPOINT_NAMES
    for fam in FAMILIES:
        cfg = dataclasses.replace(FAMILIES[fam][3].nano(),
                                  remat_policy="everything")
        with pytest.raises(ValueError, match="unknown remat policy"):
            FAMILIES[fam][2](cfg)
