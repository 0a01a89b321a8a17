"""Sequence parallelism: attention over a sequence sharded on the mesh's
``sp`` dim, as ring attention, Ulysses, or gathered keys and values.

Parity: dlrover_wuqiong_tpu/parallel/long_context.py — `_qkv_spec`
(:70, here `_batch_dims`), `_attention_with_lse` (:91),
`_merge_partials` (:101), `_ring_attention_local` (:128),
`ring_attention` (:158), `_ulysses_local` (:181) and
`ulysses_attention` (:199), with the same schedules, numbers and
messages.

The JAX package writes each schedule as a per-device body under
``shard_map``; the port runs the same body on each rank of a
``torch.distributed`` world, on this rank's chunk of the sequence, with
the collectives as autograd Functions whose backward is the collective's
transpose:

- ring: `_Shift` hands every rank its left neighbour's keys and values
  (``dist.batch_isend_irecv`` to the next rank); its backward sends the
  cotangents the other way, as ``ppermute``'s transpose does.
- Ulysses: `_AllToAll` scatters heads and gathers the sequence; its
  backward is the inverse all-to-all.
- "gspmd" (the JAX package leaves the gather to XLA): `_Gather`
  all-gathers keys and values over ``sp``; its backward reduce-scatters.

Each local body takes its transport as an argument (``rotate``,
``a2a``, ``gather``), so one process can drive the same body for every
emulated rank (`emulated`): NCCL puts no two ranks on one card, and the
chip check runs the schedules this way.

Every chunk's attention is the port's
`ops.flash_attention.flash_attention_with_lse`: the forward with lse and,
under the ring's merge, a backward with a nonzero lse cotangent; the CUDA
kernels on a CUDA tensor, their plain versions on a CPU tensor.  With
``sp`` 1 every impl is `flash_attention`, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.flash_attention import (_fa_forward_plain, _resolve_scale,
                                   flash_attention, flash_attention_with_lse)
from .sharding import mesh_sizes

_BATCH_AXES = ("dp", "fsdp")  # the mesh's data dims (parallel/mesh.py)


def _batch_dims(mesh, batch_size: int) -> Tuple[str, ...]:
    """The data dims that shard a global batch of `batch_size` rows:
    JAX's `_qkv_spec` keeps each dim of size > 1 whose product with the
    ones before it divides the batch, and drops the others."""
    sizes = mesh_sizes(mesh)
    out, div = [], 1
    for a in _BATCH_AXES:
        n = sizes.get(a, 1)
        if n > 1 and batch_size % (div * n) == 0:
            out.append(a)
            div *= n
    return tuple(out)


# ------------------------------------------------------------ lse math


def _attention_with_lse(q, k, v, causal: bool, sm_scale: Optional[float]):
    """Plain (b, h, sq, d) attention returning (o, lse (b, h, sq)
    float32, natural log): the ops' plain forward, as JAX's is a call to
    its ops' `_reference_with_lse`.  A row with no visible key gives
    o = 0, lse = -inf."""
    b, h, sq, d = q.shape
    o, lse = _fa_forward_plain(
        *(t.reshape(b * h, t.shape[2], d) for t in (q, k, v)), causal,
        _resolve_scale(sm_scale, d))
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


def _merge_partials(o1, lse1, o2, lse2):
    """Combine two attention partials over disjoint key sets by their
    float32 log-sum-exps; a ``-inf`` partial weighs 0."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(torch.isfinite(lse1), torch.exp(lse1 - m_safe), 0.0)
    w2 = torch.where(torch.isfinite(lse2), torch.exp(lse2 - m_safe), 0.0)
    tot = w1 + w2
    tot_safe = torch.where(tot > 0, tot, 1.0)
    o = (o1.float() * (w1 / tot_safe)[..., None]
         + o2.float() * (w2 / tot_safe)[..., None])
    lse = torch.where(tot > 0, m_safe + torch.log(tot_safe), -math.inf)
    return o.to(o1.dtype), lse


# ------------------------------------------------------------ transports


def _peer(group, offset: int) -> int:
    """The global rank `offset` places along `group`'s ring from this
    rank."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    return dist.get_global_rank(group, (me + offset) % n)


def _shift(xs, group, step: int) -> tuple:
    """Each tensor of `xs` sent `step` ranks on along `group`'s ring, the
    tensors of the rank `step` places back received in their place."""
    xs = [x.contiguous() for x in xs]
    out = [torch.empty_like(x) for x in xs]
    dst, src = _peer(group, step), _peer(group, -step)
    ops = [dist.P2POp(dist.isend, x, dst, group) for x in xs] + \
        [dist.P2POp(dist.irecv, y, src, group) for y in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(out)


class _Shift(torch.autograd.Function):
    """One ring step: each rank gets its left neighbour's tensors; the
    backward sends the cotangents to the left (``ppermute``'s
    transpose)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return _shift(xs, group, 1)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_shift(gs, ctx.group, -1))


def _all_to_all(x, group, split: int, concat: int):
    """JAX's tiled ``all_to_all``: chunk i of `split` goes to rank i, and
    the chunks received are concatenated along `concat` in rank order."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x, split: int, concat: int):
        ctx.args = (group, split, concat)
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, split, concat = ctx.args
        return None, _all_to_all(g, group, concat, split), None, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` over `group`; the backward reduce-scatters
    the cotangent (each rank's chunk summed over the ranks)."""

    @staticmethod
    def forward(ctx, group, x, dim: int):
        n = dist.get_world_size(group)
        ctx.args = (group, dim, n)
        buf = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(buf, x.contiguous(), group=group)
        return torch.cat(buf.chunk(n, 0), dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, n = ctx.args
        send = torch.cat(g.chunk(n, dim), 0).contiguous()
        out = torch.empty_like(send.chunk(n, 0)[0])
        dist.reduce_scatter_tensor(out, send, group=group)
        return None, out, None


def ring_rotation(group) -> Callable:
    """The ring's transport over `group`: ``rotate((k, v), t)`` is the
    pair this rank holds after step t, given the pair after t - 1."""
    return lambda kv, t: _Shift.apply(group, *kv)


def seq_all_to_all(group) -> Callable:
    """Ulysses' transport: ``a2a(x, split, concat)`` over `group`."""
    return lambda x, split, concat: _AllToAll.apply(group, x, split, concat)


def seq_gather(group) -> Callable:
    """The gathered route's transport: ``gather((k, v))`` is every rank's
    k and v, concatenated along the sequence in rank order."""
    return lambda kv: tuple(_Gather.apply(group, x, 2) for x in kv)


# ------------------------------------------------------------ local bodies


def _ring_attention_local(q, k, v, *, my: int, n: int, causal: bool,
                          sm_scale: Optional[float], rotate: Callable,
                          with_lse: bool = False):
    """Rank `my`'s body: q/k/v (b, h, s, d) its chunk of the sequence.
    Step 0 attends the local chunk (causal within); step t attends the
    visiting chunk src = (my - t) mod n without the mask, its lse set to
    -inf where src > my (computed, then weighed 0: JAX's schedule).  The
    accumulator stays float32 across the merges.  With `with_lse`,
    (o, the merged lse)."""
    o0, lse = flash_attention_with_lse(q, k, v, causal, sm_scale)
    o = o0.float()
    kv = (k, v)
    for t in range(1, n):
        kv = rotate(kv, t)
        src = (my - t) % n
        oc, lc = flash_attention_with_lse(q, *kv, False, sm_scale)
        if causal and src > my:
            lc = torch.full_like(lc, -math.inf)
        o, lse = _merge_partials(o, lse, oc, lc)
    o = o.to(q.dtype)
    return (o, lse) if with_lse else o


def _ulysses_local(q, k, v, *, causal: bool, sm_scale: Optional[float],
                   a2a: Callable, with_lse: bool = False):
    """Rank body: (b, h, s, d) -> all-to-all to (b, h/sp, S, d), the whole
    sequence's attention over this rank's heads, the inverse
    all-to-all (of the lse too, with `with_lse`)."""
    qh, kh, vh = (a2a(t, 1, 2) for t in (q, k, v))
    o, lse = flash_attention_with_lse(qh, kh, vh, causal, sm_scale)
    o = a2a(o, 2, 1)
    return (o, a2a(lse[..., None], 2, 1)[..., 0]) if with_lse else o


def _gathered_local(q, k, v, *, my: int, causal: bool,
                    sm_scale: Optional[float], gather: Callable,
                    with_lse: bool = False):
    """Rank `my`'s body: every rank's keys and values gathered; causal,
    only the prefix [0, (my + 1) s) counts, and the kernels' causal mask
    (aligned to the bottom right) makes local q against that prefix the
    global causal attention."""
    kf, vf = gather((k, v))
    if causal:
        end = (my + 1) * q.shape[2]
        kf, vf = kf[:, :, :end], vf[:, :, :end]
    o, lse = flash_attention_with_lse(q, kf, vf, causal, sm_scale)
    return (o, lse) if with_lse else o


# ------------------------------------------------------------ entry points


def _sp(mesh, axis: str) -> Tuple[int, int, object]:
    """(size, this rank's coordinate, group) of `mesh`'s `axis`."""
    n = mesh_sizes(mesh).get(axis, 1)
    if n == 1:
        return 1, 0, None
    return n, mesh.get_local_rank(axis), mesh.get_group(axis)


def ring_attention(q, k, v, mesh, causal: bool = True,
                   sm_scale: Optional[float] = None, axis: str = "sp"):
    """Context-parallel attention: q/k/v (b, h, s, d) this rank's chunk of
    a sequence sharded over `axis`; returns this rank's (b, h, s, d)."""
    n, my, group = _sp(mesh, axis)
    if n == 1:
        return flash_attention(q, k, v, causal, sm_scale)
    return _ring_attention_local(q, k, v, my=my, n=n, causal=causal,
                                 sm_scale=sm_scale,
                                 rotate=ring_rotation(group))


def ulysses_attention(q, k, v, mesh, causal: bool = True,
                      sm_scale: Optional[float] = None, axis: str = "sp"):
    """Ulysses sequence parallel attention: heads must divide the axis
    size; each rank attends the whole sequence over h/sp heads."""
    n = mesh_sizes(mesh).get(axis, 1)
    if n == 1:
        return flash_attention(q, k, v, causal, sm_scale)
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[1]}) divisible by {axis}={n}")
    _, _, group = _sp(mesh, axis)
    return _ulysses_local(q, k, v, causal=causal, sm_scale=sm_scale,
                          a2a=seq_all_to_all(group))


def gathered_attention(q, k, v, mesh, causal: bool = True,
                       sm_scale: Optional[float] = None, axis: str = "sp"):
    """The "gspmd" impl: keys and values all-gathered over `axis`, local
    queries against them."""
    n, my, group = _sp(mesh, axis)
    if n == 1:
        return flash_attention(q, k, v, causal, sm_scale)
    return _gathered_local(q, k, v, my=my, causal=causal, sm_scale=sm_scale,
                           gather=seq_gather(group))


#: ``attn_impl`` -> the attention over a mesh's ``sp``
SP_ATTENTION = {"ring": ring_attention, "ulysses": ulysses_attention,
                "gspmd": gathered_attention}


def seq_offset(mesh, seq_local: int, axis: str = "sp") -> int:
    """The global position of this rank's first token: its coordinate on
    `axis` times the chunk length (0 without a mesh)."""
    if mesh is None or mesh_sizes(mesh).get(axis, 1) == 1:
        return 0
    return mesh.get_local_rank(axis) * seq_local


# ------------------------------------------------------------ one process


def emulated(impl: str, qs: Sequence[torch.Tensor],
             ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
             causal: bool = True, sm_scale: Optional[float] = None,
             with_lse: bool = False) -> List:
    """Every rank's output of `impl` (with `with_lse`, (output, lse)) for
    an emulated sp world of ``len(qs)`` ranks in this process, rank r
    holding qs[r], ks[r], vs[r]: the local bodies above with only the
    transport swapped for tensor ops, in one autograd graph.  Ring and gathered run each
    rank's body in turn (rank `my`'s step t reads rank (my - t) mod n's
    chunk); Ulysses' all-to-all needs every rank's intermediate, so its
    body runs once over the ranks stacked on the batch axis, the
    exchange a reshuffle of that axis."""
    n = len(qs)
    if impl == "ring":
        return [_ring_attention_local(
            qs[my], ks[my], vs[my], my=my, n=n, causal=causal,
            sm_scale=sm_scale, with_lse=with_lse,
            rotate=lambda kv, t, my=my: (ks[(my - t) % n], vs[(my - t) % n]))
            for my in range(n)]
    if impl == "gspmd":
        return [_gathered_local(
            qs[my], ks[my], vs[my], my=my, causal=causal, sm_scale=sm_scale,
            with_lse=with_lse,
            gather=lambda kv: (torch.cat(list(ks), 2), torch.cat(list(vs), 2)))
            for my in range(n)]
    assert impl == "ulysses", impl
    if qs[0].shape[1] % n:
        raise ValueError(
            f"ulysses needs heads ({qs[0].shape[1]}) divisible by sp={n}")
    b = qs[0].shape[0]

    def a2a(x, split, concat):
        # x: the ranks' tensors stacked on the batch axis; rank r gets
        # chunk r of `split` from every rank, concatenated along `concat`
        per = x.chunk(n, 0)
        return torch.cat([torch.cat([p.chunk(n, split)[r] for p in per],
                                    concat) for r in range(n)], 0)

    out = _ulysses_local(torch.cat(list(qs)), torch.cat(list(ks)),
                         torch.cat(list(vs)), causal=causal,
                         sm_scale=sm_scale, a2a=a2a, with_lse=with_lse)
    if with_lse:
        return list(zip(out[0].split(b, 0), out[1].split(b, 0)))
    return list(out.split(b, 0))
