"""WeightedSAM (KDD'23): sharpness-aware minimization with weighted
sharpness as a regularization term.

Parity: dlrover_wuqiong_tpu/optimizers/wsam.py — `wsam_gradients`
(:28-64) and `make_wsam_train_step` (:67-86).  Two passes a step:

    g1 = grad L(w)
    e  = rho * P g1 / ||sqrt(P) g1||      (P = diag(w^2) if adaptive else I)
    g2 = grad L(w + e)
    decouple:  base update with g1, then w -= lr * alpha * (g2 - g1)
    coupled:   base update with alpha * g2 + (1 - alpha) * g1

with alpha = gamma / (1 - gamma).  The base optimizer is the state's
(``state.opt_state``), as in `trainer.train_step.make_train_step`.

torch holds the parameters in place, so the second pass runs on the
parameters moved to ``w + e`` and they are then written back from a
saved copy of ``w`` (``p += e; ...; p -= e`` would not give w back in
floating point).  Both passes must draw the same dropout masks, as
JAX's two calls of one loss on one key do: the step saves the state of
the generators that the loss draws from (`generators`; by default
torch's default generator of each parameter's device) before the first
pass and restores it before the second.  The loss returned is the first
pass's.

The step takes a one-device state: on a mesh (a state from a sharded
``auto_accelerate``) the perturbation's norm and the loss would be the
rank's own, so it raises there.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def _generators(model: torch.nn.Module,
                generators: Optional[Sequence[torch.Generator]]
                ) -> List[torch.Generator]:
    if generators is not None:
        return list(generators)
    out, seen = [], set()
    for p in model.parameters():
        d = p.device
        if d in seen:
            continue
        seen.add(d)
        out.append(torch.cuda.default_generators[d.index or 0]
                   if d.type == "cuda" else torch.default_generator)
    return out


def wsam_gradients(loss_fn: Callable, model: torch.nn.Module, batch: Dict,
                   rho: float = 0.05, gamma: float = 0.9,
                   sam_eps: float = 1e-12, adaptive: bool = False,
                   decouple: bool = True,
                   generators: Optional[Sequence[torch.Generator]] = None
                   ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]],
                              Optional[List[Optional[torch.Tensor]]]]:
    """(loss, grads for the base optimizer, sharpness or None), the
    grads per parameter of `model` in its order; the parameters are `w`
    again when it returns, and their ``.grad`` is unset."""
    alpha = gamma / (1.0 - gamma)
    params = list(model.parameters())
    gens = _generators(model, generators)
    rng = [g.get_state() for g in gens]
    for p in params:
        p.grad = None
    loss = loss_fn(model, batch)
    loss.backward()
    loss = loss.detach().float()
    g1 = [p.grad for p in params]
    live = [(p, g) for p, g in zip(params, g1) if g is not None]

    with torch.no_grad():
        if adaptive:
            weighted = [p * p * g for p, g in live]
            sq = [(p * g) ** 2 for p, g in live]
        else:
            weighted = [g for _, g in live]
            sq = [g * g for _, g in live]
        norm_sq = sq[0].sum()
        for s in sq[1:]:
            norm_sq = norm_sq + s.sum()
        del sq
        # a tensor dividend: torch computes ``rho / t`` as a multiply by
        # the reciprocal of t, where jnp divides
        scale = torch.full_like(norm_sq, rho) / (torch.sqrt(norm_sq)
                                                 + sam_eps)
        saved = [p.detach().clone() for p in params]
        for (p, _), w in zip(live, weighted):
            p.add_(w * scale)
        del weighted

    for p in params:
        p.grad = None
    for g, s in zip(gens, rng):
        g.set_state(s)
    loss_fn(model, batch).backward()
    g2 = [p.grad for p in params]
    with torch.no_grad():
        for p, w in zip(params, saved):
            p.copy_(w)
            p.grad = None
    del saved

    if decouple:
        sharp = [None if a is None else b - a for a, b in zip(g1, g2)]
        return loss, g1, sharp
    combined = [None if a is None else alpha * b + (1 - alpha) * a
                for a, b in zip(g1, g2)]
    return loss, combined, None


def make_wsam_train_step(loss_fn: Callable, learning_rate: float,
                         rho: float = 0.05, gamma: float = 0.9,
                         sam_eps: float = 1e-12, adaptive: bool = False,
                         decouple: bool = True,
                         generators: Optional[Sequence[torch.Generator]]
                         = None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` with the WSAM scheme
    around the state's optimizer, in the shape of `make_train_step`:
    metrics ``loss`` (the first pass's) and ``grad_norm`` (of the grads
    the base optimizer takes), device tensors.  `learning_rate` is the
    decoupled sharpness term's (the reference reads it off the param
    group)."""
    from ..trainer import train_step as ts

    alpha = gamma / (1.0 - gamma)

    def step(state, batch):
        if state.mesh_state is not None:
            raise NotImplementedError(
                "WSAM over a mesh is not ported: its perturbation norm and "
                "loss would be each rank's own")
        model, opt = state.params, state.opt_state
        params = list(model.parameters())
        loss, grads, sharp = wsam_gradients(
            loss_fn, model, batch, rho=rho, gamma=gamma, sam_eps=sam_eps,
            adaptive=adaptive, decouple=decouple, generators=generators)
        for p, g in zip(params, grads):
            p.grad = g
        gnorm = ts.global_norm([g for g in grads if g is not None])
        ts.optimizer_step(opt)
        if sharp is not None:
            with torch.no_grad():
                for p, s in zip(params, sharp):
                    if s is not None:
                        p.sub_(s * (learning_rate * alpha))
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return step
