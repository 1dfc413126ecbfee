"""Optimizers as transformations of named tensors.

Counterpart of ``repro/optim/optimizers.py``: sgd, momentum (with
Nesterov), adam (with decoupled weight decay and a state dtype), adamw,
adafactor (factored second moment), the combinators chain,
clip_by_global_norm and scale_by_schedule, and global_norm.  Each is
written out as the reference writes it rather than with ``torch.optim``
(e.g. Adam's eps is added outside the square root of the bias-corrected
second moment), and the scalar arithmetic the reference does in float32
on its step count is done in float32 here.

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)

``params``, ``grads`` and ``updates`` are dicts of tensors keyed by
parameter name; a state holds tensors keyed the same way (momentum's is
such a dict, sgd's and clip_by_global_norm's the empty tuple).  A step
count is a Python int.

Adafactor factors the trailing two axes of every leaf of two or more
dims and clips each leaf's step by its RMS, so it is the one optimizer
whose function depends on a leaf's layout.  ``adafactor(layout=...)``
takes, per parameter name, the pair of maps (to the reference's layout,
back) under which it computes: the CNN's (``models.cnn.reference_layout``)
carries its OIHW convs and (out, in) dense kernels to the reference's
HWIO and (in, out), so the factored moments are the reference's, on its
axes, and checkpoints hold them as it does.  ``adafactor(groups=...)``
steps leaves the reference stacks into one: the zoo's reference keeps
each pattern position's repeats as one (n_body, ...) leaf, where the
port keeps one leaf per layer (``models.model.stacked_groups``), so each
group is stepped as the stack of its members, clipped by the RMS over
the whole stack, a 1-D member factored jointly as (n_body, d), and its
state has the reference's stacked shape, keyed by the group's name.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterator, Mapping, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
State = Any
#: name -> (to the reference's layout, back to the port's)
Layout = Dict[str, Tuple[Callable[[torch.Tensor], torch.Tensor],
                         Callable[[torch.Tensor], torch.Tensor]]]
#: group name -> its members' parameter names, in stacking order
Groups = Mapping[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    init: Callable[[Tensors], State]
    update: Callable[..., Tuple[Tensors, State]]
    #: each leaf's update reads only that leaf's gradient, state and
    #: parameter (sgd, momentum, adam, adafactor; not a chain or a clip
    #: by global norm), so it can be applied one leaf at a time
    #: (``models.model.apply_optimizer``)
    per_leaf: bool = False
    #: leaves stepped together, as one stacked leaf (adafactor's
    #: ``groups``): ``apply_optimizer`` hands a group's members to
    #: ``update`` at once, and the state holds the group under its name
    groups: Groups = dataclasses.field(default_factory=dict)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """params += updates, in place (the parameters are the model's own
    tensors, so the module sees the step without a copy); the sum is
    cast to each parameter's dtype, as the reference's is."""
    for name, p in params.items():
        p.add_(updates[name])
    return params


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _f32(x: float) -> np.float32:
    return np.float32(x)


# ------------------------------------------------------------------ basic

def sgd(lr: float) -> GradientTransformation:
    def init(params: Tensors) -> tuple:
        return ()

    @torch.no_grad()
    def update(grads: Tensors, state: tuple, params: Optional[Tensors] = None):
        return {n: -lr * g for n, g in grads.items()}, state

    return GradientTransformation(init, update, per_leaf=True)


def momentum(lr: float, beta: float = 0.9,
             nesterov: bool = False) -> GradientTransformation:
    def init(params: Tensors) -> Tensors:
        return {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def update(grads: Tensors, state: Tensors,
               params: Optional[Tensors] = None):
        new_m = {n: beta * state[n] + g for n, g in grads.items()}
        if nesterov:
            upd = {n: -lr * (beta * new_m[n] + g) for n, g in grads.items()}
        else:
            upd = {n: -lr * m for n, m in new_m.items()}
        return upd, new_m

    return GradientTransformation(init, update, per_leaf=True)


# ------------------------------------------------------------------- adam

class AdamState(NamedTuple):
    count: int
    mu: Tensors
    nu: Tensors


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0,
         state_dtype: torch.dtype = torch.float32) -> GradientTransformation:
    """Adam / AdamW (decoupled decay when weight_decay > 0)."""

    def init(params: Tensors) -> AdamState:
        def zeros():
            return {n: torch.zeros_like(p, dtype=state_dtype)
                    for n, p in params.items()}
        return AdamState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(grads: Tensors, state: AdamState,
               params: Optional[Tensors] = None):
        count = state.count + 1
        mu = {n: b1 * state.mu[n] + (1 - b1) * g.to(state_dtype)
              for n, g in grads.items()}
        nu = {n: b2 * state.nu[n] + (1 - b2) * g.to(state_dtype) ** 2
              for n, g in grads.items()}
        # float32 bias corrections, 1 - b^count, as the reference's
        # count.astype(float32) computes them
        c = _f32(count)
        bc1 = float(_f32(1.0) - _f32(b1) ** c)
        bc2 = float(_f32(1.0) - _f32(b2) ** c)
        updates = {}
        for n in grads:
            step = mu[n] / bc1 / (torch.sqrt(nu[n] / bc2) + eps)
            if weight_decay and params is not None:
                step = step + weight_decay * params[n].to(state_dtype)
            updates[n] = -lr * step
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update, per_leaf=True)


def adamw(lr: float, weight_decay: float = 0.01,
          **kw) -> GradientTransformation:
    return adam(lr, weight_decay=weight_decay, **kw)


# -------------------------------------------------------------- adafactor

class AdafactorState(NamedTuple):
    count: int
    vr: Tensors  # row second moment (or the full v of a leaf under 2-D)
    vc: Tensors  # column second moment (a 0-d zero for a leaf under 2-D)


def _as_rows_of(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A factored moment ``x`` (size 1 in one of g's trailing two dims)
    laid out as the gradient ``g`` is, where they are DTensors, so that
    their product (the second-moment estimate) is split as g is: a
    moment's own layout (v_r split by rows, v_c by columns) would leave
    DTensor to split the product by the stack of a group's members, and
    each member's step would then be gathered whole.  A plain tensor as
    it is."""
    if not hasattr(x, "placements"):
        return x
    from torch.distributed.tensor import Replicate, Shard
    placements = [pl if isinstance(pl, Shard) and x.shape[pl.dim] > 1
                  else Replicate() for pl in g.placements]
    return x.redistribute(x.device_mesh, placements)


def adafactor(lr: float, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, layout: Optional[Layout] = None,
              groups: Optional[Groups] = None) -> GradientTransformation:
    """Factored second-moment estimator (Shazeer & Stern, 2018).

    The state of an (.., R, C) leaf is (.., R) + (.., C) floats; a leaf
    of under two dims keeps its full second moment.  ``layout``: per
    parameter name, (to_ref, from_ref) maps under which the leaf is
    factored (see the module docstring); other leaves are factored as
    they are.  ``groups``: per group name, the names of the leaves
    stepped as one stacked leaf (the module docstring); ``init`` and
    ``update`` take all of a group's members or none of them.
    """
    layout = layout or {}
    groups = {g: tuple(ms) for g, ms in (groups or {}).items()}
    group_of = {m: g for g, ms in groups.items() for m in ms}

    def ref(name: str, t: torch.Tensor) -> torch.Tensor:
        return layout[name][0](t) if name in layout else t

    def units(tensors: Tensors) -> Iterator[Tuple[str, Tuple[str, ...]]]:
        """(state key, member names) of each leaf or group in
        ``tensors``: a leaf alone, or a whole group at its first
        member."""
        for n in tensors:
            g = group_of.get(n)
            if g is None:
                yield n, (n,)
            elif n == groups[g][0]:
                missing = [m for m in groups[g] if m not in tensors]
                if missing:
                    raise ValueError(f"adafactor group {g!r} misses "
                                     f"{missing}")
                yield g, groups[g]
            elif groups[g][0] not in tensors:
                raise ValueError(f"adafactor group {g!r} misses "
                                 f"{groups[g][0]!r}")

    def stacked(key: str, members: Tuple[str, ...],
                tensors: Tensors) -> torch.Tensor:
        """The leaf, or the group's members stacked on a new axis 0."""
        ts = [ref(m, tensors[m]) for m in members]
        if key not in groups:
            return ts[0]
        return ts[0][None] if len(ts) == 1 else torch.stack(ts)

    def init(params: Tensors) -> AdafactorState:
        vr, vc = {}, {}
        for key, members in units(params):
            p = params[members[0]]
            shape = tuple(ref(members[0], p).shape)
            if key in groups:
                shape = (len(members),) + shape
            if len(shape) >= 2:
                vr[key] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=p.device)
                vc[key] = torch.zeros(shape[:-2] + shape[-1:],
                                      dtype=torch.float32, device=p.device)
            else:
                vr[key] = torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
                vc[key] = torch.zeros((), dtype=torch.float32,
                                      device=p.device)
        return AdafactorState(count=0, vr=vr, vc=vc)

    @torch.no_grad()
    def update(grads: Tensors, state: AdafactorState,
               params: Optional[Tensors] = None):
        count = state.count + 1
        # 1 - count^-decay in float32, as the reference computes it
        beta = float(_f32(1.0) - _f32(count) ** _f32(-decay))
        updates, new_vr, new_vc = {}, {}, {}
        for key, members in units(grads):
            g = stacked(key, members, grads).float()
            g2 = g * g + eps
            vr, vc = state.vr[key], state.vc[key]
            if g.ndim >= 2:
                vr = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                v_est = (_as_rows_of(vr[..., :, None], g)
                         * _as_rows_of(vc[..., None, :], g)
                         / denom[..., None])
                step = g / torch.sqrt(v_est + eps)
            else:
                vr = beta * vr + (1 - beta) * g2
                step = g / torch.sqrt(vr + eps)
            del g, g2
            # update clipping (RMS <= clip_threshold), over the whole
            # stack of a group
            rms = torch.sqrt(torch.mean(step * step) + eps)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            step = -lr * step
            for i, m in enumerate(members):
                s = step[i] if key in groups else step
                updates[m] = layout[m][1](s) if m in layout else s
            new_vr[key], new_vc[key] = vr, vc
        return updates, AdafactorState(count=count, vr=new_vr, vc=new_vc)

    return GradientTransformation(init, update, per_leaf=True, groups=groups)


# ------------------------------------------------------------ combinators

def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params: Tensors) -> tuple:
        return tuple(t.init(params) for t in transforms)

    def update(grads: Tensors, state: tuple,
               params: Optional[Tensors] = None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params: Tensors) -> tuple:
        return ()

    @torch.no_grad()
    def update(grads: Tensors, state: tuple,
               params: Optional[Tensors] = None):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return {n: g * scale for n, g in grads.items()}, state

    return GradientTransformation(init, update)


def scale_by_schedule(schedule: Callable[[int], torch.Tensor]
                      ) -> GradientTransformation:
    """Multiplies the updates by ``schedule(step)``; the state is the
    step count."""
    def init(params: Tensors) -> int:
        return 0

    @torch.no_grad()
    def update(grads: Tensors, state: int, params: Optional[Tensors] = None):
        scale = schedule(state)
        return {n: g * scale.to(g.device) for n, g in grads.items()}, \
            state + 1

    return GradientTransformation(init, update)
