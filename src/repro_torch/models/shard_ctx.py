"""Activation-sharding context.

Counterpart of ``repro/models/shard_ctx.py``.  Models are mesh-agnostic;
the launcher installs a constrainer that maps logical activation names
to a layout on the mesh (``launch.sharding.with_mesh_constraints``: a
DTensor is redistributed to the name's placements, the counterpart of
``jax.lax.with_sharding_constraint``).  The default is the identity
(one device, the tests).

The launcher also installs a relayout (``relayout``, ``view_as``,
``replicated``): the port's own layout steps, at the sites where the
reference leaves a layout to XLA's partitioner (a view that splits a
sharded dim, a per-example vector read whole).  They are not the
reference's constraints, so a constrainer that records the reference's
sequence does not see them; on plain tensors they do nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor

_constrainer: contextvars.ContextVar[Callable[[Tensor, str], Tensor]] = \
    contextvars.ContextVar("constrainer", default=lambda x, name: x)


def constrain(x: Tensor, name: str) -> Tensor:
    """Apply the active sharding constraint for logical name ``name``.

    Names used by the zoo: "act_btd" (batch, seq, d_model),
    "act_btf" (ffn hidden), "act_bthd" (per-head), "logits_btv",
    "kv_cache", "moe_ecd" (expert, capacity, d).
    """
    return _constrainer.get()(x, name)


@contextlib.contextmanager
def use_constrainer(fn: Callable[[Tensor, str], Tensor]):
    token = _constrainer.set(fn)
    try:
        yield
    finally:
        _constrainer.reset(token)


_relayout: contextvars.ContextVar[
    Callable[[Tensor, str, Optional[Tuple[int, ...]]], Tensor]] = \
    contextvars.ContextVar("relayout", default=lambda x, name, shape=None: x)


def relayout(x: Tensor, name: Optional[str],
             shape: Optional[Tuple[int, ...]] = None) -> Tensor:
    """``x`` laid out for its view as ``shape`` (x's own shape if None)
    as the constraint ``name`` lays out that view (``"replicated"``:
    whole on every rank; ``"rows"``: its last dim whole; None: see
    ``view_as``)."""
    return _relayout.get()(x, name, shape)


def view_as(x: Tensor, shape: Tuple[int, ...],
            name: Optional[str]) -> Tensor:
    """``x.reshape(shape)``, on a mesh laid out first so that the view
    runs on each rank's shard and comes out as the constraint ``name``
    lays it out (a projection (B, S, H Dh) split 16 ways cannot be viewed
    as (B, S, H, Dh) shard by shard where H = 24); with name None, x's
    splits that the view can keep are kept, the others gathered (a
    weight's view)."""
    return relayout(x, name, shape).reshape(shape)


def replicated(x: Tensor) -> Tensor:
    """``x`` whole on every rank of a mesh; a plain tensor as it is."""
    return relayout(x, "replicated")


def layout_placements(name: str, shape: Tuple[int, ...]) -> Optional[tuple]:
    """The DTensor placements that the installed constraints give a
    tensor of logical name ``name`` and ``shape``; None where no mesh
    layout is installed."""
    fn = getattr(_relayout.get(), "placements", None)
    return None if fn is None else fn(name, shape)


@contextlib.contextmanager
def use_relayout(fn: Callable[[Tensor, str, Optional[Tuple[int, ...]]],
                              Tensor]):
    token = _relayout.set(fn)
    try:
        yield
    finally:
        _relayout.reset(token)
