"""Activation-sharding context.

Counterpart of ``repro/models/shard_ctx.py``.  Models are mesh-agnostic;
the launcher installs a constrainer that maps logical activation names
to a layout on the mesh (``launch.sharding.with_mesh_constraints``: a
DTensor is redistributed to the name's placements, the counterpart of
``jax.lax.with_sharding_constraint``).  The default is the identity
(one device, the tests).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

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
