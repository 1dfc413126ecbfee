"""The kernels on DTensors: each runs on its local shards.

A kernel is a ``torch.library`` custom op on plain tensors.  Given
DTensors (the launch layer's sharded params and activations), its
wrapper picks the placements the kernel can run under, one per mesh
dimension (a ``Shard`` of a dimension the kernel treats independently,
else ``Replicate``), and calls it through ``local_map``, which first
redistributes any input held otherwise (the collective that XLA would
insert before a sharded custom call).  ``local_map``'s keyword names
differ between torch releases, so only the ones this release accepts
are passed.
"""
from __future__ import annotations

import inspect
from typing import Callable, Sequence, Tuple

import torch

Tensor = torch.Tensor


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def on_mesh(x: Tensor, mesh) -> Tensor:
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain
    tensor (whole on every rank) replicated."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_range(x, dim: int, placements=None) -> Tuple[int, int]:
    """(first index, length) of this rank's shard of DTensor ``x`` along
    ``dim`` under ``placements`` (x's own by default), which split it
    evenly (``Shard(dim)`` on mesh dims in mesh order, as every rule of
    the launch layer splits)."""
    from torch.distributed.tensor import Shard
    mesh, index, count = x.device_mesh, 0, 1
    for m, pl in enumerate(x.placements if placements is None
                           else placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            index = index * mesh.size(m) + mesh.get_local_rank(m)
            count *= mesh.size(m)
    n = x.shape[dim] // count
    return index * n, n


def check_fake(kernel: str, *xs: Tensor) -> None:
    """The shape-only implementations serve fake tensors
    (``FakeTensorMode``); a real ``meta`` tensor is no device a kernel
    runs on, and raises as the wrappers do for any device but the CPU
    and CUDA."""
    from torch._subclasses.fake_tensor import is_fake
    for x in xs:
        if x.device.type == "meta" and not is_fake(x):
            raise ValueError(f"the {kernel} kernel takes CUDA tensors "
                             f"(plain version: CPU tensors), got {x.device}")


def keep_shards(x, dims: Sequence[int], divisible: Callable[[int, int], bool]
                ) -> list:
    """One placement per mesh dimension of DTensor ``x``: its ``Shard(i)``
    where i is in ``dims`` and ``divisible(i, size)`` holds for the
    product ``size`` of the mesh dimensions sharding i so far, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out, used = [], {}
    for m, pl in enumerate(x.placements):
        size = x.device_mesh.size(m)
        if isinstance(pl, Shard) and pl.dim in dims \
                and divisible(pl.dim, used.get(pl.dim, 1) * size):
            used[pl.dim] = used.get(pl.dim, 1) * size
            out.append(Shard(pl.dim))
        else:
            out.append(Replicate())
    return out


def rows_over_mesh(x, n_rows: int) -> list:
    """Shard dim 0 of DTensor ``x`` over every mesh dimension, in mesh
    order, while the rows divide evenly; ``Replicate()`` past that."""
    from torch.distributed.tensor import Replicate, Shard
    out, used = [], 1
    for m in range(x.device_mesh.ndim):
        size = x.device_mesh.size(m)
        if n_rows % (used * size) == 0:
            used *= size
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return out


def call_local(fn: Callable, args: tuple, in_placements: tuple,
               out_placements, mesh, grad_placements: tuple = None
               ) -> Tensor:
    """``fn(*args)`` on the local shards of ``args`` (DTensors
    redistributed to ``in_placements``, None for a non-tensor argument),
    returned as a DTensor with ``out_placements`` (a list; a tuple of
    them where ``fn`` returns a tuple).  ``grad_placements``: the
    placements of each argument's gradient where they are not its own
    (a weight read whole by ranks that each hold other rows gets a
    partial sum)."""
    from torch.distributed.tensor.experimental import local_map
    accepted = inspect.signature(local_map).parameters
    kwargs = {k: v for k, v in (("out_placements", out_placements),
                                ("in_placements", in_placements),
                                ("in_grad_placements", grad_placements),
                                ("device_mesh", mesh),
                                ("redistribute_inputs", True))
              if k in accepted and v is not None}
    return local_map(fn, **kwargs)(*args)
