"""Sharding rules: parameters, optimizer state, caches, batches, and the
activation constrainer installed around a step.

Counterpart of ``repro/launch/sharding.py``, with its rules and
constants.  For every array leaf:
  * the largest dim divisible by the mesh "model" size shards over
    "model" (ties -> the later dim, i.e. the output features);
  * the largest *remaining* dim divisible by the total data size
    shards over the data axes (ZeRO/FSDP-style weight sharding);
  * leading scan-stack dims (decoder "body") and dims < 128 never
    shard.
MoE expert tensors (E, d, f) are special-cased to expert parallelism:
E over (data x model) jointly when divisible, else E -> "model" with the
per-expert features ZeRO'd over data.

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: None, an axis name, or a tuple of axis names.  A
``NamedSharding`` pairs it with a mesh (a ``DeviceMesh``, or a
``mesh.MeshShape`` where only the rules and the shard shapes are
needed); ``to_placements`` turns it into DTensor placements.

The reference shards each body leaf in its stacked (n_body, ...) shape;
the port keeps one parameter per layer (``decoder.body.{r * P + p}.*``).
So a body member's spec is computed on its stacked shape (the group of
``models.model.stacked_groups``) and its leading entry dropped; a leaf
already stacked (adafactor's state of a group, ``decoder.body.pos{p}.*``)
and the caches' stacked body keep theirs.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.local import is_dtensor
from ..models.config import ArchConfig
from ..models.shard_ctx import use_constrainer, use_relayout
from ..models.transformer import _layer_plan
from . import mesh as mesh_mod

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

_MIN_SHARD_DIM = 128

# joint (data x model) expert sharding, the reference's default.
EXPERT_JOINT = True

# megatron pairing: these weights contract over their model-sharded dim
# (row-parallel -> one all-reduce of the block output over "model");
# everything else shards its OUT-features (column-parallel).
_ROW_PARALLEL = {"wo", "w_down", "out_proj", "w_out", "w_o"}

_BODY_MEMBER = re.compile(r"^decoder\.body\.(\d+)\.")


def _param_spec(name: str, shape, *, model: int, data: int, data_ax,
                skip_leading: bool, is_expert: bool) -> Spec:
    nd = len(shape)
    spec: list = [None] * nd
    start = 1 if (skip_leading and nd >= 3) else 0
    if nd - start < 2:
        return tuple(spec)  # norms/biases: replicate

    if is_expert:
        # expert parallelism: E over data+model jointly when divisible
        # (1 expert a rank for E = 256), which keeps every per-expert
        # matmul contraction unsharded
        e_dim = start
        joint = data * model
        if EXPERT_JOINT and shape[e_dim] % joint == 0:
            spec[e_dim] = tuple(data_ax) + ("model",)
            return tuple(spec)
        # fallback (E = 160): E over model, ZeRO f over data
        if shape[e_dim] % model == 0:
            spec[e_dim] = "model"
        last = nd - 1
        if shape[last] % data == 0 and shape[last] >= _MIN_SHARD_DIM:
            spec[last] = data_ax
        return tuple(spec)

    if name == "embed":
        # vocab-parallel table: the lookup is a gather
        v_dim = nd - 2  # (V, d) or (C, V, d)
        if shape[v_dim] % model == 0 and shape[v_dim] >= model:
            spec[v_dim] = "model"
        if shape[nd - 1] % data == 0 and shape[nd - 1] >= _MIN_SHARD_DIM:
            spec[nd - 1] = data_ax
        return tuple(spec)

    m_dim = start if name in _ROW_PARALLEL else nd - 1
    if shape[m_dim] % model == 0 and shape[m_dim] >= model:
        spec[m_dim] = "model"
    # ZeRO data-sharding only on non-contraction dims: row-parallel
    # weights contract over m_dim, so their output dim can carry the
    # data axes
    if name in _ROW_PARALLEL:
        out_dim = nd - 1
        if spec[out_dim] is None and shape[out_dim] % data == 0 \
                and shape[out_dim] >= _MIN_SHARD_DIM:
            spec[out_dim] = data_ax
    return tuple(spec)


# ------------------------------------------------------------ shardings

def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def normalize(spec: Spec) -> Tuple[Tuple[str, ...], ...]:
    """Each entry as a tuple of axis names (() for None), so ``"data"``
    and ``("data",)`` compare equal."""
    return tuple(_axes(e) for e in spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``DeviceMesh`` or ``MeshShape``); on a
    ``DeviceMesh`` it names its layout as a DTensor does
    (``device_mesh``, ``placements``)."""
    mesh: Any
    spec: Spec

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The local shape of a ``shape`` tensor on one rank (every rule
        shards only dims that divide evenly)."""
        sizes = mesh_mod.axis_sizes(self.mesh)
        return tuple(n // math.prod(sizes[a] for a in _axes(e))
                     for n, e in zip(shape, self.spec))

    @property
    def device_mesh(self):
        return self.mesh

    @property
    def placements(self) -> tuple:
        return to_placements(self.mesh, self.spec)


def to_placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(i)`` on
    every mesh dim of more than one rank that an entry i names, else
    ``Replicate()`` (a shard over one rank is the whole tensor).  DTensor
    splits one tensor dim over several mesh dims in mesh order, and so
    does the reference, whose joint entries list their axes in mesh
    order; an entry out of that order raises."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_mod.axis_sizes(mesh)
    names = tuple(sizes)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists its axes out of the "
                             f"mesh's order {names}")
        for m in idx:
            if sizes[names[m]] > 1:
                out[m] = Shard(i)
    return tuple(out)


def _shape(x) -> Tuple[int, ...]:
    """A tensor's shape, a shape as it is, () for a host number."""
    if hasattr(x, "shape"):
        return tuple(x.shape)
    return () if isinstance(x, (int, float)) else tuple(x)


def _expert(cfg: Optional[ArchConfig], name: str, path: str,
            shape: Tuple[int, ...]) -> bool:
    n_exp = cfg.n_experts if cfg is not None else 0
    return (n_exp > 0 and len(shape) >= 3 and "shared" not in path
            and n_exp in shape and name in ("w_gate", "w_up", "w_down"))


def leaf_spec(mesh, path: str, shape, cfg: Optional[ArchConfig] = None,
              n_body: Optional[int] = None) -> Spec:
    """The reference's spec for the port's leaf ``path`` (dotted) of
    ``shape``.  A body member ``decoder.body.{i}.*`` is specced on its
    stacked shape (``n_body``, from ``cfg``) and its leading entry
    dropped; any other path with ``body`` in it is taken as stacked."""
    model = mesh_mod.model_size(mesh)
    data = mesh_mod.data_size(mesh)
    data_ax = mesh_mod.data_axes(mesh)
    shape = _shape(shape)
    name = path.rsplit(".", 1)[-1]
    member = _BODY_MEMBER.match(path) is not None
    if member:
        if n_body is None:
            n_body = _layer_plan(cfg)[1]
        shape = (n_body,) + shape
    spec = _param_spec(name, shape, model=model, data=data, data_ax=data_ax,
                       skip_leading="body" in path,
                       is_expert=_expert(cfg, name, path, shape))
    return spec[1:] if member else spec


def param_shardings(mesh, params: Union[torch.nn.Module, Mapping[str, Any]],
                    cfg: Optional[ArchConfig] = None
                    ) -> Dict[str, NamedSharding]:
    """{name: NamedSharding} for a module's parameters or a dict of
    tensors or shapes by the port's names: the parameters, or one field
    of an optimizer state (adamw's moments by parameter name,
    adafactor's by parameter or stacked group name)."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    n_body = _layer_plan(cfg)[1] if cfg is not None else None
    return {name: NamedSharding(mesh, leaf_spec(mesh, name, x, cfg, n_body))
            for name, x in params.items()}


def opt_state_shardings(mesh, state, cfg: Optional[ArchConfig] = None):
    """The optimizer state's shardings in its own structure: every dict
    field keyed as the parameters (``param_shardings``), a scalar field
    (the step count) None."""
    def one(v):
        if isinstance(v, dict):
            return param_shardings(mesh, v, cfg)
        if isinstance(v, torch.Tensor) and v.dim():
            raise ValueError("an optimizer state's tensors sit in dicts "
                             "keyed by parameter name")
        return None
    if hasattr(state, "_fields"):
        return type(state)(*(one(v) for v in state))
    if isinstance(state, tuple):
        return tuple(opt_state_shardings(mesh, s, cfg) for s in state)
    return one(state)


def _walk(tree, fn, path=()):
    """Map ``fn(path, leaf)`` over nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_shardings(mesh, cache, batch: int):
    """KV/state caches: batch dim over data axes when divisible; else
    the sequence dim (long_500k); heads/latent dims over model when
    divisible.  ``cache``: the port's cache tree (tensors or shapes)."""
    model = mesh_mod.model_size(mesh)
    data = mesh_mod.data_size(mesh)
    data_ax = mesh_mod.data_axes(mesh)

    def one(path, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        skip = nd >= 3 and "body" in "/".join(path)
        start = 1 if skip else 0
        spec: list = [None] * nd
        b_dim = start  # batch is always the first real dim
        rest = list(range(start + 1, nd))
        if shape[b_dim] % data == 0 and shape[b_dim] >= data:
            spec[b_dim] = data_ax
        elif rest and shape[rest[0]] % data == 0 \
                and shape[rest[0]] >= _MIN_SHARD_DIM:
            spec[rest[0]] = data_ax  # sequence-sharded cache
            rest = rest[1:]
        cand = [d for d in rest if shape[d] % model == 0
                and shape[d] >= model]
        if cand:
            spec[max(cand, key=lambda d: (shape[d], d))] = "model"
        return NamedSharding(mesh, tuple(spec))

    return _walk(cache, one)


def batch_shardings(mesh, batch: Mapping[str, Any],
                    strategy: str = "tp") -> Dict[str, NamedSharding]:
    """strategy "tp": batch over the data axes (megatron hybrid).
    strategy "fsdp": batch over data+model jointly, every rank a data
    shard; weights stay model-sharded and are gathered per use."""
    data_ax = mesh_mod.data_axes(mesh)
    data = mesh_mod.data_size(mesh)
    model = mesh_mod.model_size(mesh)
    batch_ax = tuple(data_ax) + (("model",) if strategy == "fsdp" else ())
    batch_div = data * (model if strategy == "fsdp" else 1)

    def one(name, leaf):
        shape = _shape(leaf)
        if not shape or name in ("alpha", "cache_index"):
            return NamedSharding(mesh, (None,) * len(shape))
        spec: list = [None] * len(shape)
        if shape[0] % batch_div == 0 and shape[0] >= batch_div:
            spec[0] = batch_ax
        elif shape[0] % data == 0 and shape[0] >= data:
            spec[0] = data_ax
        if strategy == "tp" and name == "embeds" and shape[-1] % model == 0:
            spec[-1] = "model"
        return NamedSharding(mesh, tuple(spec))

    return {name: one(name, leaf) for name, leaf in batch.items()}


# ---------------------------------------------------------- distribution

def full(x):
    """A DTensor's whole value as a plain tensor; anything else as it
    is."""
    return x.full_tensor() if is_dtensor(x) else x


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` as a DTensor laid out by ``sharding`` (on a DeviceMesh)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def map_params(model: torch.nn.Module, fn) -> torch.nn.Module:
    """Replace every parameter of ``model`` in place by ``fn(name, p)``;
    returns the model."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = fn(name, p)
    return model


def distribute_model(model: torch.nn.Module, mesh,
                     cfg: Optional[ArchConfig] = None):
    """Replace every parameter of ``model`` in place by a DTensor laid
    out by ``param_shardings``; returns the model."""
    shardings = param_shardings(mesh, model, cfg)
    return map_params(model, lambda name, p: torch.nn.Parameter(
        distribute(p.detach(), shardings[name]),
        requires_grad=p.requires_grad))


def map_sharded(tree, shardings, fn):
    """``fn(tensor, its NamedSharding)`` for each tensor of nested dicts,
    lists and NamedTuples, ``shardings`` in the same structure (a None
    sharding leaves its leaf as it is)."""
    if isinstance(tree, dict):
        return {k: map_sharded(v, shardings[k], fn) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_sharded(v, s, fn)
                            for v, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_sharded(v, s, fn)
                          for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor) and shardings is not None:
        return fn(tree, shardings)
    return tree


def distribute_tree(tree, shardings):
    """Each tensor of ``tree`` as a DTensor by its ``NamedSharding``."""
    return map_sharded(tree, shardings, distribute)


# ---------------------------------------------------------- activations

def _activation_specs(mesh, strategy: str = "tp"):
    """``spec(name, shape)``: the reference's spec of an activation of
    logical name ``name`` and ``shape``."""
    data_ax = mesh_mod.data_axes(mesh)
    model = mesh_mod.model_size(mesh)
    data = mesh_mod.data_size(mesh)
    if strategy == "fsdp":
        data_ax = tuple(data_ax) + ("model",)
        data = data * model
        # activations carry no feature sharding under FSDP: make the
        # "divisible by model" checks always fail
        model = 1 << 62

    def build_spec(name, s):
        nd = len(s)
        spec: list = [None] * nd
        if name == "moe_ecd":
            # mirror the expert-weight sharding on the dispatch tensors
            if EXPERT_JOINT and s[0] % (data * model) == 0 \
                    and model > 1:
                spec[0] = tuple(data_ax) + ("model",)
            elif s[0] % model == 0:
                spec[0] = "model"
            return spec
        # batch-leading activations
        if s[0] % data == 0 and s[0] >= data:
            spec[0] = data_ax
        if name == "act_btd":
            return spec
        if name in ("act_btf", "logits_btv"):
            if s[-1] % model == 0 and s[-1] >= model:
                spec[-1] = "model"
            return spec
        if name == "act_bthd" and nd >= 3:
            if s[-2] % model == 0 and s[-2] >= model:
                spec[-2] = "model"
            return spec
        if name == "kv_cache" and nd >= 3:
            if spec[0] is None and s[1] % data == 0 \
                    and s[1] >= _MIN_SHARD_DIM:
                spec[1] = data_ax  # sequence-sharded cache (long_500k)
            if s[2] % model == 0 and s[2] >= model:
                spec[2] = "model"
            return spec
        return spec

    return build_spec


def activation_constrainer(mesh, strategy: str = "tp"):
    """Constrainer for ``repro_torch.models.shard_ctx`` logical names: a
    DTensor is redistributed to the name's placements (the counterpart
    of ``jax.lax.with_sharding_constraint``); a plain tensor passes."""
    build_spec = _activation_specs(mesh, strategy)

    def constrain(x, name):
        if x.ndim < 2 or not is_dtensor(x):
            return x
        placements = to_placements(mesh, tuple(build_spec(name, x.shape)))
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(x.device_mesh, placements)

    return constrain


def _leading_dims(old, new) -> Dict[int, int]:
    """{dim of ``new``: dim of ``old``} for each dim of ``new`` that leads
    a run of dims whose sizes multiply to the product of a run of
    ``old``'s (a view's split or merge): a split of that ``new`` dim over
    n ranks is a split of the ``old`` dim over n."""
    out: Dict[int, int] = {}
    i = j = 0
    while i < len(old) and j < len(new):
        out[j] = i
        po, pn = old[i], new[j]
        i, j = i + 1, j + 1
        while po != pn:
            if po < pn:
                po, i = po * old[i], i + 1
            else:
                pn, j = pn * new[j], j + 1
    return out


def _viewable(x, shape) -> tuple:
    """``x``'s placements with each split that its view as ``shape``
    cannot keep made ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    new_of = {i: j for j, i in _leading_dims(tuple(x.shape), shape).items()}
    out, used = [], {}
    for m, pl in enumerate(x.placements):
        j = new_of.get(pl.dim) if isinstance(pl, Shard) else None
        n = used.get(j, 1) * x.device_mesh.size(m)
        if j is not None and shape[j] % n == 0:
            used[j] = n
            out.append(pl)
        else:
            out.append(Replicate() if isinstance(pl, Shard) else pl)
    return tuple(out)


def activation_relayout(mesh, strategy: str = "tp"):
    """Relayout for ``repro_torch.models.shard_ctx.relayout``: the port's
    own layout steps, where the reference's partitioner lays out a view
    or a small vector by itself.  ``relayout(x, name, shape)`` gives a
    DTensor ``x`` redistributed:
      * to a rule's name: so that its view as ``shape`` is laid out as
        the constraint ``name`` lays out ``shape`` (each split dim takes
        the entry of the new dim that leads it), the view then running
        on each rank's shard;
      * ``"replicated"``: the whole tensor on every rank;
      * ``"rows"``: its splits of the leading dims kept, its last dim
        whole (partial sums reduced);
      * None: each split of ``x`` kept where the view keeps it (a split
        of a dim that leads its run, into a new dim it divides), the
        others gathered.
    A plain tensor passes.  ``relayout.placements(name, shape)``: the
    placements the constraint ``name`` gives a tensor of ``shape``."""
    from torch.distributed.tensor import Replicate, Shard
    build_spec = _activation_specs(mesh, strategy)

    def relayout(x, name, shape=None):
        if not is_dtensor(x):
            return x
        if name == "replicated":
            placements = (Replicate(),) * x.device_mesh.ndim
        elif name == "rows":
            placements = tuple(
                pl if isinstance(pl, Shard) and pl.dim < x.ndim - 1
                else Replicate() for pl in x.placements)
        elif name is None:
            placements = _viewable(x, tuple(shape))
        else:
            shape = tuple(x.shape) if shape is None else tuple(shape)
            spec = build_spec(name, shape)
            lead = _leading_dims(tuple(x.shape), shape)
            old: list = [None] * x.ndim
            for j, entry in enumerate(spec):
                if entry is not None and j in lead:
                    old[lead[j]] = entry
            placements = to_placements(mesh, tuple(old))
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(x.device_mesh, placements)

    relayout.placements = lambda name, shape: to_placements(
        mesh, tuple(build_spec(name, tuple(shape))))
    return relayout


@contextlib.contextmanager
def with_mesh_constraints(mesh, strategy: str = "tp"):
    """Context manager installing the activation constrainer and the
    port's relayout."""
    with use_constrainer(activation_constrainer(mesh, strategy)), \
            use_relayout(activation_relayout(mesh, strategy)):
        yield


# ------------------------------------------------ ops with no DTensor rule

def _key(func, args, kwargs) -> tuple:
    """(op, each argument's layout): DTensors by shape and placements,
    tensors by shape, the rest as they are where hashable."""
    from torch.distributed.tensor import DTensor
    parts = []
    for x in pytree.tree_leaves((args, kwargs)):
        if isinstance(x, DTensor):
            parts.append((tuple(x.shape), tuple(x.placements), x.dtype))
        elif isinstance(x, torch.Tensor):
            parts.append(("tensor", tuple(x.shape), x.dtype))
        else:
            try:
                hash(x)
                parts.append(x)
            except TypeError:
                parts.append(type(x).__name__)
    return (func, tuple(parts))


#: what DTensor raises for an op it has no rule for, or none for the
#: layout at hand (an assertion in some releases' dispatch)
_NO_RULE = (RuntimeError, AssertionError, ValueError)


def _gathered(func, args, kwargs):
    """``func`` on the full tensors of its DTensor arguments, its tensor
    outputs replicated DTensors on their mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(x.device_mesh for x in pytree.tree_leaves((args, kwargs))
                if isinstance(x, DTensor))
    args, kwargs = pytree.tree_map_only(
        DTensor, lambda x: x.full_tensor(), (args, kwargs))
    out = func(*args, **kwargs)
    rep = [Replicate()] * mesh.ndim
    return pytree.tree_map_only(
        torch.Tensor,
        lambda t: DTensor.from_local(t, mesh, rep, run_check=False), out)


def _malformed(out) -> bool:
    """Whether an op's output holds a DTensor whose placements do not
    number its mesh's dimensions: what a faulty rule gives in some
    releases (torch 2.11's ``constant_pad_nd`` on a 2-D mesh gives one
    placement), and what the next op then fails on."""
    from torch.distributed.tensor import DTensor
    if isinstance(out, DTensor):
        return len(out.placements) != out.device_mesh.ndim
    if isinstance(out, (tuple, list)):
        return any(_malformed(x) for x in out)
    return False


class gather_unsharded_ops(TorchDispatchMode):
    """Run an op that DTensor cannot shard on gathered inputs.

    DTensor has no sharding rule for some ops (top-k, sort, scatter and
    gather by index), raises on others for some layouts (a view that
    splits a dim sharded unevenly for the new shape, as the GQA heads
    of a (B, S, Hk Dh) projection sharded 16 ways), and in some releases
    gives a malformed output for others (``_malformed``).  XLA partitions
    such an op by gathering its operands first; so does this mode: it
    redistributes every DTensor argument to ``Replicate`` and runs the
    op on the full tensors, returning replicated DTensors.  The
    collectives are real and counted by any mode below.  Each op that
    took this path is counted in ``ops`` by name; an (op, layout) that
    failed once goes straight to it afterwards.  On a mesh of one rank
    nothing is gathered and the op reads and writes the tensors
    themselves, in place too.

    With ``strict`` it gathers nothing: such an op raises a
    ``RuntimeError`` that names it and its operands' layouts (the dry
    run, which counts a partitioned step).

    Any Python dispatch mode takes DTensor off its C++ fast path, so a
    step under this one runs slower even where no op falls back; the
    mode keeps its own work per op to a type test and a set lookup.
    """

    def __init__(self, strict: bool = False):
        super().__init__()
        self.strict = strict
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.ops: Dict[str, int] = collections.Counter()
        self._failed: set = set()        # (op, layout) keys
        self._failed_funcs: set = set()  # the ops among them

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, self._dtensor) for t in types):
            return func(*args, **kwargs)
        if func not in self._failed_funcs \
                or _key(func, args, kwargs) not in self._failed:
            try:
                out = func(*args, **kwargs)
            except _NO_RULE:
                pass
            else:
                if not _malformed(out):
                    return out
                if func._schema.is_mutable:
                    raise RuntimeError(f"DTensor gave {func}, which writes "
                                       "its inputs, a malformed output")
            self._failed.add(_key(func, args, kwargs))
            self._failed_funcs.add(func)
        if self.strict:
            raise RuntimeError(f"DTensor cannot shard {func} on "
                               f"{_key(func, args, kwargs)[1]}: it would run "
                               "on gathered operands")
        self.ops[str(func)] += 1
        return _gathered(func, args, kwargs)


@contextlib.contextmanager
def sharded_step(mesh, strategy: str = "tp", strict: bool = False):
    """The context a step runs in on a mesh: the activation constrainer
    and relayout, plain tensors (made inside the model) taken as
    replicated, and ``gather_unsharded_ops(strict)``, which it
    yields."""
    from torch.distributed.tensor.experimental import implicit_replication
    with contextlib.ExitStack() as stack:
        stack.enter_context(with_mesh_constraints(mesh, strategy))
        stack.enter_context(implicit_replication())
        yield stack.enter_context(gather_unsharded_ops(strict))
