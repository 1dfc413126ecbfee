"""Assigned input shapes, abstract inputs and the optimizer factory of
the launchers (counterpart of ``repro/launch/shapes.py``).

``SHAPES``, ``LONG_OK`` and ``applicable`` are the reference's.
``build_spec`` lays out one (architecture x shape) dry run on a mesh:
the model is built on the ``meta`` device (nothing allocated), then each
parameter, optimizer-state leaf, batch tensor and cache leaf becomes a
DTensor by the reference's sharding rules (``sharding.py``) whose local
shard is an empty tensor of the mesh's device type.  Under
``FakeTensorMode`` (the dry run) those shards are fake: no memory is
held.  The reference also takes ``scan_unroll``, the unroll of its
layer scan; the port runs every layer in a Python loop and has no scan,
so it is dropped.  A decode batch's ``cache_index`` is the host int
S - 1 (the port's decode step reads the slot on the host; the
reference compiles for any index).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from .. import optim
from ..configs import get_config
from ..models import (FeelIntegration, init_model, make_cache,
                      make_decode_step, make_prefill_step, make_train_step)
from ..models.config import ArchConfig
from ..models.model import stacked_groups
from . import mesh as mesh_mod
from . import sharding as sh

SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# long_500k needs sub-quadratic context handling:
LONG_OK = {"falcon-mamba-7b", "recurrentgemma-9b", "gemma3-12b"}


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_OK
    return True


def make_optimizer(cfg: ArchConfig) -> optim.GradientTransformation:
    """``cfg.optimizer`` at ``cfg.learning_rate``; adamw with weight decay
    0.01, as the reference builds it.  Adafactor steps each of the
    reference's stacked body leaves as one (``stacked_groups``), as the
    reference's adafactor sees them; the other optimizers are
    elementwise and step leaf by leaf."""
    if cfg.optimizer == "adafactor":
        return optim.adafactor(cfg.learning_rate,
                               groups=stacked_groups(cfg))
    builder = {"adamw": functools.partial(optim.adamw, weight_decay=0.01),
               "adam": optim.adam, "sgd": optim.sgd,
               "momentum": optim.momentum}[cfg.optimizer]
    return builder(cfg.learning_rate)


def _abstract_batch(cfg: ArchConfig, kind: str, B: int, S: int,
                    n_clients: int, feel: bool, device="meta"
                    ) -> Dict[str, Any]:
    """The reference's abstract batch as empty tensors on ``device``
    (``meta``, or fake ones under ``FakeTensorMode``): token ids int32,
    vlm embeddings in the activation dtype."""
    i32 = torch.int32

    def empty(shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device=device)

    if kind in ("train", "prefill"):
        if cfg.modality == "text":
            b = {"tokens": empty((B, S))}
        elif cfg.modality == "vlm":
            b = {"embeds": empty((B, S, cfg.d_model), cfg.act_dtype),
                 "positions": empty((B, 3, S))}
        else:
            b = {"tokens": empty((B, cfg.n_codebooks, S))}
        if kind == "train":
            lab_shape = ((B, cfg.n_codebooks, S)
                         if cfg.modality == "audio" else (B, S))
            b["labels"] = empty(lab_shape)
            if feel:
                b["alpha"] = empty((n_clients,), torch.float32)
        return b
    # decode: one token
    if cfg.modality == "text":
        b = {"tokens": empty((B, 1))}
    elif cfg.modality == "vlm":
        b = {"embeds": empty((B, 1, cfg.d_model), cfg.act_dtype),
             "positions": empty((B, 3, 1))}
    else:
        b = {"tokens": empty((B, cfg.n_codebooks, 1))}
    b["cache_index"] = S - 1
    return b


@dataclasses.dataclass
class DryRunSpec:
    """Everything needed to run one (arch x shape) on a mesh:
    ``step_fn(*args)``."""
    arch: str
    shape: str
    kind: str
    step_fn: Any
    args: Tuple[Any, ...]  # DTensors laid out by the sharding rules
    cfg: ArchConfig
    n_devices: int
    argument_bytes: int    # local shard bytes of every tensor in args


def _sharded_empty(t: torch.Tensor, sharding: sh.NamedSharding,
                   device_type: str, requires_grad: bool = False):
    """A DTensor of ``t``'s shape and dtype laid out by ``sharding``,
    its local shard an empty tensor on ``device_type``."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(sharding.shard_shape(t.shape), dtype=t.dtype,
                        device=device_type)
    stride, n = [], 1
    for size in reversed(t.shape):
        stride.insert(0, n)
        n *= size
    out = DTensor.from_local(local, sharding.mesh, sharding.placements,
                             run_check=False, shape=t.shape,
                             stride=tuple(stride))
    return out.requires_grad_(requires_grad)


def _local_bytes(x) -> int:
    if isinstance(x, dict):
        return sum(_local_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_local_bytes(v) for v in x)
    if isinstance(x, torch.nn.Module):
        return sum(_local_bytes(p) for p in x.parameters())
    if isinstance(x, torch.Tensor):
        t = x.to_local() if hasattr(x, "to_local") else x
        return t.numel() * t.element_size()
    return 0


def build_spec(arch: str, shape: str, mesh, *, feel: bool = True,
               mla_absorbed: bool = False,
               cfg_overrides: Optional[dict] = None,
               strategy: str = "tp") -> DryRunSpec:
    """The step and its sharded inputs for ``arch`` x ``shape`` on
    ``mesh`` (a ``DeviceMesh``; its device type holds the shards), the
    config ``arch``'s full one with ``cfg_overrides``."""
    cfg = dataclasses.replace(get_config(arch), **(cfg_overrides or {}))
    info = SHAPES[shape]
    kind, S, B = info["kind"], info["seq"], info["batch"]
    n_clients = mesh_mod.data_size(mesh)
    dev = mesh.device_type
    train = kind == "train"

    def empty(t, sharding):
        return _sharded_empty(t, sharding, dev)

    model = init_model(cfg, None, "meta")
    p_shard = sh.param_shardings(mesh, model, cfg)
    params_meta = dict(model.named_parameters())
    sh.map_params(model, lambda name, p: torch.nn.Parameter(
        _sharded_empty(p, p_shard[name], dev), requires_grad=train))

    batch_abs = _abstract_batch(cfg, kind, B, S, n_clients, feel)
    b_shard = sh.batch_shardings(mesh, batch_abs, strategy=strategy)
    batch_in = sh.map_sharded(batch_abs, b_shard, empty)

    if train:
        opt = make_optimizer(cfg)
        feel_cfg = (FeelIntegration(n_clients=n_clients) if feel else None)
        step = make_train_step(cfg, opt, feel=feel_cfg)
        opt_abs = opt.init(params_meta)
        o_shard = sh.opt_state_shardings(mesh, opt_abs, cfg)
        opt_in = sh.map_sharded(opt_abs, o_shard, empty)
        args = (model, opt_in, batch_in)
    elif kind == "prefill":
        prefill = make_prefill_step(cfg)
        c_shard = sh.cache_shardings(
            mesh, make_cache(cfg, B, S, dtype=cfg.act_dtype, device="meta"),
            B)

        def step(model, batch):
            # the cache prefill returns, made by the step as the
            # reference's is, laid out by the cache rules
            cache = sh.map_sharded(make_cache(cfg, B, S, dtype=cfg.act_dtype,
                                              device="meta"), c_shard, empty)
            return prefill(model, batch, cache)
        args = (model, batch_in)
    else:
        step = make_decode_step(cfg, mla_absorbed=mla_absorbed)
        cache_abs = make_cache(cfg, B, S, dtype=cfg.act_dtype, device="meta")
        c_shard = sh.cache_shardings(mesh, cache_abs, B)
        cache_in = sh.map_sharded(cache_abs, c_shard, empty)
        args = (model, cache_in, batch_in)

    return DryRunSpec(arch=arch, shape=shape, kind=kind, step_fn=step,
                      args=args, cfg=cfg, n_devices=mesh.size(),
                      argument_bytes=_local_bytes(args))
