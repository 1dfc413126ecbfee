"""Multi-pod dry run: every (arch x shape) on the production meshes, run
once on fake tensors over a fake process group, with per-device FLOPs,
bytes, collectives and memory, one JSON record per combination appended
to experiments/dryrun.jsonl.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each step with XLA on 256 or 512 host devices and reads XLA's cost,
memory and HLO analyses.  Here:

* a ``"fake"`` process group of 256 (512) ranks holds the production
  ``DeviceMesh``, the counterpart of the reference's host device count;
* the model, optimizer state, batch and cache are DTensors laid out by
  the reference's sharding rules (``shapes.build_spec``), their local
  shards fake tensors (``FakeTensorMode``): nothing is allocated;
* the step (train: forward, backward and the optimizer; prefill;
  decode) runs once, every layer of it, under the activation
  constrainer (``sharding.sharded_step``), eager, op by op, as the card
  runs it.  Every op runs partitioned: one that DTensor cannot shard
  fails the record (``ok: false``, the op named in ``error``) instead
  of running on gathered operands;
* a dispatch mode below DTensor (``LocalCost``) sees each rank's local
  ops: FLOPs by ``torch.utils.flop_counter``'s formulas (the kernels'
  own: the custom ops of ``kernels/``), bytes as each non-view op's
  inputs and outputs (eager ops are unfused), and the output bytes of
  each ``c10d_functional`` collective by kind (the reference's rule;
  the all-gather and chunk that stand in for an all-to-all on a CPU
  group count as that all-to-all);
* memory: ``argument_bytes`` is the local shard bytes of params,
  optimizer state, batch and cache.  ``peak_bytes`` is the rank's
  highest total of live bytes over the step: the arguments plus every
  storage the step allocates while it is alive (activations, gradients,
  the optimizer's temporaries, collective outputs), each storage once,
  so ``peak_bytes >= argument_bytes``.  The reference's ``peak_bytes`` is XLA's ``peak_memory_in_bytes`` of the compiled
  program, which also holds its arguments; XLA's buffers are reused
  and its ops fused, so the port's eager peak is the larger where
  temporaries pile up;
* the three time terms use H100 SXM datasheet constants (below): they
  are estimates, not measurements.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all                # single pod
    python -m repro_torch.launch.dryrun --all --multi-pod    # 512 ranks

``--arch`` takes the names of ``configs.ARCHS`` and their aliases
(``llama3.2-3b`` for ``llama3_2-3b``).  ``--fit`` runs the layer pattern
once and twice and extrapolates, as the reference does with its scan
(``full_depth: false``, ``peak_is_estimate: true``).

The fields only XLA gives (``hlo_lines``, ``raw_scan_flops``,
``t_lower_s``, ``t_compile_s``) are not in the record.  Two are the
port's own and kept so that old records read alike: ``gathered_ops``,
the ops that ran on gathered operands (empty: the dry run fails an op
DTensor cannot shard), and ``comparable``, true where there is none.
Where this torch release plans a redistribution by a graph search, the
count takes DTensor's greedy plan instead (``_outside_the_count``), so
the collectives are that plan's.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import ALIASES, ARCHS
from ..models.transformer import _layer_plan
from . import mesh as mesh_mod
from . import sharding as sh
from .shapes import SHAPES, applicable, build_spec

# NVIDIA H100 SXM datasheet constants (per GPU)
PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12         # bytes/s
NET_BW = 50e9            # bytes/s of network a GPU (one 400 Gb/s port)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
#: ``_c10d_functional`` op -> the reference's collective kind
_KIND = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(x)
               if isinstance(t, torch.Tensor))


def collective_bytes(records) -> Dict[str, int]:
    """Sum the bytes of each collective, by kind, from ``(c10d_functional
    op name, output bytes)`` records (a kind the reference has no name
    for under the op's own); ``count`` is the number of collectives."""
    out = {c: 0 for c in _COLLECTIVES}
    out["count"] = 0
    for name, n_bytes in records:
        kind = _KIND.get(name, name)
        out[kind] = out.get(kind, 0) + n_bytes
        out["count"] += 1
    return out


#: set while DTensor runs an all-to-all as an all-gather and a chunk (its
#: fallback on a CPU process group); ``LocalCost`` counts it as the
#: all-to-all it stands for
_ALL_TO_ALL = [0]


class LocalCost(TorchDispatchMode):
    """Counts each rank's local ops.  An op on DTensors is left to DTensor
    (``NotImplemented``), which runs it as local ops that this mode then
    sees: FLOPs by the registered formulas, bytes as the inputs and
    outputs of every op that is not a view, and each
    ``c10d_functional`` collective's output bytes by kind (waits
    excluded; the all-gather that stands in for an all-to-all on a CPU
    group counted as that all-to-all, with its input's bytes, and the
    chunk after it not counted).  It keeps each collective's kind and
    byte count, never its output.

    Memory: ``live`` is the bytes of every storage alive on the rank,
    from the tensors given to ``track`` (the step's arguments) and every
    op's outputs, each storage counted once and taken off when it is
    freed; ``peak`` is its highest value."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self._storages: dict = {}  # key -> (weakref, bytes)

    def track(self, tensors) -> None:
        for t in tensors:
            self._add(t)

    def _add(self, t: torch.Tensor, n: Optional[int] = None) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes() if n is None else n
        self._storages[key] = (weakref.ref(st, lambda _, k=key, n=n:
                                           self._free(k, n)), n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pkt = func._overloadpacket
        if func.namespace == "_c10d_functional":
            name = pkt.__name__
            if name == "wait_tensor":
                return args[0]
            if _ALL_TO_ALL[0]:
                # the all-to-all's output is as large as its input
                self.collectives.append(("all_to_all_single",
                                         _nbytes(args[0])))
                self._add(out, _nbytes(args[0]))
                return out
            self.collectives.append((name, _nbytes(out)))
        elif not _ALL_TO_ALL[0]:
            if pkt in flop_registry:
                self.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
            if not func.is_view:
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


def _modes_off(fn):
    """``fn`` run with every dispatch mode off."""
    from torch.utils._python_dispatch import _disable_current_modes

    def wrapped(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return wrapped


def _greedy(self, src_spec, dst_spec, *args, **kwargs):
    return self.generate_greedy_transform_infos(src_spec, dst_spec)


def _counted_as_all_to_all(fn):
    """DTensor's all-to-all, which on a CPU group runs as an all-gather
    and a chunk, marked for ``LocalCost`` as the all-to-all it is."""
    def wrapped(*args, **kwargs):
        _ALL_TO_ALL[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _ALL_TO_ALL[0] -= 1
    return wrapped


@contextlib.contextmanager
def _outside_the_count():
    """Adjust three of DTensor's own computations for fake tensors:

    * each op's global output shape, which DTensor gets by running the
      op on fake tensors of the global shape, runs with every mode off:
      neither the counting nor the memory tracker is to see those
      global-shape ops (DTensor then makes its own fake mode for them);
    * so does a strided shard's local size and offsets, which DTensor
      computes with index tensors and reads back to the host: under
      ``FakeTensorMode`` that read has no value;
    * where this release plans a redistribution by a graph search (any
      strided shard), it takes the greedy plan, as it does where the
      search cannot decode a shard: the search prices every candidate
      layout of every op and takes minutes a step on a 3-D mesh;
    * an all-to-all (``shard_dim_alltoall``, which a CPU group runs as an
      all-gather and a chunk) is marked, so that ``LocalCost`` counts the
      all-to-all and not its stand-in.
    """
    from torch.distributed.tensor import (_collective_utils, _redistribute,
                                          placement_types)
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    meta = ("_propagate_tensor_meta_non_cached"
            if hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
            else "_propagate_tensor_meta")
    patched = [(ShardingPropagator, meta, None)]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in vars(strided):
        patched.append((strided, "local_shard_size_and_offset", None))
    planner = getattr(_redistribute, "DTensorRedistributePlanner", None)
    if planner is not None and hasattr(planner,
                                       "generate_greedy_transform_infos") \
            and "generate_graph_based_transform_infos" in vars(planner):
        patched.append((planner, "generate_graph_based_transform_infos",
                        _greedy))
    a2a = _collective_utils.shard_dim_alltoall
    for mod in (_collective_utils, _redistribute, placement_types):
        if getattr(mod, "shard_dim_alltoall", None) is a2a:
            patched.append((mod, "shard_dim_alltoall",
                            _counted_as_all_to_all(a2a)))
    saved = [(cls, name, vars(cls)[name], by) for cls, name, by in patched]
    for cls, name, fn, by in saved:
        if by is not None:
            setattr(cls, name, by)
        elif isinstance(fn, staticmethod):
            setattr(cls, name, staticmethod(_modes_off(fn.__func__)))
        else:
            setattr(cls, name, _modes_off(fn))
    try:
        yield
    finally:
        for cls, name, fn, _ in saved:
            setattr(cls, name, fn)


def start_fake_world(n: int) -> None:
    """A ``"fake"`` process group of ``n`` ranks (this process is rank
    0); an existing default group of another size is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _params_counts(cfg, model) -> tuple:
    """(params_total, params_active) by the reference's arithmetic on its
    stacked leaves: an expert leaf counts topk / n_experts of itself."""
    groups: Dict[str, list] = collections.defaultdict(list)
    P = len(_layer_plan(cfg)[2])
    for name, p in model.named_parameters():
        parts = name.split(".", 3)
        key = (f"decoder.body.pos{int(parts[2]) % P}.{parts[3]}"
               if parts[:2] == ["decoder", "body"] else name)
        groups[key].append(p)
    total = active = 0
    for key, ps in groups.items():
        n = sum(p.numel() for p in ps)
        shape = ((len(ps),) + tuple(ps[0].shape) if "body" in key
                 else tuple(ps[0].shape))
        total += n
        expert = sh._expert(cfg, key.rsplit(".", 1)[-1], key, shape)
        active += int(n * cfg.topk / cfg.n_experts) if expert else n
    return total, active


def _local_tensors(x) -> list:
    """The local shards of every tensor in ``x`` (nested containers;
    a module stands for its parameters)."""
    from torch.distributed.tensor import DTensor
    leaves = pytree.tree_leaves(x, is_leaf=lambda v: isinstance(
        v, torch.nn.Module))
    tensors = [t for v in leaves for t in (
        v.parameters() if isinstance(v, torch.nn.Module) else [v])
        if isinstance(t, torch.Tensor)]
    return [t.to_local() if isinstance(t, DTensor) else t for t in tensors]


def _run_step(spec, strategy: str) -> dict:
    """One step of ``spec`` under the constrainer, counted; an op that
    DTensor cannot shard raises (``gather_unsharded_ops(strict=True)``)."""
    mesh = spec.args[0].decoder.final_norm.device_mesh
    cost = LocalCost()
    cost.track(_local_tensors(spec.args))
    with cost, sh.sharded_step(mesh, strategy, strict=True) as gathered:
        spec.step_fn(*spec.args)
    return {"flops": float(cost.flops), "bytes": float(cost.bytes),
            "coll": collective_bytes(cost.collectives),
            "gathered": dict(gathered.ops), "peak": float(cost.peak)}


def _layers(cfg, repeats: int) -> int:
    """``cfg.n_layers`` with the layer pattern repeated ``repeats`` times
    (the head and tail layers kept)."""
    head, _, pattern, tail = _layer_plan(cfg)
    return len(head) + repeats * len(pattern) + len(tail)


def run_one(arch: str, shape: str, multi_pod: bool, feel: bool = True,
            mla_absorbed: bool = False, variant: str = "baseline",
            out_path: Optional[str] = "experiments/dryrun.jsonl",
            cfg_overrides: Optional[dict] = None,
            strategy: str = "tp", full_depth: bool = True,
            mesh_shape: Optional[mesh_mod.MeshShape] = None) -> dict:
    """Run (arch x shape) on the production mesh; append its record to
    ``out_path`` (unless None) and return it.

    The step runs every layer, as the reference's scanned program does,
    and every count is that run's.  With ``full_depth=False`` it runs
    the layer pattern repeated once and twice instead, and extrapolates
    each count to the config's ``n_body`` repeats by the reference's law
    F(u) = outside + u * body (flops, bytes, each collective kind, peak
    memory); such a record says ``full_depth: false`` and
    ``peak_is_estimate: true``, since the law does not bound a peak.
    ``argument_bytes`` and the parameter counts are the full config's.
    ``mesh_shape`` replaces the production mesh (a smaller fake mesh).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    mshape = mesh_shape or mesh_mod.production_shape(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(str(s) for s in mshape.sizes),
           "multi_pod": multi_pod, "variant": variant, "feel": feel,
           "mla_absorbed": mla_absorbed, "strategy": strategy, "ok": False}
    t0 = time.time()
    try:
        start_fake_world(mshape.size)
        mesh = mesh_mod.make_mesh(mshape, device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), \
                _outside_the_count():
            def spec_of(overrides):
                return build_spec(arch, shape, mesh, feel=feel,
                                  mla_absorbed=mla_absorbed,
                                  cfg_overrides=overrides,
                                  strategy=strategy)
            spec = spec_of(cfg_overrides)
            cfg = spec.cfg
            n_body = _layer_plan(cfg)[1]
            full = full_depth or n_body < 2
            if full:
                m = _run_step(spec, strategy)
            else:
                m1, m2 = (_run_step(spec_of({**(cfg_overrides or {}),
                                             "n_layers": _layers(cfg, u)}),
                                    strategy) for u in (1, 2))
                m = _extrapolate(m1, m2, n_body)
        coll = m["coll"]
        coll_total = sum(v for k, v in coll.items() if k != "count")
        rec.update(
            ok=True, n_body=n_body, full_depth=full,
            peak_is_estimate=not full,
            flops_per_device=m["flops"], bytes_per_device=m["bytes"],
            collective_bytes_per_device=coll_total, collectives=coll,
            memory={"argument_bytes": spec.argument_bytes,
                    "peak_bytes": m["peak"]},
            gathered_ops=m["gathered"],
            comparable=not any(m["gathered"].values()),
            compute_term_s=m["flops"] / PEAK_FLOPS,
            memory_term_s=m["bytes"] / HBM_BW,
            collective_term_s=coll_total / NET_BW)
        terms = {"compute": rec["compute_term_s"],
                 "memory": rec["memory_term_s"],
                 "collective": rec["collective_term_s"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        # MODEL_FLOPS = 6 N D (train) / 2 N D (inference), N = active
        total, active = _params_counts(cfg, spec.args[0])
        info = SHAPES[shape]
        D = info["batch"] * (info["seq"] if spec.kind != "decode" else 1)
        mult = 6 if spec.kind == "train" else 2
        model_flops = mult * active * D / spec.n_devices
        flops = m["flops"]
        rec.update(params_total=int(total), params_active=int(active),
                   model_flops_per_device=model_flops,
                   useful_ratio=(model_flops / flops) if flops else None)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["t_total_s"] = round(time.time() - t0, 2)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "a") as f:
            json.dump(rec, f)
            f.write("\n")
    return rec


def _extrapolate(m1: dict, m2: dict, n_body: int) -> dict:
    """The counts at ``n_body`` repeats from those at 1 and 2, by the
    reference's law F(u) = outside + u * body (body clamped at 0); the
    collective count is the 1-repeat run's, as the reference keeps it."""
    def law(v1, v2):
        body = max(v2 - v1, 0.0)
        return max(v1 - body, 0.0) + n_body * body

    coll = {c: int(law(m1["coll"].get(c, 0), m2["coll"].get(c, 0)))
            for c in set(m1["coll"]) | set(m2["coll"]) if c != "count"}
    coll["count"] = m1["coll"]["count"]
    gathered = {k: int(law(m1["gathered"].get(k, 0), m2["gathered"].get(k, 0)))
                for k in set(m1["gathered"]) | set(m2["gathered"])}
    return {"flops": law(m1["flops"], m2["flops"]),
            "bytes": law(m1["bytes"], m2["bytes"]), "coll": coll,
            "gathered": gathered, "peak": law(m1["peak"], m2["peak"])}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCHS + list(ALIASES) + ["all"],
                    default=None)
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-feel", action="store_true")
    ap.add_argument("--mla-absorbed", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--strategy", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--out", default="experiments/dryrun.jsonl")
    ap.add_argument("--fit", action="store_true",
                    help="run the layer pattern repeated once and twice and "
                         "extrapolate (default: every layer); the peak is "
                         "then an estimate")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch in (None, "all")) \
        else [ALIASES.get(args.arch, args.arch)]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]

    records = []
    for arch in archs:
        for shape in shapes:
            if not applicable(arch, shape):
                print(f"SKIP  {arch} x {shape} (sub-quadratic gate)")
                continue
            rec = run_one(arch, shape, args.multi_pod,
                          feel=not args.no_feel,
                          mla_absorbed=args.mla_absorbed,
                          variant=args.variant, out_path=args.out,
                          strategy=args.strategy,
                          full_depth=not args.fit)
            records.append(rec)
            status = "OK  " if rec["ok"] else "FAIL"
            extra = (f"flops/dev={rec['flops_per_device']:.3g} "
                     f"peak/dev={rec['memory']['peak_bytes']:.3g} "
                     f"bottleneck={rec['bottleneck']}"
                     if rec["ok"] else rec.get("error", ""))
            print(f"{status} {arch:>20s} x {shape:<12s} mesh={rec['mesh']} "
                  f"t={rec['t_total_s']}s {extra}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return records


if __name__ == "__main__":
    main()
