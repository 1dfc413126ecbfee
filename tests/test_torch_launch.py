"""The port's launch layer: the kernels as custom ops, the dry run's
counting, a smoke-size dry run, and a train step on a host mesh.

* Each kernel's custom op passes ``torch.library.opcheck`` on the CPU
  (schema, fake implementation, autograd registration, tracing), and
  its FLOP formula is the kernel's work (flash: the causal half).
* The dry run's counting mode sees each rank's local ops: a matmul
  sharded rows over "data" and columns over "model" of a 16x16 mesh
  counts the global FLOPs / 256 exactly (``FlopCounterMode`` outside
  DTensor counts the global op), and each ``c10d_functional``
  collective's output bytes by kind (the cases of the reference's
  ``test_collective_parser``).
* Every arch's smoke config on every shape it takes, on 16x16 and on
  2x16x16, gives a complete full-depth record with no gathered op, a
  peak that holds its arguments, and ``params_total``,
  ``params_active`` and ``model_flops_per_device`` that are the
  reference's arithmetic (``repro/launch/dryrun.py``) on the
  reference's parameters.
* A llama smoke train step (FEEL on) and a serve on
  ``make_host_mesh(1, 1, device="cpu")`` equal the ones without a mesh,
  bit for bit: the counterpart of the reference's host-mesh lowering
  test.
"""
import dataclasses
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gradnorm as gn  # noqa: E402
from repro_torch.kernels import lru_scan as ls  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402

torch.set_num_threads(2)

#: llama3.2-3b x train_4k on 16x16, FLOPs a device (torch 2.13, CPU);
#: ``chip_smoke.py`` holds the card's host to the same count
LLAMA_TRAIN_4K_FLOPS = 119_360_364_486_656.0


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Destroy any process group a test starts, so that later files on
    the same worker start from none."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(dtype)


# ----------------------------------------------------------- custom ops

def _op_cases():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (_randn(gen, 2, 8, h, 16) for h in (4, 2, 2))
    bq, bk = q.bfloat16(), k.bfloat16()
    h, d = _randn(gen, 10, 7), _randn(gen, 10, 5)
    a = torch.rand(2, 9, 3, generator=gen).requires_grad_()
    b = _randn(gen, 2, 9, 3).requires_grad_()
    kl, vl = _randn(gen, 2, 11, 2, 16), _randn(gen, 2, 11, 2, 16)
    return {"flash-gqa-fp32": (fa.flash_attention_op, (q, k, v, True, None)),
            # softcapped, the 8 queries at positions 3.. of 11 keys
            "flash-softcap-offset-fp32": (fa.flash_attention_op,
                                          (q, kl, vl, True, None, 30.0, 3)),
            "flash-narrow-v-bf16": (fa.flash_attention_op,
                                    (bq, bk, bk[..., :8].clone(), False,
                                     0.3)),
            "rownorm2": (gn.rownorm2_op, (h,)),
            "gradnorm_sigma": (gn.gradnorm_sigma_op, (h, d)),
            "lru_scan": (ls.lru_scan_op, (a, b)),
            "lru_scan-bf16": (ls.lru_scan_op,
                              (a.detach().bfloat16().requires_grad_(),
                               b.detach().bfloat16().requires_grad_()))}


@pytest.mark.parametrize("case", list(_op_cases()))
def test_each_kernel_op_passes_opcheck(case):
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


def test_op_flop_formulas_count_the_kernels_work():
    from torch.utils.flop_counter import FlopCounterMode
    gen = torch.Generator().manual_seed(1)
    B, S, H, Hk, d, dv = 2, 8, 4, 2, 16, 8
    q, k = _randn(gen, B, S, H, d), _randn(gen, B, S, Hk, d)
    v = _randn(gen, B, S, Hk, dv)
    h, dl = _randn(gen, 12, 7), _randn(gen, 12, 5)
    a, b = torch.rand(2, 9, 3, generator=gen), _randn(gen, 2, 9, 3)
    for fn, want in (
            (lambda: ops.flash_attention_bhsd(q, k, v),
             2 * B * H * (d + dv) * S * (S + 1) // 2),
            (lambda: ops.flash_attention_bhsd(q, k, v, causal=False),
             2 * B * H * (d + dv) * S * S),
            # the last 3 queries against all 8 keys, softcapped: query i
            # sees 5 + i + 1 keys
            (lambda: ops.flash_attention_bhsd(q[:, 5:], k, v, softcap=30.0,
                                              q_offset=5),
             2 * B * H * (d + dv) * (6 + 7 + 8)),
            (lambda: ops.rownorm2(h), gn.cost(12, 7)[0]),
            (lambda: ops.gradnorm_sigma(h, dl), gn.cost(12, 7, 5)[0]),
            (lambda: ops.lru_scan(a, b), 2 * 2 * 9 * 3)):
        with FlopCounterMode(display=False) as counter:
            fn()
        assert counter.get_total_flops() == want


def test_the_scan_op_carries_its_gradient():
    gen = torch.Generator().manual_seed(2)
    a = torch.rand(2, 7, 3, generator=gen, dtype=torch.float64)
    b = torch.randn(2, 7, 3, generator=gen, dtype=torch.float64)
    a32, b32 = (x.float().requires_grad_() for x in (a, b))
    g = torch.randn(2, 7, 3, generator=gen)
    (ops.lru_scan(a32, b32) * g).sum().backward()
    a64, b64 = (x.clone().requires_grad_() for x in (a, b))
    (ls.lru_scan_plain(a64, b64).double() * g.double()).sum().backward()
    np.testing.assert_allclose(a32.grad.numpy(), a64.grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b32.grad.numpy(), b64.grad.numpy(),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- counting

def _fake_mesh(sizes, names):
    dryrun.start_fake_world(math.prod(sizes))
    return tmesh.make_mesh(tmesh.MeshShape(names, sizes), device_type="cpu")


def test_a_sharded_matmul_counts_a_devices_share():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    mesh = _fake_mesh((16, 16), ("data", "model"))
    with FakeTensorMode(), dryrun._outside_the_count():
        x = distribute_tensor(torch.empty(4096, 3072), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(3072, 8192), mesh,
                              [Replicate(), Shard(1)])
        with dryrun.LocalCost() as cost:
            y = x @ w
        with FlopCounterMode(display=False) as global_count:
            x @ w
    full = 2 * 4096 * 3072 * 8192
    assert global_count.get_total_flops() == full
    assert cost.flops == full // 256 == 805_306_368
    assert tuple(y.to_local().shape) == (256, 512)
    assert cost.collectives == []


def test_collective_bytes_by_kind():
    """One collective of each kind on the fake world's group of 256,
    each counted by its output's bytes (waits are not collectives); a
    kind the reference has no name for counts under its op's name."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    _fake_mesh((16, 16), ("data", "model"))
    group = dist.group.WORLD
    with FakeTensorMode():
        ar = torch.empty(128, 1024)
        ag = torch.empty(1, 512, dtype=torch.bfloat16)
        a2a = torch.empty(256, 10)
        rs = torch.empty(256 * 32, dtype=torch.bfloat16)
        bc = torch.empty(16, dtype=torch.int32)
        with dryrun.LocalCost() as cost:
            outs = [funcol.all_reduce(ar, "sum", group),
                    funcol.all_gather_single(ag, 0, group),
                    funcol.all_to_all_single(a2a, None, None, group),
                    funcol.reduce_scatter_single(rs, "sum", 0, group),
                    funcol.broadcast(bc, 0, group)]
            for o in outs:
                funcol.wait_tensor(o)
    got = dryrun.collective_bytes(cost.collectives)
    assert got["all-reduce"] == 128 * 1024 * 4
    assert got["all-gather"] == 256 * 512 * 2
    assert got["all-to-all"] == 256 * 10 * 4
    assert got["reduce-scatter"] == 32 * 2
    assert got["broadcast"] == 16 * 4 and got["collective-permute"] == 0
    assert got["count"] == 5


# ------------------------------------------------------------- dry run

def _smoke_overrides(arch, **changes):
    """``arch``'s smoke config as overrides of its full one."""
    cfg = smoke_config(arch)
    return {**{f.name: getattr(cfg, f.name)
               for f in dataclasses.fields(cfg)}, **changes}


def _reference_counts(arch, kind, dims, n_devices):
    """``repro/launch/dryrun.py``'s params_total, params_active and
    model_flops_per_device on the reference's parameters."""
    cfg = j_smoke_config(arch)
    params = jax.eval_shape(lambda k: j_init_model(k, cfg),
                            jax.random.PRNGKey(0))
    total = active = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        n = math.prod(leaf.shape)
        total += n
        is_expert = (cfg.n_experts > 0 and leaf.ndim >= 3
                     and cfg.n_experts in leaf.shape
                     and keys[-1] in ("w_gate", "w_up", "w_down")
                     and "shared" not in keys)
        active += int(n * cfg.topk / cfg.n_experts) if is_expert else n
    D = dims["batch"] * (dims["seq"] if kind != "decode" else 1)
    mult = 6 if kind == "train" else 2
    return total, active, mult * active * D / n_devices


def _smoke_cases():
    return [(arch, shape, multi_pod) for multi_pod in (False, True)
            for arch in ARCHS for shape in tshapes.SHAPES
            if tshapes.applicable(arch, shape)]


@pytest.mark.parametrize("arch,shape,multi_pod", _smoke_cases())
def test_smoke_dry_run_record_is_complete(arch, shape, multi_pod,
                                          monkeypatch):
    """Every arch's smoke config on every shape it takes, on 16x16 and on
    2x16x16: the record is complete, runs every layer, gathers no op,
    and its peak holds its arguments."""
    largest = [0]
    add = dryrun.LocalCost._add

    def add_and_size(self, t, n=None):
        largest[0] = max(largest[0],
                         t.untyped_storage().nbytes() if n is None else n)
        return add(self, t, n)

    monkeypatch.setattr(dryrun.LocalCost, "_add", add_and_size)
    rec = dryrun.run_one(arch, shape, multi_pod, out_path=None,
                         cfg_overrides=_smoke_overrides(arch))
    assert rec["ok"], rec.get("traceback")
    for key in ("arch", "shape", "mesh", "multi_pod", "variant", "feel",
                "mla_absorbed", "strategy", "n_body", "params_total",
                "params_active", "model_flops_per_device",
                "flops_per_device", "bytes_per_device", "collectives",
                "collective_bytes_per_device", "memory", "compute_term_s",
                "memory_term_s", "collective_term_s", "bottleneck",
                "useful_ratio", "t_total_s", "gathered_ops", "comparable",
                "full_depth", "peak_is_estimate"):
        assert key in rec, key
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["gathered_ops"] == {} and rec["comparable"]
    assert rec["full_depth"] and not rec["peak_is_estimate"]
    total, active, model_flops = _reference_counts(
        arch, tshapes.SHAPES[shape]["kind"], tshapes.SHAPES[shape],
        512 if multi_pod else 256)
    assert (rec["params_total"], rec["params_active"]) == (total, active)
    assert rec["model_flops_per_device"] == model_flops
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    if (arch, shape) == ("llama3_2-3b", "train_4k"):
        # the loss runs on the rows of the vocab-sharded logits: no rank
        # holds the (batch, seq, vocab) plane whole, in the forward pass
        # or the backward (the peak, every layer's attention and the
        # arguments in it, may exceed one plane)
        info = tshapes.SHAPES[shape]
        plane = info["batch"] * info["seq"] * smoke_config(arch).vocab * 4
        assert 0 < largest[0] < plane
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert set(rec["collectives"]) >= {"all-gather", "all-reduce", "count"}


def test_extrapolated_counts_match_a_full_depth_run():
    """The reference's law F(u) = outside + u * body at 1 and 2 repeats
    (``full_depth=False``) gives a smoke llama's full-depth FLOPs
    exactly, its bytes within 0.1 % and its collective bytes within
    10 %; such a record marks its peak an estimate."""
    kw = dict(out_path=None,
              cfg_overrides=_smoke_overrides("llama3.2-3b", n_layers=4))
    ext = dryrun.run_one("llama3.2-3b", "train_4k", False, full_depth=False,
                         **kw)
    full = dryrun.run_one("llama3.2-3b", "train_4k", False, **kw)
    assert ext["ok"] and full["ok"] and not ext["full_depth"]
    assert ext["peak_is_estimate"] and not full["peak_is_estimate"]
    assert full["full_depth"]
    assert ext["n_body"] == 4
    assert ext["flops_per_device"] == full["flops_per_device"]
    assert ext["bytes_per_device"] == pytest.approx(full["bytes_per_device"],
                                                    rel=1e-3)
    # DTensor's layouts at the body's ends differ from its middle's, so
    # the collectives are near the law, not on it (llama3.2-3b at full
    # size, train_4k on 16x16: 2.8 % over)
    assert ext["collective_bytes_per_device"] == pytest.approx(
        full["collective_bytes_per_device"], rel=0.1)


# ------------------------------------------------------------ host mesh

def test_train_step_on_a_host_mesh_equals_the_plain_step():
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    kw = dict(steps=2, batch=4, seq=16, smoke=True, device="cpu",
              keep_params=True)
    plain = train_mod.run("llama3.2-3b", **kw)
    meshed = train_mod.run("llama3.2-3b", mesh=mesh, **kw)
    assert meshed.losses == plain.losses
    assert meshed.sigma_mean == plain.sigma_mean
    assert meshed.params.keys() == plain.params.keys()
    for name, p in plain.params.items():
        assert torch.equal(meshed.params[name], p), name


def test_serve_on_a_host_mesh_equals_the_plain_serve():
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    kw = dict(batch=2, prompt_len=16, new_tokens=3, device="cpu")
    plain = serve_mod.serve("llama3.2-3b", **kw)
    meshed = serve_mod.serve("llama3.2-3b", mesh=mesh, **kw)
    assert torch.equal(meshed.tokens, plain.tokens)
    assert torch.equal(meshed.prefill_logits, plain.prefill_logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_host_mesh_serve_and_train_gather_no_op(arch, monkeypatch):
    """Every smoke decoder served and trained a step on a 1x1 host mesh
    runs every op partitioned: none reaches the gathering mode's
    ``_gathered`` (so on this release the host mesh would pass under
    ``strict`` as the dry run does)."""
    gathered = []
    monkeypatch.setattr(sharding, "_gathered", lambda func, *a:
                        gathered.append(str(func)))
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    serve_mod.serve(arch, batch=2, prompt_len=16, new_tokens=3,
                    device="cpu", mesh=mesh)
    train_mod.run(arch, steps=1, batch=4, seq=16, smoke=True, device="cpu",
                  mesh=mesh)
    assert gathered == []


def test_gather_mode_reruns_an_op_whose_dtensor_output_is_malformed(
        monkeypatch):
    """An op to which DTensor gives an output with fewer placements than
    its mesh has dimensions (torch 2.11's ``constant_pad_nd`` on a 2-D
    mesh, here put in by a handler) runs on gathered inputs under
    ``gather_unsharded_ops``, with a well-formed, equal result."""
    import torch.nn.functional as F
    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)
    from repro_torch.launch import sharding as sh

    def malformed_pad(op, args, kwargs):
        x = args[0]
        return DTensor.from_local(op(x.to_local(), *args[1:], **kwargs),
                                  x.device_mesh, [Replicate()],
                                  run_check=False)

    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    monkeypatch.setitem(DTensor._op_dispatcher._custom_op_handlers,
                        torch.ops.aten.constant_pad_nd.default, malformed_pad)
    x = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0))
    xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    assert len(F.pad(xd, (0, 0, 2, 0)).placements) == 1
    with sh.gather_unsharded_ops() as mode:
        y = F.pad(xd, (0, 0, 2, 0))
    assert y.placements == (Replicate(), Replicate())
    assert torch.equal(y.full_tensor(), F.pad(x, (0, 0, 2, 0)))
    assert mode.ops == {"aten.constant_pad_nd.default": 1}


_SHARDED_LOSS = """
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tm

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
mesh = tmesh.make_host_mesh(1, 2, device="cpu")
cfg = smoke_config("llama3.2-3b")
gen = torch.Generator().manual_seed(0)
logits = torch.randn(4, 6, 32, generator=gen)
labels = torch.randint(-1, 32, (4, 6), generator=gen)
w = torch.randn(4, generator=gen)
lp = logits.clone().requires_grad_()
loss, n = tm.per_example_loss(cfg, lp, {"labels": labels})
(loss * w).sum().backward()
ld = distribute_tensor(logits, mesh, [Replicate(), Shard(2)])
ld.requires_grad_()
loss_d, n_d = tm.per_example_loss(cfg, ld, {"labels": labels})
(loss_d.full_tensor() * w).sum().backward()
assert ld.grad.placements == ld.placements, ld.grad.placements
assert torch.equal(loss_d.full_tensor(), loss)
assert torch.equal(n_d.full_tensor(), n)
assert torch.equal(ld.grad.full_tensor(), lp.grad)
dist.destroy_process_group()
"""


def test_the_loss_runs_on_the_rows_of_vocab_sharded_logits():
    """``per_example_loss`` on logits sharded over the vocabulary on a
    two-rank (1, 2) gloo mesh (labels a plain tensor) equals the plain
    loss bit for bit, and so does the logits' gradient, which comes
    back with the logits' own placements."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", _SHARDED_LOSS,
                               str(rank), port], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


def test_meshes_raise_without_enough_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default is met")
def test_host_mesh_asks_for_the_card_by_default():
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_host_mesh(1, 1)


def test_llama_train_4k_keeps_the_batch_split_through_attention(monkeypatch):
    """llama3.2-3b x train_4k on 16x16 (full config): the decoder's input
    is split by batch as a block's output is, and no op of the step runs
    on gathered operands: the strict dry run completes, nothing reaches
    ``sharding._gathered``, and the per-example vector's (256,) -> (K,
    256 / K) view, the last op gathered before, reads the vector whole.
    The FLOPs a device are the count pinned for this record (every layer
    run; the 24 heads do not split over 16 ranks, so each "model" rank
    attends for two blocks of the query rows, ``layers._on_query_rows``:
    4.657e14 with the attention whole on every rank), and the peak,
    arguments included, stays under 4e11 B (1.49e11: the fp32 logits of
    the rank's 16 sequences, PERF.md section 5)."""
    shapes = []
    gathered = sharding._gathered

    def recorded(func, args, kwargs):
        from torch.distributed.tensor import DTensor
        shapes.extend(tuple(x.shape) for x in
                      torch.utils._pytree.tree_leaves((args, kwargs))
                      if isinstance(x, DTensor))
        return gathered(func, args, kwargs)

    monkeypatch.setattr(sharding, "_gathered", recorded)
    rec = dryrun.run_one("llama3.2-3b", "train_4k", False, out_path=None)
    assert rec["ok"], rec.get("traceback")
    assert shapes == [] and rec["gathered_ops"] == {}
    assert rec["full_depth"]
    assert rec["flops_per_device"] == pytest.approx(LLAMA_TRAIN_4K_FLOPS,
                                                    rel=0.01)
    assert rec["memory"]["argument_bytes"] <= rec["memory"]["peak_bytes"]
    assert rec["memory"]["peak_bytes"] < 4e11


def test_gemma3_prefill_32k_peak_follows_its_layers():
    """gemma3-12b x prefill_32k on 16x16 (full config): with the decoder
    input split by batch, block 0's sliding-window attention runs on
    its rank's 2 of the 32 sequences.  With the input left split over d
    (the embedding table's layout) it ran on all 32, and its (32, 32, 8,
    2, 1024, 2048) fp32 logits set a 4.57e11 B peak at 1 and 2 pattern
    repeats alike: the law then saw no growth per repeat and gave
    4.57e11 where the run of every layer peaked at 9.30e11 B (torch
    2.13).  Now the law's peak (``full_depth=False``) is within 10 % of
    the record's, which runs every layer, and that peak is lower still
    (every op partitioned, the attention on each rank's heads)."""
    fit = dryrun.run_one("gemma3-12b", "prefill_32k", False, out_path=None,
                         full_depth=False)
    full = dryrun.run_one("gemma3-12b", "prefill_32k", False, out_path=None)
    assert fit["ok"] and full["ok"], (fit.get("traceback"),
                                      full.get("traceback"))
    assert full["full_depth"] and fit["peak_is_estimate"]
    peak, full_peak = (r["memory"]["peak_bytes"] for r in (fit, full))
    assert abs(peak / full_peak - 1.0) < 0.1, (peak, full_peak)
    assert full_peak < 8.5e11
