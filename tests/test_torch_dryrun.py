"""The dry run counts a partitioned step.

* ``LocalCost`` keeps each collective's kind and byte count, never its
  output, and counts the all-gather and chunk that a CPU group runs for
  an all-to-all as that all-to-all.
* Work is conserved: on a fake (2, 2) mesh each rank's FLOPs are a
  quarter of the FLOPs on a fake (1, 1) mesh, for a train, a prefill and
  a decode step of the llama, mamba and deepseek-v2 smoke configs (no
  rule of the reference's replicates a matmul's operand at these
  shapes).  Where heads do not divide, the attention splits query rows
  or cache slots: a 6-head llama's FLOPs from (2, 2) to (2, 4) scale as
  the reference's XLA program's, and on two gloo ranks it serves and
  trains as the plain decoder; a sequence-split cache is attended on
  each rank's slots (gemma3-12b x long_500k gathers no cache).
* DeepSeek's expert-side top-C taken in two stages (per token shard,
  then over the gathered candidates) equals the reference's one-shot
  ``lax.top_k``, ties broken by token index; the deepseek-v2 smoke
  decoder served on a two-rank gloo mesh, its experts split over
  "model" or its tokens over "data", equals the plain decoder.
* A record's peak is its full-depth run's (falcon-mamba-7b x
  decode_32k), arguments included.
"""
import dataclasses
import gc
import json
import math
import os
import socket
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Destroy any process group a test starts, so that later files on
    the same worker start from none."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _smoke_overrides(arch):
    cfg = smoke_config(arch)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _fake_mesh(sizes, names):
    dryrun.start_fake_world(math.prod(sizes))
    return tmesh.make_mesh(tmesh.MeshShape(names, sizes), device_type="cpu")


# ------------------------------------------------------------ counting

def test_local_cost_keeps_no_collective_output():
    """A collective's output dies once the caller drops it: the count
    keeps its kind and bytes only (it kept the output, and so every
    all-gather's result stayed alive to the step's end in the peak)."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    _fake_mesh((16,), ("data",))
    with FakeTensorMode():
        x = torch.empty(64, 32)
        with dryrun.LocalCost() as cost:
            out = funcol.wait_tensor(funcol.all_gather_single(
                x, 0, dist.group.WORLD))
            ref = weakref.ref(out)
            live = cost.live
            del out
            gc.collect()
            assert ref() is None
            assert cost.live == live - 16 * 64 * 32 * 4
    assert cost.collectives == [("all_gather_into_tensor", 16 * 64 * 32 * 4)]
    assert cost.peak == live


def test_an_all_to_all_counts_as_an_all_to_all():
    """Shard(0) -> Shard(1) on a fake 16-rank mesh is an all-to-all; a
    CPU group runs it as an all-gather and a chunk, which the count
    takes as the one all-to-all, at the all-to-all's bytes (the local
    shard's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = _fake_mesh((16,), ("model",))
    with FakeTensorMode(allow_non_fake_inputs=True), \
            dryrun._outside_the_count():
        x = distribute_tensor(torch.empty(256, 512), mesh, [Shard(0)])
        with dryrun.LocalCost() as cost:
            y = x.redistribute(mesh, [Shard(1)])
    assert tuple(y.to_local().shape) == (256, 32)
    got = dryrun.collective_bytes(cost.collectives)
    assert got["count"] == 1 and got["all-gather"] == 0
    assert got["all-to-all"] == 16 * 512 * 4


# ---------------------------------------------------- work conservation

@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "falcon-mamba-7b",
                                  "deepseek-v2-236b"])
def test_work_is_conserved_on_a_2x2_mesh(arch, shape):
    """Per-rank FLOPs on a fake (2, 2) mesh, times 4, equal the FLOPs of
    the same step on a fake (1, 1) mesh within 1 %: every matmul of the
    step runs partitioned (``layers.matmul``), attention on each rank's
    heads and batch, the MoE on each rank's tokens and experts.  These
    smoke shapes split evenly everywhere, so no rule of the reference's
    replicates an operand here (at full size llama's 24 heads over 16
    ranks are one: ``act_bthd`` keeps them whole on every "model" rank,
    16 times the attention's work)."""
    flops = {}
    for sizes in ((2, 2), (1, 1)):
        rec = dryrun.run_one(arch, shape, False, out_path=None,
                             cfg_overrides=_smoke_overrides(arch),
                             mesh_shape=tmesh.MeshShape(("data", "model"),
                                                        sizes))
        assert rec["ok"], rec.get("traceback")
        assert rec["gathered_ops"] == {}
        flops[sizes] = rec["flops_per_device"]
    assert 4 * flops[(2, 2)] == pytest.approx(flops[(1, 1)], rel=0.01)


_REFERENCE_TRAIN_FLOPS = """
import dataclasses, json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
from repro.configs import smoke_config
from repro.launch import dryrun, sharding
from repro.launch import shapes
shapes.SHAPES["train_4k"] = dict(shapes.SHAPES["train_4k"], seq=1024)
cfg = smoke_config("llama3.2-3b")
over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "scan_unroll"}
over.update(n_heads=6, n_kv_heads=2, unroll_layers=True)
flops = {}
for data, model in ((2, 2), (2, 4)):
    devs = np.asarray(jax.devices()[:data * model]).reshape(data, model)
    mesh = jax.sharding.Mesh(devs, ("data", "model"))
    spec = shapes.build_spec("llama3.2-3b", "train_4k", mesh,
                             cfg_overrides=over)
    with mesh, sharding.with_mesh_constraints(mesh, "tp"):
        flops[f"{data}x{model}"] = dryrun._compile_metrics(spec)["flops"]
print(json.dumps(flops))
"""


def test_heads_that_do_not_divide_are_partitioned_as_the_reference(
        monkeypatch):
    """A smoke llama with 6 heads (2 kv heads) trained at seq 1024 on
    fake (2, 2) and (2, 4) meshes: at 4 "model" ranks neither head count
    divides, as llama3.2-3b's 24 and 8 heads do not over 16.  The
    reference's XLA program (its cost analysis on 8 host devices; at
    seq 1024 its q-chunk loop, whose body XLA counts once, runs one
    chunk) partitions the attention anyway, its FLOPs per device at
    (2, 4) 0.56 of (2, 2)'s; the port splits the query rows there
    (``layers._on_query_rows``), 0.50.  The ratios agree within 15 %
    (the port's was 1.46 with the attention whole on every rank)."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="2")
    done = subprocess.run([sys.executable, "-c", _REFERENCE_TRAIN_FLOPS],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    ref = json.loads(done.stdout.strip().splitlines()[-1])
    from repro_torch.launch import shapes as tshapes
    monkeypatch.setitem(tshapes.SHAPES, "train_4k",
                        dict(tshapes.SHAPES["train_4k"], seq=1024))
    over = dict(_smoke_overrides("llama3.2-3b"), n_heads=6, n_kv_heads=2)
    port = {}
    for sizes in ((2, 2), (2, 4)):
        rec = dryrun.run_one("llama3.2-3b", "train_4k", False, out_path=None,
                             cfg_overrides=over,
                             mesh_shape=tmesh.MeshShape(("data", "model"),
                                                        sizes))
        assert rec["ok"], rec.get("traceback")
        port["x".join(map(str, sizes))] = rec["flops_per_device"]
    assert port["2x4"] / port["2x2"] == pytest.approx(
        ref["2x4"] / ref["2x2"], rel=0.15)


# ------------------------------------------------------------------ MoE

@pytest.mark.parametrize("splits", [(64,), (16, 16, 16, 16), (8, 24, 32),
                                    (40, 24)])
def test_two_stage_top_c_equals_the_one_shot(splits):
    """Each expert's top-C over all tokens, taken per token shard then
    over the gathered candidates, equals the reference's one-shot
    ``lax.top_k`` over the (E, G) gate matrix: values and token indices,
    ties (gates of 0, and equal gates drawn from a few levels) broken by
    the lower token index as ``lax.top_k`` breaks them."""
    rng = np.random.default_rng(len(splits))
    G, E, C = sum(splits), 6, 24
    levels = np.array([0.0, 0.25, 0.5, 0.75], np.float32)
    gate = levels[rng.integers(0, 4, (G, E))]
    gate[rng.random((G, E)) < 0.5] = 0.0
    gate[:, 0] = rng.random(G).astype(np.float32)       # no ties here
    want_v, want_i = jax.lax.top_k(jnp.asarray(gate.T), C)
    cands, g0 = [], 0
    for shard in torch.from_numpy(gate).split(list(splits)):
        cands.append(moe._top_c_shard(shard, C, g0))   # each rank's stage
        g0 += shard.shape[0]
    got_v, got_i = moe._top_c_merge(torch.cat([v for v, _ in cands], 1),
                                    torch.cat([i for _, i in cands], 1), C)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # without ties it is torch's one-shot top-k too
    v, i = torch.topk(torch.from_numpy(gate.T[:1]), C, dim=-1)
    assert torch.equal(got_v[:1], v) and torch.equal(got_i[:1], i)


def _two_gloo_ranks(script):
    """Run ``script`` as two gloo ranks over localhost; both must exit
    0."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen([sys.executable, "-c", script,
                               str(rank), port], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


_SHARDED_DEEPSEEK = """
import sys
import torch
import torch.distributed as dist
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as serve_mod

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
cfg = smoke_config("deepseek-v2-236b").scaled(dtype="float32")
kw = dict(batch=2, prompt_len=16, new_tokens=3, device="cpu")
plain = serve_mod.serve(cfg, **kw)
for shape in ((1, 2), (2, 1)):
    meshed = serve_mod.serve(cfg, mesh=tmesh.make_host_mesh(*shape,
                                                            device="cpu"),
                             **kw)
    assert meshed.moe_dispatch == plain.moe_dispatch, shape
    assert torch.equal(meshed.tokens, plain.tokens), shape
    torch.testing.assert_close(meshed.prefill_logits, plain.prefill_logits,
                               rtol=1e-5, atol=1e-5)
dist.destroy_process_group()
"""


def test_sharded_deepseek_decoder_equals_the_plain_one():
    """The deepseek-v2 smoke decoder (fp32) served on a two-rank gloo
    mesh over localhost, as (1, 2) (experts split over "model") and as
    (2, 1) (tokens split over "data", the top-C in two stages), routes
    as the plain decoder (the MoE's C and dropped pairs per layer),
    decodes the same tokens and gives its prefill logits within 1e-5:
    the partitioned combine adds each rank's experts and then sums over
    the ranks, the plain one adds every expert in turn."""
    _two_gloo_ranks(_SHARDED_DEEPSEEK)


_SEQUENCE_SPLIT_DECODE = """
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as serve_mod
from repro_torch.models.layers import decode_attend

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
mesh = tmesh.make_host_mesh(2, 1, device="cpu")
g = torch.Generator().manual_seed(0)
for C, rolling, window, cap, idx in ((256, False, 0, 0.0, 200),
                                     (256, False, 64, 50.0, 255),
                                     (128, True, 128, 0.0, 300),
                                     (128, True, 128, 1.5, 60)):
    q = torch.randn(1, 1, 4, 32, generator=g)
    k, v = (torch.randn(1, C, 2, 32, generator=g) for _ in range(2))
    want = decode_attend(q, k, v, idx, window, rolling, softcap=cap)
    got = decode_attend(distribute_tensor(q, mesh, [Replicate()] * 2),
                        distribute_tensor(k, mesh, [Shard(1), Replicate()]),
                        distribute_tensor(v, mesh, [Shard(1), Replicate()]),
                        idx, window, rolling, softcap=cap).full_tensor()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
cfg = smoke_config("gemma3-12b").scaled(dtype="float32", window=128,
                                        attn_logit_softcap=50.0)
kw = dict(batch=1, prompt_len=200, new_tokens=56, device="cpu")
plain = serve_mod.serve(cfg, **kw)
meshed = serve_mod.serve(cfg, mesh=mesh, **kw)
assert torch.equal(meshed.tokens, plain.tokens)
torch.testing.assert_close(meshed.prefill_logits, plain.prefill_logits,
                           rtol=1e-5, atol=1e-5)
dist.destroy_process_group()
"""


def test_decode_on_a_sequence_split_cache_equals_the_plain_one():
    """A batch of 1 on a (2, 1) gloo mesh holds its caches split by
    slot over "data" (the ``kv_cache`` rule at long_500k): each rank
    attends over its own slots and the partial softmaxes are merged.
    ``decode_attend`` on such caches (whole and rolling, windowed,
    softcapped) equals the plain one within 1e-5, and a gemma3 smoke
    decoder (fp32, window 128, softcap 50) served past its window on
    the mesh decodes the plain decoder's tokens."""
    _two_gloo_ranks(_SEQUENCE_SPLIT_DECODE)


def test_gemma3_long_500k_decode_gathers_no_cache(monkeypatch):
    """gemma3-12b x long_500k on 16x16 (full config, batch 1): the
    caches are split by slot over "data", and no all-gather's output
    holds more than one rank's slots of a layer's cache (each rank
    attended over every slot of its own kv heads before: 16 all-gathers
    of 2**28 B).  What is left is the reference's ``kv_cache``
    constraint, which keeps the slot split and the head dim whole where
    the cache's argument splits it over "model"."""
    sizes = []
    count = dryrun.collective_bytes

    def spy(records):
        sizes.extend(b for name, b in records if "all_gather" in name)
        return count(records)

    monkeypatch.setattr(dryrun, "collective_bytes", spy)
    rec = dryrun.run_one("gemma3-12b", "long_500k", False, out_path=None)
    assert rec["ok"], rec.get("traceback")
    assert rec["gathered_ops"] == {}
    slots, Hk, Dh = 524288, 8, 256                # bf16 caches, 16 data
    assert max(sizes) <= slots // 16 * Hk * Dh * 2


_HEADS_THAT_DO_NOT_DIVIDE = """
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import layers

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
mesh = tmesh.make_host_mesh(1, 2, device="cpu")
whole = lambda t: distribute_tensor(t, mesh, [Replicate()] * 2)
g = torch.Generator().manual_seed(0)
q = torch.randn(2, 16, 3, 32, generator=g)
k, v = (torch.randn(2, 16, 1, 32, generator=g) for _ in range(2))
w = torch.randn(2, 16, 3, 32, generator=g)
want = layers.causal_attend(q, k, v, q_offset=4)   # the flash op: no grad
got = layers.causal_attend(whole(q), whole(k), whole(v), q_offset=4)
torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5, atol=1e-6)
for call in (lambda q, k, v: layers.causal_attend(q, k, v, window=5,
                                                  softcap=2.0),
             lambda q, k, v: layers.causal_attend_chunked(q, k, v,
                                                          q_chunk=3)):
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = call(*ins)
    (want * w).sum().backward()
    dts = [whole(t).requires_grad_() for t in (q, k, v)]
    got = call(*dts)
    (got.full_tensor() * w).sum().backward()
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5, atol=1e-6)
    for a, b in zip(dts, ins):
        torch.testing.assert_close(a.grad.full_tensor(), b.grad, rtol=1e-5,
                                   atol=1e-6)
cfg = smoke_config("llama3.2-3b").scaled(dtype="float32", n_heads=3,
                                         n_kv_heads=1)
kw = dict(batch=2, prompt_len=16, new_tokens=4, device="cpu")
plain = serve_mod.serve(cfg, **kw)
meshed = serve_mod.serve(cfg, mesh=mesh, **kw)
assert torch.equal(meshed.tokens, plain.tokens)
torch.testing.assert_close(meshed.prefill_logits, plain.prefill_logits,
                           rtol=1e-5, atol=1e-5)
kw = dict(steps=2, batch=4, seq=16, device="cpu", keep_params=True)
plain = train_mod.run(cfg, **kw)
meshed = train_mod.run(cfg, mesh=mesh, **kw)
torch.testing.assert_close(meshed.losses, plain.losses, rtol=1e-5, atol=0)
for name, p in plain.params.items():
    torch.testing.assert_close(meshed.params[name], p, rtol=1e-4, atol=1e-5)
dist.destroy_process_group()
"""


def test_heads_that_do_not_divide_split_the_rows_on_two_ranks():
    """Three heads over a (1, 2) gloo mesh: the causal attention (the
    flash op's plain version, the windowed and softcapped route, the
    q-chunked train path) splits the query rows between the ranks and
    equals the plain one, its gradients too; the decode splits the
    cache's slots.  A llama smoke decoder with 3 heads (fp32) serves the
    plain decoder's tokens and trains 2 FEEL steps to its losses and
    parameters."""
    _two_gloo_ranks(_HEADS_THAT_DO_NOT_DIVIDE)


# ----------------------------------------------------------------- peak

def test_falcon_mamba_decode_32k_peak_is_the_full_depth_runs():
    """falcon-mamba-7b x decode_32k on 16x16 (full config): the record
    runs all 64 layers, and its peak is that run's and holds the 6.46e8
    argument bytes.  The law of 1 and 2 repeats (``full_depth=False``)
    marks its peak an estimate."""
    rec = dryrun.run_one("falcon-mamba-7b", "decode_32k", False,
                         out_path=None)
    again = dryrun.run_one("falcon-mamba-7b", "decode_32k", False,
                           out_path=None, full_depth=True)
    fit = dryrun.run_one("falcon-mamba-7b", "decode_32k", False,
                         out_path=None, full_depth=False)
    assert rec["ok"] and again["ok"] and fit["ok"]
    assert rec["full_depth"] and not rec["peak_is_estimate"]
    assert rec["n_body"] == 64
    peak = rec["memory"]["peak_bytes"]
    assert peak == again["memory"]["peak_bytes"]
    assert peak >= rec["memory"]["argument_bytes"]
    assert rec["flops_per_device"] == again["flops_per_device"]
    assert fit["peak_is_estimate"] and not fit["full_depth"]
