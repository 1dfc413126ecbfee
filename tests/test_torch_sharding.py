"""The port's sharding rules against the reference's, leaf by leaf.

The reference's rules run on a ``jax.sharding.AbstractMesh`` (no
devices); the port's on a ``launch.mesh.MeshShape`` (no process group).
For all ten archs at full size on both production meshes (16x16 and
2x16x16): every parameter's spec equals its reference leaf's, minus the
stacked lead for a body member (the reference stacks the body, the port
keeps a parameter per layer), and the per-device bytes are equal; the
same for the optimizer state (adamw, and adafactor for the DeepSeek
configs), the caches at ``decode_32k`` and ``long_500k``, and each
modality's batch under ``tp`` and ``fsdp``.  Specs are compared
normalized (JAX prints ``('data',)`` as ``'data'``).  Also the
reference's ``_param_spec`` cases through both packages, ``SHAPES`` and
``applicable``, the (name, shape) sequence a recording constrainer sees
in every block kind's prefill, decode and train forward at smoke size,
and ``checkpoint.restore_sharded`` of a reference-written checkpoint.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import make_cache as j_make_cache  # noqa: E402
from repro.models import make_decode_step as j_make_decode_step  # noqa: E402
from repro.models import make_forward as j_make_forward  # noqa: E402
from repro.models import make_prefill_step as j_make_prefill_step  # noqa: E402
from repro.models import shard_ctx as j_shard_ctx  # noqa: E402
from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch.configs import ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import shard_ctx as t_shard_ctx  # noqa: E402
from repro_torch.models.transformer import _layer_plan  # noqa: E402

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Destroy any process group a test starts, so that later files on
    the same worker start from none."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), tmesh.MeshShape(axes, shape)


def _key(p):
    return str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))


def _ref_leaves(tree):
    """{'/'-joined path: leaf} of a JAX tree."""
    return {"/".join(_key(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_specs(am, tree, shardings):
    """{path: (normalized spec, per-device bytes)}."""
    leaves = _ref_leaves(tree)
    out = {}
    for path, s in _ref_leaves(shardings).items():
        leaf = leaves[path]
        spec = tuple(s.spec) + (None,) * (leaf.ndim - len(s.spec))
        local = JNamedSharding(am, s.spec).shard_shape(leaf.shape)
        out[path] = (tsh.normalize(spec),
                     math.prod(local) * jnp.dtype(leaf.dtype).itemsize)
    return out


def _ref_path(cfg, name, prefix=""):
    """The reference's path of the port's leaf ``name`` and whether it is
    a body member (the reference's leaf then stacks the repeats)."""
    parts = name.split(".")
    if parts[:2] == ["decoder", "body"] and parts[2].isdigit():
        P_ = len(_layer_plan(cfg)[2])
        parts[2] = f"pos{int(parts[2]) % P_}"
        return prefix + "/".join(parts), True
    return prefix + "/".join(parts), False


def _port_bytes(sharding, x):
    return math.prod(sharding.shard_shape(x.shape)) * x.element_size()


def _check_tree(cfg, ref, port_shardings, port_leaves, prefix=""):
    """Every port leaf's spec is its reference leaf's (its lead dropped
    for a body member), every reference leaf is covered, and the
    per-device bytes agree."""
    seen, port_total = set(), 0
    for name, s in port_shardings.items():
        path, member = _ref_path(cfg, name, prefix)
        assert path in ref, f"{name}: no reference leaf {path}"
        want = ref[path][0][1:] if member else ref[path][0]
        assert tsh.normalize(s.spec) == want, (name, s.spec, want)
        seen.add(path)
        port_total += _port_bytes(s, port_leaves[name])
    assert seen == set(ref)
    assert port_total == sum(b for _, b in ref.values())
    return port_total


@pytest.mark.parametrize("case", [
    ("wq", (4096, 4096), (None, "model")),
    ("w_gate", (4096, 16384), (None, "model")),
    ("wo", (4096, 4096), ("model", ("data",))),
    ("w_down", (16384, 4096), ("model", ("data",))),
    ("embed", (128000, 4096), ("model", ("data",))),
    ("ln1", (4096,), (None,)),
    ("wk", (4096, 24), (None, None)),
], ids=lambda c: c[0] + "-" + "x".join(map(str, c[1])))
def test_param_spec_megatron_pairing_in_both_packages(case):
    name, shape, want = case
    kw = dict(model=16, data=16, data_ax=("data",), skip_leading=False,
              is_expert=False)
    assert tsh.normalize(jsh._param_spec(name, shape, **kw)) \
        == tsh.normalize(want)
    assert tsh._param_spec(name, shape, **kw) == want


@pytest.mark.parametrize("case", [
    ("wq", (28, 4096, 4096), False, (None, None, "model")),
    ("w_gate", (28, 256, 7168, 2048), True,
     (None, ("data", "model"), None, None)),
    ("w_gate", (28, 160, 5120, 1536), True,
     (None, "model", None, ("data",))),
], ids=["stacked", "experts-joint", "experts-160"])
def test_param_spec_scan_stacked_and_experts_in_both_packages(case):
    name, shape, expert, want = case
    kw = dict(model=16, data=16, data_ax=("data",), skip_leading=True,
              is_expert=expert)
    assert tsh.normalize(jsh._param_spec(name, shape, **kw)) \
        == tsh.normalize(want)
    assert tsh._param_spec(name, shape, **kw) == want


def test_shapes_and_applicability_equal_the_reference():
    assert tshapes.SHAPES == jshapes.SHAPES
    assert tshapes.LONG_OK == jshapes.LONG_OK
    for arch in ARCHS:
        for shape in jshapes.SHAPES:
            assert tshapes.applicable(arch, shape) \
                == jshapes.applicable(arch, shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_equal_the_reference(arch, mesh_name):
    am, ms = _meshes(mesh_name)
    cfg_j, cfg = j_get_config(arch), get_config(arch)
    params_abs = jax.eval_shape(lambda k: j_init_model(k, cfg_j),
                                jax.random.PRNGKey(0))
    ref = _ref_specs(am, params_abs,
                     jsh.param_shardings(am, params_abs, cfg_j))
    model = tm.init_model(cfg, None, "meta")
    params = dict(model.named_parameters())
    got = _check_tree(cfg, ref, tsh.param_shardings(ms, model, cfg), params)
    if (arch, mesh_name) == ("deepseek-v3-671b", "2x16x16"):
        assert got == 3_576_628_224

    # the optimizer state follows its parameter
    opt_j = jshapes.make_optimizer(cfg_j)
    opt_abs = jax.eval_shape(opt_j.init, params_abs)
    ref_opt = _ref_specs(am, opt_abs, jsh.param_shardings(am, opt_abs, cfg_j))
    state = tshapes.make_optimizer(cfg).init(params)
    shardings = tsh.opt_state_shardings(ms, state, cfg)
    assert cfg.optimizer == cfg_j.optimizer
    fields = [f for f, v in state._asdict().items() if isinstance(v, dict)]
    assert fields
    total = 0
    for field in fields:
        sub = {p: v for p, v in ref_opt.items()
               if p.startswith(field + "/")}
        total += _check_tree(cfg, sub, getattr(shardings, field),
                             getattr(state, field), prefix=field + "/")
    scalars = [v for p, v in ref_opt.items()
               if not any(p.startswith(f + "/") for f in fields)]
    assert all(spec == () for spec, _ in scalars)  # the step count
    assert total + sum(b for _, b in scalars) \
        == sum(b for _, b in ref_opt.values())


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh_name):
    am, ms = _meshes(mesh_name)
    cfg_j, cfg = j_get_config(arch), get_config(arch)
    for shape in ("decode_32k", "long_500k"):
        if not tshapes.applicable(arch, shape):
            continue
        B, S = jshapes.SHAPES[shape]["batch"], jshapes.SHAPES[shape]["seq"]
        cache_abs = jax.eval_shape(
            lambda: j_make_cache(cfg_j, B, S, dtype=cfg_j.act_dtype))
        ref = _ref_specs(am, cache_abs,
                         jsh.cache_shardings(am, cache_abs, B))
        cache = tm.make_cache(cfg, B, S, dtype=cfg.act_dtype, device="meta")
        got = tsh.cache_shardings(ms, cache, B)
        flat = {}

        def walk(t, s, path):
            if isinstance(t, dict):
                for k in t:
                    walk(t[k], s[k], path + (str(k),))
            elif isinstance(t, list):
                for i, (a, b) in enumerate(zip(t, s)):
                    walk(a, b, path + (str(i),))
            else:
                flat["/".join(path)] = (s, t)
        walk(cache, got, ())
        assert set(flat) == set(ref)
        for path, (s, t) in flat.items():
            assert tsh.normalize(s.spec) == ref[path][0], (shape, path)
            assert _port_bytes(s, t) == ref[path][1]

    n_clients = tmesh.data_size(ms)
    for shape, info in jshapes.SHAPES.items():
        for strategy in ("tp", "fsdp"):
            B, S = info["batch"], info["seq"]
            b_abs = jshapes._abstract_batch(cfg_j, info["kind"], B, S,
                                            n_clients, True)
            ref = _ref_specs(am, b_abs, jsh.batch_shardings(
                am, b_abs, strategy=strategy))
            batch = tshapes._abstract_batch(cfg, info["kind"], B, S,
                                            n_clients, True)
            got = tsh.batch_shardings(ms, batch, strategy=strategy)
            assert set(got) == set(ref)
            for name, s in got.items():
                assert tsh.normalize(s.spec) == ref[name][0], \
                    (shape, strategy, name)
                x = batch[name]
                if isinstance(x, torch.Tensor):
                    assert _port_bytes(s, x) == ref[name][1]


def test_joint_entries_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    ms = tmesh.production_shape(multi_pod=True)
    assert tsh.to_placements(ms, (None, ("pod", "data", "model"))) \
        == (Shard(1), Shard(1), Shard(1))
    assert tsh.to_placements(ms, (("pod", "data"), "model")) \
        == (Shard(0), Shard(0), Shard(1))
    assert tsh.to_placements(tmesh.MeshShape(("data", "model"), (1, 4)),
                             ("data", "model")) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        tsh.to_placements(ms, (("model", "data"),))


# ------------------------------------------------------- the constrainer

SEQUENCE_ARCHS = ("llama3.2-3b", "gemma3-12b", "deepseek-v3-671b",
                  "falcon-mamba-7b", "recurrentgemma-9b", "qwen2-vl-2b",
                  "musicgen-medium")
CASES = [(arch, mode) for arch in SEQUENCE_ARCHS
         for mode in ("prefill", "decode", "train")
         + (("decode_absorbed",) if "deepseek" in arch else ())]


def _one_repeat(cfg):
    """The config with the layer pattern once (the reference traces its
    scanned body once), the head and tail kept."""
    head, _, pattern, tail = _layer_plan(cfg)
    return cfg.scaled(n_layers=len(head) + len(pattern) + len(tail))


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.modality == "vlm":
        pos = np.broadcast_to(np.arange(S), (B, 3, S)).astype(np.int32)
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32), "positions": pos}
    shape = (B, cfg.n_codebooks, S) if cfg.modality == "audio" else (B, S)
    return {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32)}


@pytest.mark.parametrize("arch,mode", CASES)
def test_constrainer_sees_the_reference_sequence(arch, mode):
    cfg_j = _one_repeat(j_smoke_config(arch).scaled(dtype="float32"))
    cfg = _one_repeat(smoke_config(arch).scaled(dtype="float32"))
    B, S = 2, 8
    tree = jax.tree.map(np.asarray,
                        j_init_model(jax.random.PRNGKey(0), cfg_j))
    model = tm.params_from_numpy(cfg, tree)
    np_batch = _batch(cfg, B, S if mode in ("prefill", "train") else 1)
    j_batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    t_batch = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}

    def recorder(log):
        def fn(x, name):
            log.append((name, tuple(int(n) for n in x.shape)))
            return x
        return fn

    want, got = [], []
    absorbed = mode == "decode_absorbed"
    with j_shard_ctx.use_constrainer(recorder(want)):
        if mode == "prefill":
            j_make_prefill_step(cfg_j)(tree, j_batch)
        elif mode == "train":
            j_make_forward(cfg_j)(tree, j_batch)
        else:
            j_batch["cache_index"] = jnp.asarray(S - 1, jnp.int32)
            if cfg_j.modality == "vlm":
                j_batch["positions"] = j_batch["positions"] + (S - 1)
            j_make_decode_step(cfg_j, mla_absorbed=absorbed)(
                tree, j_make_cache(cfg_j, B, S), j_batch)
    with t_shard_ctx.use_constrainer(recorder(got)), torch.no_grad():
        if mode == "prefill":
            tm.make_prefill_step(cfg)(model, t_batch)
        elif mode == "train":
            tm.make_forward(cfg)(model, t_batch)
        else:
            t_batch["cache_index"] = S - 1
            if cfg.modality == "vlm":
                t_batch["positions"] = t_batch["positions"] + (S - 1)
            tm.make_decode_step(cfg, mla_absorbed=absorbed)(
                model, tm.make_cache(cfg, B, S), t_batch)
    # the port also constrains the decoder's input as a block's output
    # (transformer.apply_decoder), one site before the reference's
    S_in = S if mode in ("prefill", "train") else 1
    assert got[0] == ("act_btd", (B, S_in, cfg.d_model))
    assert got[1:] == want
    assert want  # every mode constrains something


# ------------------------------------------------------------ checkpoint

def test_restore_sharded_lays_out_a_reference_checkpoint(tmp_path):
    from torch.distributed.tensor import DTensor
    rng = np.random.default_rng(0)
    tree = {"params": {"embed": jnp.asarray(
                rng.standard_normal((8, 4)), jnp.bfloat16),
            "w": jnp.asarray(rng.standard_normal((4, 6)), jnp.float32)},
            "count": jnp.asarray(3, jnp.int32)}
    path = str(tmp_path / "ckpt")
    j_ckpt.save_pytree(path, tree)
    mesh = tmesh.make_host_mesh(1, 1, device="cpu")
    like = {"params": {
        "embed": tsh.NamedSharding(mesh, ("model", "data")),
        "w": tsh.NamedSharding(mesh, (None, "model"))},
        "count": None}
    got = t_ckpt.restore_sharded(path, like)
    for name in ("embed", "w"):
        x = got["params"][name]
        assert isinstance(x, DTensor) and x.device_mesh == mesh
        assert tuple(x.placements) \
            == like["params"][name].placements
        want = np.asarray(tree["params"][name], np.float32)
        np.testing.assert_array_equal(x.full_tensor().float().numpy(), want)
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert not isinstance(got["count"], DTensor) and int(got["count"]) == 3

    # a DTensor target on a mesh of 4 (fake) ranks: rank 0 holds its shard
    dist.destroy_process_group()
    from repro_torch.launch.dryrun import start_fake_world
    start_fake_world(4)
    mesh4 = tmesh.make_mesh(tmesh.MeshShape(("data", "model"), (2, 2)),
                            device_type="cpu")
    like4 = {"params": {
        "embed": tsh.NamedSharding(mesh4, ("model", "data")),
        "w": tsh.NamedSharding(mesh4, (None, "model"))}, "count": None}
    got4 = t_ckpt.restore_sharded(path, like4)
    embed = got4["params"]["embed"]
    assert tuple(embed.shape) == (8, 4)
    assert tuple(embed.to_local().shape) == (4, 2)
    np.testing.assert_array_equal(
        embed.to_local().float().numpy(),
        np.asarray(tree["params"]["embed"], np.float32)[:4, :2])
