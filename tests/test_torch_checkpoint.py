"""The port's checkpoints against the reference's format, both ways.

A checkpoint is an npz of '/'-joined leaf paths plus a ``.meta.json``
(``repro/checkpoint/checkpoint.py``).  The port writes its CNN and Adam
state in the reference's layout (``cnn.params_to_numpy``: HWIO convs,
(in, out) dense kernels, fc1 rows in (h, w, c) order; ``opt_state/
.count`` an int32 scalar, ``.mu``/``.nu`` mapped like the params), so
``repro.checkpoint.load_pytree`` reads it into the reference's own tree
with every array equal; the port reads the reference's files; bf16
leaves (stored as uint16 bits) cross in both directions; and a JAX
trainer checkpoint, which carries a JAX key instead of the port's
generator state, resumes in the port only with a ``channel_source``.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import default_system as j_default_system  # noqa: E402
from repro.data import SyntheticImages as JSyntheticImages  # noqa: E402
from repro.data import non_iid_split as j_non_iid_split  # noqa: E402
from repro.fed import FEELConfig as JFEELConfig  # noqa: E402
from repro.fed import FEELTrainer as JFEELTrainer  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.core import default_system  # noqa: E402
from repro_torch.data import SyntheticImages, non_iid_split  # noqa: E402
from repro_torch.fed import (FEELConfig, FEELTrainer, FaultSpec,  # noqa: E402
                             ResilienceConfig)
from repro_torch.fed.rounds import CKPT_NAME, GEN_STATE_KEY  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

K, N, Q, D_HAT, SIDE, GP_STEPS = 4, 2, 2, 8, 10, 30


def _data(mod_synth, mod_split):
    train = mod_synth.make(240, side=SIDE, seed=0)
    test = mod_synth.make(80, side=SIDE, seed=1)
    return mod_split(train, test, K=K, per_device=40, mislabel_prop=0.1,
                     seed=0)


def _reference_tree():
    params = jcnn.init(jax.random.PRNGKey(0), jcnn.CNNConfig(side=SIDE))
    return {"params": params, "opt_state": joptim.adam(1e-3).init(params)}


def _port_trainer(**kw):
    model = cnn.CNN(cnn.CNNConfig(side=SIDE),
                    generator=torch.Generator().manual_seed(0))
    return FEELTrainer(
        default_system(K=K, N=N, Q=Q, D_hat=D_HAT, device="cpu"),
        _data(SyntheticImages, non_iid_split), model,
        FEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS, eval_every=100), **kw)


def test_params_to_numpy_inverts_params_from_numpy():
    ref = jax.tree.map(np.asarray, _reference_tree()["params"])
    back = cnn.params_to_numpy(cnn.params_from_numpy(ref))
    assert back.keys() == ref.keys()
    for layer in ref:
        for leaf in ("w", "b"):
            assert back[layer][leaf].dtype == np.float32
            np.testing.assert_array_equal(back[layer][leaf],
                                          ref[layer][leaf])
    model = cnn.CNN(cnn.CNNConfig(side=SIDE),
                    generator=torch.Generator().manual_seed(3))
    sd = cnn.params_from_numpy(cnn.params_to_numpy(
        dict(model.named_parameters())))
    for name, p in model.named_parameters():
        assert torch.equal(sd[name], p.detach())


def test_port_checkpoint_reads_into_reference_tree(tmp_path):
    tr = _port_trainer(faults=FaultSpec(seed=5, nan_prob=0.3),
                       resilience=ResilienceConfig())
    tr.run(2)
    path = tr.save_checkpoint(str(tmp_path / CKPT_NAME), next_round=2)
    assert sorted(os.listdir(tmp_path)) == [f"{CKPT_NAME}.meta.json",
                                            f"{CKPT_NAME}.npz"]
    tree = jckpt.load_pytree(path, _reference_tree())
    want = {"params": cnn.params_to_numpy(tr.params),
            "mu": cnn.params_to_numpy(tr.opt_state.mu),
            "nu": cnn.params_to_numpy(tr.opt_state.nu)}
    got = {"params": tree["params"], "mu": tree["opt_state"].mu,
           "nu": tree["opt_state"].nu}
    for part in want:
        for layer in want[part]:
            for leaf in ("w", "b"):
                arr = np.asarray(got[part][layer][leaf])
                assert arr.dtype == np.float32
                np.testing.assert_array_equal(arr, want[part][layer][leaf])
    count = tree["opt_state"].count
    assert count.dtype == jnp.int32 and count.shape == () and int(count) == 2
    meta = jckpt.load_metadata(path)
    # every key the reference writes, meaning the same; the JAX key is
    # null and the port's own generator state sits beside it
    ref_meta_keys = {"next_round", "cum_net_cost", "rng_state", "jax_key",
                     "strikes", "quarantined_until", "seed", "fault_spec"}
    assert set(meta) == ref_meta_keys | {GEN_STATE_KEY}
    assert meta["next_round"] == 2 and meta["jax_key"] is None
    assert meta["rng_state"] == tr.rng.bit_generator.state
    assert meta["fault_spec"] == FaultSpec(seed=5, nan_prob=0.3).to_dict()


def test_reference_checkpoint_reads_into_port(tmp_path):
    ref = _reference_tree()
    ref["opt_state"] = ref["opt_state"]._replace(
        count=jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "ref")
    jckpt.save_pytree(path, ref, metadata={"note": "reference"})
    like = {"params": cnn.params_to_numpy(
        dict(cnn.CNN(cnn.CNNConfig(side=SIDE)).named_parameters())),
        "opt_state": {".count": 0, ".mu": {}, ".nu": {}}}
    like["opt_state"][".mu"] = like["opt_state"][".nu"] = like["params"]
    got = ckpt.load_pytree(path, like)
    for layer, leaves in ref["params"].items():
        for leaf, arr in leaves.items():
            assert got["params"][layer][leaf].dtype == torch.float32
            np.testing.assert_array_equal(got["params"][layer][leaf].numpy(),
                                          np.asarray(arr))
            np.testing.assert_array_equal(
                got["opt_state"][".mu"][layer][leaf].numpy(), 0.0)
    assert got["opt_state"][".count"].dtype == torch.int32
    assert int(got["opt_state"][".count"]) == 7
    assert ckpt.load_metadata(path) == {"note": "reference"}
    with pytest.raises(KeyError, match="missing leaf 'extra/w'"):
        ckpt.load_pytree(path, {**like, "extra": {"w": 0}})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_leaf_round_trip(tmp_path, writer):
    vals = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    t = torch.as_tensor(vals).to(torch.bfloat16)
    j = jnp.asarray(vals).astype(jnp.bfloat16)
    # the same bf16 numbers in both frameworks (round to nearest even)
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(j).view(np.uint16))
    path = str(tmp_path / "bf16")
    if writer == "port":
        ckpt.save_pytree(path, {"a": {"x": t, "y": torch.arange(4)}})
        got = jckpt.load_pytree(path, {"a": {"x": j, "y": jnp.arange(4)}})
        assert got["a"]["x"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(got["a"]["x"]).view(
            np.uint16), np.asarray(j).view(np.uint16))
        np.testing.assert_array_equal(np.asarray(got["a"]["y"]), np.arange(4))
    else:
        jckpt.save_pytree(path, {"a": {"x": j, "y": jnp.arange(4)}})
        got = ckpt.load_pytree(path, {"a": {"x": t, "y": 0}})
        assert got["a"]["x"].dtype == torch.bfloat16
        assert torch.equal(got["a"]["x"], t)
        np.testing.assert_array_equal(got["a"]["y"].numpy(), np.arange(4))


def test_save_is_atomic_and_overwrites(tmp_path):
    path = str(tmp_path / "sub" / "ck.npz")
    ckpt.save_pytree(path, {"w": torch.zeros(3)}, metadata={"n": 1})
    ckpt.save_pytree(path, {"w": torch.ones(3)}, metadata={"n": 2})
    assert sorted(os.listdir(tmp_path / "sub")) == ["ck.npz",
                                                    "ck.npz.meta.json"]
    assert torch.equal(ckpt.load_pytree(path, {"w": 0})["w"], torch.ones(3))
    assert ckpt.load_metadata(path) == {"n": 2}


def test_jax_trainer_checkpoint_resumes_only_with_a_channel_source(tmp_path):
    params0 = _reference_tree()["params"]
    model = types.SimpleNamespace(features=jcnn.features, apply=jcnn.apply,
                                  loss_fn=jcnn.loss_fn,
                                  accuracy=jcnn.accuracy)
    jtr = JFEELTrainer(j_default_system(K=K, N=N, Q=Q, D_hat=D_HAT),
                       _data(JSyntheticImages, j_non_iid_split), model,
                       params0, JFEELConfig(d_hat=D_HAT, gp_steps=GP_STEPS))
    jtr._strikes[1] = 1
    jtr._quarantined_until[2] = 5
    jtr._cum = -0.25
    path = jtr.save_checkpoint(str(tmp_path / CKPT_NAME), next_round=3)
    assert "jax_key" in jckpt.load_metadata(path)

    with pytest.raises(ValueError, match="no torch generator state"):
        _port_trainer().resume(path)
    rng = np.random.default_rng(11)
    tr = _port_trainer(channel_source=lambda i: (
        rng.exponential(1e-5, (K, N)), np.ones(K)),
        resilience=ResilienceConfig())
    assert tr.resume(str(tmp_path)) == 3
    want = cnn.params_from_numpy(jax.tree.map(np.asarray, params0))
    assert all(torch.equal(p, want[n]) for n, p in tr.params.items())
    assert tr.opt_state.count == 0
    assert tr._cum == -0.25
    assert list(tr._strikes) == [0, 1, 0, 0]
    assert list(tr._quarantined_until) == [0, 0, 5, 0]
    assert tr.rng.bit_generator.state == jtr.rng.bit_generator.state
    ms = tr.run(4)
    assert [m.round for m in ms] == [3]
    assert ms[0].n_quarantined == 1  # device 2 sits out until round 5
