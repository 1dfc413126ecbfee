"""Parity of the port's data, CNN, client, server and Adam with ``repro``.

Weights cross over with ``repro_torch.models.cnn.params_from_numpy``;
since that map is a fixed permutation of each array, it carries the
reference's gradients and optimizer outputs into the port's layout for
comparison too.  Tolerances: CNN features and sigma at rtol 1e-5 (the
features also at atol 1e-6: post-ReLU entries near zero carry the
absolute float32 error of the sums that made them); gradients (a backward pass through two convolutions, summed in another
order) at rtol 1e-4 with an atol of 1e-4 of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as joptim  # noqa: E402
from repro.core import default_system as j_default_system  # noqa: E402
from repro.data import SyntheticImages as JSyntheticImages  # noqa: E402
from repro.data import mislabel as j_mislabel  # noqa: E402
from repro.data import non_iid_split as j_non_iid_split  # noqa: E402
from repro.fed import client as jclient  # noqa: E402
from repro.fed import server as jserver  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core.types import SYSTEM_ARRAYS, SystemParams  # noqa: E402
from repro_torch.data import SyntheticImages, mislabel, non_iid_split  # noqa: E402
from repro_torch.fed import client, server  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

torch.set_num_threads(2)

SIDE = 12


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _model_pair(seed=0, side=SIDE):
    """The reference params and a port CNN holding the same weights."""
    params = jcnn.init(jax.random.PRNGKey(seed), jcnn.CNNConfig(side=side))
    model = cnn.CNN(cnn.CNNConfig(side=side))
    model.load_state_dict(cnn.params_from_numpy(_np_tree(params)))
    return params, model


def _batch(seed, n, side=SIDE):
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, side, side)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return imgs, labels


def _assert_tree_close(got: dict, want_tree, rtol=1e-4):
    want = cnn.params_from_numpy(_np_tree(want_tree))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach()
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=rtol, atol=1e-4 * scale,
                                   msg=name)


def test_data_is_bit_identical():
    for side, seed in ((10, 0), (12, 3)):
        a = SyntheticImages.make(300, side=side, seed=seed)
        b = JSyntheticImages.make(300, side=side, seed=seed)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.true_labels, b.true_labels)
    labels = np.arange(50, dtype=np.int32) % 10
    for got, want in zip(mislabel(labels, 0.2, 10, seed=4),
                         j_mislabel(labels, 0.2, 10, seed=4)):
        np.testing.assert_array_equal(got, want)
    train = SyntheticImages.make(400, side=10, seed=0)
    test = SyntheticImages.make(50, side=10, seed=1)
    fd = non_iid_split(train, test, K=4, per_device=30, mislabel_prop=0.1)
    jfd = j_non_iid_split(JSyntheticImages.make(400, side=10, seed=0),
                          JSyntheticImages.make(50, side=10, seed=1), K=4,
                          per_device=30, mislabel_prop=0.1)
    for k in range(4):
        np.testing.assert_array_equal(fd.device_images[k], jfd.device_images[k])
        np.testing.assert_array_equal(fd.device_labels[k], jfd.device_labels[k])
        np.testing.assert_array_equal(fd.device_true[k], jfd.device_true[k])
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for a, b in zip(fd.sample_subsets(rng_a, 12), jfd.sample_subsets(rng_b, 12)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("side", [10, 12])
def test_cnn_features_match_reference(side):
    params, model = _model_pair(seed=side, side=side)
    imgs, _ = _batch(side, 16, side)
    h, logits = model.features(torch.from_numpy(imgs))
    jh, jlogits = jax.jit(jcnn.features)(params, imgs)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)


def test_cnn_init_is_seeded_he_normal():
    a = cnn.CNN(cnn.CNNConfig(side=SIDE), torch.Generator().manual_seed(3))
    b = cnn.CNN(cnn.CNNConfig(side=SIDE), torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        pa = pa.detach()
        torch.testing.assert_close(pa, pb.detach())
        if name.endswith("weight"):
            fan_in = pa[0].numel()
            std = float(pa.std())
            assert 0.7 < std / np.sqrt(2.0 / fan_in) < 1.3, name
            assert float(pa.abs().max()) <= 2 * np.sqrt(2.0 / fan_in) / 0.8796
        else:
            assert float(pa.abs().max()) == 0.0


def test_sigma_scores_match_reference():
    params, model = _model_pair(seed=1)
    K, D = 4, 8
    imgs, labels = _batch(2, K * D)
    imgs_k, labels_k = imgs.reshape(K, D, SIDE, SIDE), labels.reshape(K, D)
    want = np.asarray(jax.vmap(lambda im, lb: jclient.per_sample_sigma(
        params, im, lb, features_fn=jcnn.features))(imgs_k, labels_k))
    got_plain = client.per_sample_sigma(model, torch.from_numpy(imgs),
                                        torch.from_numpy(labels))
    np.testing.assert_allclose(got_plain.numpy().reshape(K, D), want,
                               rtol=1e-5)
    got = client.batched_sigma(model, torch.from_numpy(imgs_k),
                               torch.from_numpy(labels_k))
    want_b = np.asarray(jclient.batched_sigma(params, imgs_k, labels_k,
                                              features_fn=jcnn.features))
    np.testing.assert_allclose(got.numpy(), want_b, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_local_gradients_and_aggregation_match_reference():
    params, model = _model_pair(seed=2)
    K, D = 4, 8
    imgs, labels = _batch(5, K * D)
    imgs, labels = imgs.reshape(K, D, SIDE, SIDE), labels.reshape(K, D)
    rng = np.random.default_rng(6)
    delta = (rng.random((K, D)) < 0.6).astype(np.float32)
    delta[0] = 0.0
    delta[0, 3] = 1.0  # a device with a single selected sample
    grads = client.local_gradients(model, torch.from_numpy(imgs),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(delta))
    jgrads = jax.jit(jax.vmap(lambda im, lb, dl: jclient.local_gradient(
        params, im, lb, dl, jcnn.loss_fn)))(imgs, labels, delta)
    for k in range(K):
        _assert_tree_close({n: g[k] for n, g in grads.items()},
                           jax.tree.map(lambda x: x[k], jgrads))
    jsys = j_default_system(K=K, N=2, Q=2, D_hat=D)
    sys_ = SystemParams.from_arrays(
        K, 2, 2, {f: np.asarray(getattr(jsys, f)) for f in SYSTEM_ARRAYS},
        device="cpu")
    alpha = np.array([1, 0, 1, 1], np.float32)
    np.testing.assert_allclose(
        server.ipw_weights(sys_, torch.from_numpy(alpha)).numpy(),
        np.asarray(jserver.ipw_weights(jsys, alpha)), rtol=1e-6)
    assert server.ipw_mass(sys_, torch.from_numpy(alpha)) == pytest.approx(
        jserver.ipw_mass(jsys, alpha), rel=1e-6)
    g_hat = server.aggregate_gradients(sys_, grads, torch.from_numpy(alpha))
    _assert_tree_close(g_hat, jserver.aggregate_gradients(jsys, jgrads, alpha))


def test_one_adam_step_matches_reference():
    params, model = _model_pair(seed=3)
    rng = np.random.default_rng(8)
    jgrads = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)
                              * 1e-2), params)
    grads = cnn.params_from_numpy(_np_tree(jgrads))
    jopt = joptim.adam(1e-3)
    jstate = jopt.init(params)
    opt = optim.adam(1e-3)
    ptensors = dict(model.named_parameters())
    state = opt.init(ptensors)
    for _ in range(2):  # two steps: bias corrections at count 1 and 2
        jupd, jstate = jopt.update(jgrads, jstate, params)
        params = joptim.apply_updates(params, jupd)
        upd, state = opt.update(grads, state)
        optim.apply_updates(ptensors, upd)
        _assert_tree_close(upd, jupd, rtol=1e-5)
    _assert_tree_close(state.mu, jstate.mu, rtol=1e-6)
    _assert_tree_close(state.nu, jstate.nu, rtol=1e-6)
    _assert_tree_close(ptensors, params, rtol=1e-6)
    assert state.count == int(jstate.count) == 2
