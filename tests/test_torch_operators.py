"""The port's analytics operators against the JAX package's, on the CPU.

``jax.random`` streams have no torch counterpart, so the JAX package's
initial k-means centers and CNN weights are handed across as numpy
(``repro_torch.convert``); the two packages are never compared on two
seeded draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pipeline import operators as jax_ops
from repro_torch.convert import centers_from_jax, cnn_from_jax
from repro_torch.pipeline import operators as ops

torch.set_num_threads(2)


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c, .6, (200, 2)) for c in (0, 3, 6)]
                          ).astype(np.float32)


def test_lloyd_from_jax_centers_matches_jax():
    xs = _blobs()
    ref_centers, ref_assign = jax_ops.kmeans(jnp.asarray(xs), k=3, iters=20,
                                             seed=0)
    # the same initial draw the JAX package's kmeans makes
    idx = jax.random.choice(jax.random.PRNGKey(0), xs.shape[0], (3,),
                            replace=False)
    init = centers_from_jax(xs[np.asarray(idx)], device="cpu")
    centers, assign = ops.lloyd(torch.from_numpy(xs), init, 20)
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref_centers),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ref_assign))


def test_kmeans_seeded_draw_is_deterministic():
    xs = _blobs(1)
    a = ops.kmeans(xs, k=3, iters=25, seed=7, device="cpu")
    b = ops.kmeans(xs, k=3, iters=25, seed=7, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (3, 2) and a[1].shape == (600,)
    assert len(set(a[1].tolist())) == 3          # three clusters found


def test_linear_regression_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, 300).astype(np.float32)
    y = (2.0 + 3.0 * x + 0.05 * rng.standard_normal(300)).astype(np.float32)
    ref_beta, ref_resid = jax_ops.linear_regression(jnp.asarray(x),
                                                    jnp.asarray(y))
    beta, resid = ops.linear_regression(x, y, device="cpu")
    np.testing.assert_allclose(beta.numpy(), np.asarray(ref_beta), atol=1e-4)
    np.testing.assert_allclose(resid.numpy(), np.asarray(ref_resid),
                               atol=1e-4)


def _jax_cnn(n_classes=3):
    params = jax_ops.init_cnn_classifier(jax.random.PRNGKey(0),
                                         n_classes=n_classes)
    return params, {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("T", [64, 61, 33])
def test_cnn_logits_match_jax(T):
    """SAME padding is asymmetric in XLA ((1, 2) at T = 64) and the
    standardization uses the population std; odd T pads differently."""
    params, np_params = _jax_cnn()
    w = np.random.default_rng(T).normal(1.0, 0.3, (16, T)).astype(np.float32)
    ref = np.asarray(jax_ops.cnn_classify(params, jnp.asarray(w)))
    got = ops.cnn_classify(cnn_from_jax(np_params, device="cpu"), w)
    assert got.shape == (16, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def _windows():
    rng = np.random.default_rng(0)
    stable = rng.normal(1.0, 0.05, (64, 64)).astype(np.float32)
    bursty = (rng.normal(1.0, 0.05, (64, 64))
              + (rng.random((64, 64)) < 0.15) * rng.normal(4, 1, (64, 64))
              ).astype(np.float32)
    return np.concatenate([stable, bursty]), np.array([0] * 64 + [1] * 64)


def test_cnn_gradients_match_jax():
    x, y = _windows()
    params, np_params = _jax_cnn(n_classes=2)

    def loss(p):
        logits = jax_ops.cnn_classify(p, jnp.asarray(x))
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(128), y])

    ref = {k: np.asarray(v) for k, v in jax.grad(loss)(params).items()}
    model = cnn_from_jax(np_params, device="cpu")
    torch.nn.functional.cross_entropy(model(torch.from_numpy(x)),
                                      torch.from_numpy(y)).backward()
    got = {"conv1": model.conv1.weight.grad.numpy().transpose(2, 1, 0),
           "conv2": model.conv2.weight.grad.numpy().transpose(2, 1, 0),
           "head": model.head.weight.grad.numpy().T}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4)


def test_cnn_trains_to_separate_bursty_windows():
    """As tests/test_pipeline.py trains the JAX classifier: 60 SGD steps
    from the port's own seeded init."""
    x, y = map(torch.from_numpy, _windows())
    model = ops.init_cnn_classifier(n_classes=2, seed=0, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.3)
    for _ in range(60):
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
    acc = (ops.cnn_classify(model, x).argmax(-1) == y).float().mean().item()
    assert acc > 0.9, acc
