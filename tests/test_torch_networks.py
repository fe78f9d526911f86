"""The port's network facade (``bayesgm_torch/models/networks.py``) against
the JAX package's (``bayesgm_tpu/models/networks.py``), one case per class
as ``tests/test_networks_facade.py`` has them: each deterministic output
equals JAX's on bridged weights (the flipout nets' under the shared flipout
stream), the running statistics move only on a training forward,
``run_mcmc_for_net`` gives ``(num_samples, n_weights)`` finite samples
with an acceptance in (0, 1], and the facade refuses CUDA it does not
have."""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.models import networks as JN  # noqa: E402
from bayesgm_tpu.ops import conv as jconv  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import networks as TN  # noqa: E402

from _torch_parity import FlipoutDraws  # noqa: E402

torch.set_num_threads(2)

# f32 forwards of small nets, summed in another order than XLA's
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy()


def _bridge_into(facade, jax_params):
    """Replace the port facade's net with JAX's weights."""
    facade._set_net(bridge.net_from_numpy(jax.tree.map(np.asarray, jax_params)))
    return facade


def _x(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("batchnorm", [False, True], ids=["plain", "bn"])
def test_base_fully_connected_net(batchnorm):
    j = JN.BaseFullyConnectedNet(input_dim=5, output_dim=3, nb_units=[8, 8], batchnorm=batchnorm)
    t = TN.BaseFullyConnectedNet(input_dim=5, output_dim=3, nb_units=[8, 8], batchnorm=batchnorm,
                                 device="cpu")
    params = jax.tree.map(np.asarray, j.params)
    _bridge_into(t, {"layers": params["layers"]})
    if batchnorm:
        rng = np.random.default_rng(1)
        j.params["bn"] = [{"gamma": jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32),
                           "beta": jnp.asarray(rng.normal(size=8), jnp.float32)}
                          for _ in range(2)]
        with torch.no_grad():
            for i, bn in enumerate(j.params["bn"]):
                t.bn_gamma[i].copy_(torch.tensor(np.array(bn["gamma"])))
                t.bn_beta[i].copy_(torch.tensor(np.array(bn["beta"])))
    x = _x(4, 5)
    out = t(x)
    assert tuple(out.shape) == (4, 3)
    np.testing.assert_allclose(_np(out), np.asarray(j(x)), **TOL)


@pytest.mark.parametrize("batchnorm", [True, False], ids=["bn", "plain"])
def test_discriminator(batchnorm):
    j = JN.Discriminator(input_dim=4, nb_units=[8], batchnorm=batchnorm)
    t = _bridge_into(TN.Discriminator(input_dim=4, nb_units=[8], batchnorm=batchnorm,
                                      device="cpu"), j.params)
    x = _x(6, 4)
    assert tuple(t(x).shape) == (6, 1)
    np.testing.assert_allclose(_np(t(x)), np.asarray(j(x)), **TOL)


def test_variational_net_running_statistics_and_reparameterize():
    """Mean and variance equal JAX's in both modes; the running statistics
    move as JAX's on a training forward and not at all on an eval one."""
    j = JN.BaseVariationalNet(input_dim=4, output_dim=2, nb_units=[8])
    t = _bridge_into(TN.BaseVariationalNet(input_dim=4, output_dim=2, nb_units=[8],
                                           device="cpu"), j.params)
    x = (_x(5, 4) * 3.0 + 1.0).astype(np.float32)
    for training in (True, False):
        mean, var = t(x, training=training)
        j_mean, j_var = j(x, training=training)
        np.testing.assert_allclose(_np(mean), np.asarray(j_mean), **TOL)
        np.testing.assert_allclose(_np(var), np.asarray(j_var), **TOL)
        np.testing.assert_allclose(_np(t.net.bn_mean), np.asarray(j.state["norm"]["mean"]),
                                   **TOL)
        np.testing.assert_allclose(_np(t.net.bn_var), np.asarray(j.state["norm"]["var"]), **TOL)
    before = (t.net.bn_mean.clone(), t.net.bn_var.clone())
    t(x, training=False)
    assert torch.equal(t.net.bn_mean, before[0]) and torch.equal(t.net.bn_var, before[1])
    assert not torch.equal(before[0], torch.zeros(4))  # the training forward moved them
    s = t.reparameterize(mean, var)
    assert tuple(s.shape) == (5, 2) and bool(torch.isfinite(s).all())


def test_lowrank_net_heads_and_transfer(monkeypatch):
    """Both low-rank nets' heads equal JAX's (the flipout one under the
    shared stream), the KL too; the transfer takes the posterior means, as
    JAX's does, and refuses an unknown method."""
    FlipoutDraws(monkeypatch)
    jb = JN.BayesianVariationalLowRankNet(input_dim=3, output_dim=4, nb_units=[8], rank=2)
    tb = _bridge_into(TN.BayesianVariationalLowRankNet(input_dim=3, output_dim=4, nb_units=[8],
                                                       rank=2, device="cpu"), jb.params)
    x = _x(5, 3)
    for got, want in zip(tb(x), jb(x)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert tuple(tb(x)[2].shape) == (5, 4, 2)
    np.testing.assert_allclose(float(tb.kl_divergence().detach()), float(jb.kl_divergence()),
                               rtol=1e-5)

    jd = JN.BaseVariationalLowRankNet(input_dim=3, output_dim=4, nb_units=[8], rank=2)
    td = TN.BaseVariationalLowRankNet(input_dim=3, output_dim=4, nb_units=[8], rank=2,
                                      device="cpu")
    jd.transfer_weights_from_bayesian(jb, method="mean")
    td.transfer_weights_from_bayesian(tb, method="mean")
    np.testing.assert_array_equal(_np(td.net.w[0]), np.asarray(jb.params["layers"][0]["loc"]))
    mean, var, u = td(x)
    for got, want in zip((mean, var, u), jd(x)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    inv = td.compute_covariance_inverse(var, u)
    dense = torch.diag_embed(var) + u @ u.transpose(-1, -2)
    np.testing.assert_allclose(_np(inv @ dense), np.broadcast_to(np.eye(4), (5, 4, 4)),
                               atol=1e-4)
    np.testing.assert_allclose(_np(td.compute_log_det(var, u)),
                               _np(torch.linalg.slogdet(dense)[1]), rtol=1e-5, atol=1e-5)
    assert tuple(td.reparameterize(mean, var, u).shape) == (5, 4)
    td.transfer_weights_from_bayesian(tb, method="sample")
    assert not torch.equal(td.net.w[0], tb.net.loc[0])
    with pytest.raises(ValueError):
        td.transfer_weights_from_bayesian(tb, method="bogus")


def test_bayesian_nets(monkeypatch):
    """Under the shared stream the flipout MLP and the flipout variational
    net equal JAX's; with their own generator two forwards differ."""
    free = TN.BayesianFullyConnectedNet(input_dim=4, output_dim=2, nb_units=[8], device="cpu")
    x = _x(5, 4)
    assert not torch.allclose(free(x), free(x))

    FlipoutDraws(monkeypatch)
    j = JN.BayesianFullyConnectedNet(input_dim=4, output_dim=2, nb_units=[8])
    t = _bridge_into(TN.BayesianFullyConnectedNet(input_dim=4, output_dim=2, nb_units=[8],
                                                  device="cpu"), j.params)
    np.testing.assert_allclose(_np(t(x)), np.asarray(j(x)), **TOL)
    np.testing.assert_allclose(float(t.kl_divergence().detach()), float(j.kl_divergence()),
                               rtol=1e-5)

    jv = JN.BayesianVariationalNet(input_dim=4, output_dim=2, nb_units=[8])
    tv = _bridge_into(TN.BayesianVariationalNet(input_dim=4, output_dim=2, nb_units=[8],
                                                device="cpu"), jv.params)
    for got, want in zip(tv(x), jv(x)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(tv.net.bn_mean), np.asarray(jv.state["norm"]["mean"]), **TOL)
    np.testing.assert_allclose(float(tv.kl_divergence().detach()), float(jv.kl_divergence()),
                               rtol=1e-5)


def test_mcmc_net_and_run_mcmc():
    """The flat-weight forward equals the module's and JAX's on the same
    flat weights (JAX's ravel order), the log prior JAX's; weight-space HMC
    gives finite ``(num_samples, n_weights)`` samples and prints an
    acceptance in (0, 1]."""
    j = JN.MCMCFullyConnectedNet(input_dim=2, output_dim=1, nb_units=[4])
    t = TN.MCMCFullyConnectedNet(input_dim=2, output_dim=1, nb_units=[4], device="cpu")
    x = np.random.RandomState(0).randn(30, 2).astype("float32")
    y = (x[:, :1] + 0.05 * np.random.RandomState(1).randn(30, 1)).astype("float32")
    np.testing.assert_allclose(_np(t(x)), _np(t.call_with_weights(x, t.get_weights())),
                               rtol=1e-5)
    flat = np.asarray(j.get_weights())
    np.testing.assert_allclose(_np(t.call_with_weights(x, flat)),
                               np.asarray(j.call_with_weights(x, flat)), **TOL)
    np.testing.assert_allclose(float(t.log_prior(flat)), float(j.log_prior(flat)), rtol=1e-6)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        samples = TN.run_mcmc_for_net(
            t, x, y, lambda y_true, y_pred: -0.5 * torch.sum((y_true - y_pred) ** 2) / 0.01,
            num_samples=20, num_burnin_steps=20)
    assert samples.shape == (20, t.get_weights().shape[0]) == (20, flat.shape[0])
    assert np.all(np.isfinite(samples))
    rate = float(out.getvalue().split("Acceptance rate:")[1].split()[0])
    assert 0.0 < rate <= 1.0
    with pytest.raises(ValueError, match="batchnorm"):
        TN.MCMCFullyConnectedNet(input_dim=2, output_dim=1, nb_units=[4], batchnorm=True,
                                 device="cpu")


def test_mnist_conv_wrappers():
    """The encoder, the plain generator and the critic in eval mode equal
    JAX's on bridged weights, in JAX's NHWC layout; the critic's training
    forward draws dropout from the module's generator."""
    enc = TN.MNISTEncoderConv(z_dim=4, filters=4, device="cpu")
    gen = TN.MNISTGenerator(z_dim=4, filters=4, device="cpu")
    disc = TN.MNISTDiscriminator(filters=8, device="cpu")
    x = np.random.default_rng(0).random((2, 28, 28, 1)).astype("float32")
    z = enc(x)
    assert tuple(z.shape) == (2, 4)
    np.testing.assert_allclose(
        _np(z), np.asarray(jconv.mnist_encoder_apply(bridge.net_to_numpy(enc.net), x)), **TOL)
    mean, var = gen(_np(z))
    j_mean, j_var = jconv.mnist_generator_apply(bridge.net_to_numpy(gen.net), _np(z), None)
    assert tuple(mean.shape) == (2, 28, 28, 1) and bool((var > 0).all())
    np.testing.assert_allclose(_np(mean), np.asarray(j_mean), **TOL)
    np.testing.assert_allclose(_np(var), np.asarray(j_var), **TOL)
    logits = disc(x, training=False)
    assert tuple(logits.shape) == (2, 1)
    np.testing.assert_allclose(
        _np(logits),
        np.asarray(jconv.mnist_discriminator_apply(bridge.net_to_numpy(disc.net), x, None)),
        **TOL)
    assert not torch.equal(disc(x), logits)
    flip = TN.MNISTGenerator(z_dim=4, filters=4, use_bnn=True, device="cpu")
    assert tuple(flip(_np(z))[0].shape) == (2, 28, 28, 1)
    assert float(flip.kl_divergence().detach()) > 0


def test_facade_refuses_missing_cuda(monkeypatch):
    """``device="cuda"`` is the default and raises without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TN.BaseFullyConnectedNet(input_dim=2, output_dim=1, nb_units=[4])
