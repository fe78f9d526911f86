"""The port's ``FullMCMCCausalBGM`` against the JAX package's: the flat
weight order (a JAX flat sample means the same net), the HMC targets over
g's, h's and f's weights, the weight-conditioned log posterior, one weight
index per MH step for both sides of the accept ratio, the paired effect
draws, predict within Monte-Carlo error on the same weight samples, the
lifecycle of ``tests/test_variants.py`` and exact resume."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from bayesgm_tpu.models import fullmcmc as jfm  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_torch import FullMCMCCausalBGM, bridge  # noqa: E402
from bayesgm_torch.models import fullmcmc as tfm  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(2)

# f32 forward values and gradients summed in another order than XLA's
# (dots 5 to 16 wide, sums over up to 96 x 5 entries)
VAL_TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n=96, v_dim=5, binary=False, seed=0):
    """tests/test_variants.py's causal data (binary: x thresholded)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, v_dim).astype("float32")
    x = rng.rand(n, 1).astype("float32")
    y = (x + v[:, :1] + 0.1 * rng.randn(n, 1)).astype("float32")
    if binary:
        x = (x > 0.5).astype("float32")
    return x, y, v


def _params(tmpdir, **kw):
    p = dict(v_dim=5, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="unit",
             output_dir=str(tmpdir), use_bnn=False, g_units=[8, 8], e_units=[8, 8],
             f_units=[8], h_units=[8], dz_units=[8], save_res=False, save_model=False)
    p.update(kw)
    return p


def _models(tmp_path, **kw):
    """A JAX and a port FullMCMCCausalBGM holding the same nets."""
    jm = jfm.FullMCMCCausalBGM(_params(tmp_path / "j", **kw), random_seed=0)
    path = str(tmp_path / "w.npz")
    jm.save_weights(path)
    tm = FullMCMCCausalBGM(_params(tmp_path / "t", **kw), random_seed=1, device="cpu")
    return jm, tm.load_weights(path)


def _weight_samples(model, n=6, scale=0.05, seed=3):
    """n flat weight vectors per net near the model's own (numpy, (n, D))."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in "ghf":
        flat = tnn.flatten_params(model.nets[k])[0].numpy()
        out[k] = (flat + scale * rng.normal(size=(n, flat.size))).astype(np.float32)
    return out


# -- flat weights ------------------------------------------------------------


def test_flat_weights_follow_ravel_pytree():
    """ravel_pytree's order (b0, w0, b1, w1, ...): the port flattens a
    bridged net to JAX's vector bit for bit, and unravels any JAX flat
    vector into the weights JAX's unravel gives; the prior term agrees."""
    tree = jax.tree.map(np.asarray, jnn.init_mlp(jax.random.PRNGKey(1), 5, 3, [8, 4]))
    tree["layers"][1]["b"] = np.arange(4, dtype=np.float32)  # nonzero biases
    j_flat, j_unravel = ravel_pytree(tree)
    net = bridge.mlp_from_numpy(tree)
    t_flat, t_unravel = tnn.flatten_params(net)
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))

    other = np.random.default_rng(0).normal(size=j_flat.shape).astype(np.float32)
    want, got = j_unravel(jnp.asarray(other)), t_unravel(torch.as_tensor(other))
    for i, layer in enumerate(want["layers"]):
        np.testing.assert_array_equal(got.w[i].numpy(), np.asarray(layer["w"]))
        np.testing.assert_array_equal(got.b[i].numpy(), np.asarray(layer["b"]))
    x = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    np.testing.assert_allclose(tnn.mlp_apply(got, torch.as_tensor(x)).numpy(),
                               np.asarray(jnn.mlp_apply(want, jnp.asarray(x))), **VAL_TOL)
    np.testing.assert_allclose(float(tnn.standard_normal_log_prior(torch.as_tensor(other))),
                               float(jnn.standard_normal_log_prior(jnp.asarray(other))),
                               rtol=1e-6)


def test_unravel_is_differentiable_and_stacks():
    """unravel gives views of the flat vector (gradients reach it), and a
    (K, D) stack gives K nets for one batched pass."""
    net = tnn.MLP(3, 2, [4], torch.Generator().manual_seed(0))
    flat, unravel = tnn.flatten_params(net)
    x = torch.randn((5, 3), generator=torch.Generator().manual_seed(1))
    f = flat.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(tnn.mlp_apply(unravel(f), x).sum(), f)
    assert grad.shape == flat.shape and bool(torch.any(grad != 0))
    stack = torch.stack([flat, 2.0 * flat])
    out = tnn.mlp_apply(unravel(stack), x.expand(2, 5, 3))
    for k in range(2):
        np.testing.assert_allclose(out[k].numpy(), tnn.mlp_apply(unravel(stack[k]), x).numpy(),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="flat weight vector"):
        unravel(flat[:-1])


def test_flat_weight_samples_carry_across_unchanged(tmp_path):
    """A stack of JAX flat samples is the port's stack: the same values,
    and each row unravels to the net JAX's unravel gives."""
    jm, tm = _models(tmp_path)
    samples = _weight_samples(tm)
    for k in "ghf":
        got = bridge.flat_weight_samples(samples[k], tm.nets[k])
        np.testing.assert_array_equal(got, samples[k])
        want = jm._unravel[k](jnp.asarray(samples[k][2]))
        mine = tm._unravel[k](torch.as_tensor(got[2]))
        for i, layer in enumerate(want["layers"]):
            np.testing.assert_array_equal(mine.w[i].numpy(), np.asarray(layer["w"]))
            np.testing.assert_array_equal(mine.b[i].numpy(), np.asarray(layer["b"]))
    with pytest.raises(ValueError, match="flat weight samples"):
        bridge.flat_weight_samples(samples["g"][:, 1:], tm.nets["g"])


# -- HMC targets and the weight-conditioned posterior -------------------------------


@pytest.mark.parametrize("binary", [False, True], ids=["continuous", "binary"])
def test_hmc_targets_match_jax(monkeypatch, tmp_path, binary):
    """run_mcmc_training hands hmc the same three targets (N(0, 1) prior
    plus the full-data likelihood over the fitted latent table), from the
    same start: values and weight gradients agree at the fitted weights and
    away from them, and the samples are stored as (num_samples, D)."""
    jm, tm = _models(tmp_path, binary_treatment=binary)
    data = _data(binary=binary)
    table = np.random.default_rng(2).normal(size=(96, 5)).astype(np.float32)
    jm.data_z, tm.data_z = jnp.asarray(table), torch.as_tensor(table)
    seen = {"jax": [], "port": []}

    def j_hmc(log_prob, init, key, **kw):
        seen["jax"].append((log_prob, np.asarray(init), kw))
        return jfm.mcmc.HMCResult(jnp.repeat(init[None], 4, axis=0), 0.0, 1.0)

    def t_hmc(log_prob, init, generator, **kw):
        seen["port"].append((log_prob, init, kw))
        return tmcmc.HMCResult(init[None].repeat(4, 1, 1), torch.tensor(0.0), torch.tensor(1.0))

    monkeypatch.setattr(jfm.mcmc, "hmc", j_hmc)
    monkeypatch.setattr(tfm.mcmc, "hmc", t_hmc)
    jm.run_mcmc_training(data, num_samples=4, num_burnin=3)
    tm.run_mcmc_training(data, num_samples=4, num_burnin=3)

    rng = np.random.default_rng(4)
    for (j_lp, j_init, j_kw), (t_lp, t_init, t_kw), k in zip(seen["jax"], seen["port"], "ghf"):
        np.testing.assert_array_equal(t_init.numpy(), j_init)
        assert t_kw == j_kw
        for point in (j_init, j_init + 0.1 * rng.normal(size=j_init.shape).astype(np.float32)):
            j_val, j_grad = jax.value_and_grad(lambda f: jnp.sum(j_lp(f, None)))(jnp.asarray(point))
            t_val, t_grad = tmcmc._value_and_grad(t_lp, torch.as_tensor(np.array(point)), None)
            np.testing.assert_allclose(t_val.numpy(), [float(j_val)], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-4, atol=1e-3,
                                       err_msg=k)
        assert getattr(tm, f"{k}_net_samples").shape == (4, j_init.shape[1])


@pytest.mark.parametrize("binary", [False, True], ids=["continuous", "binary"])
def test_get_log_posterior_matches_jax(tmp_path, binary):
    jm, tm = _models(tmp_path, binary_treatment=binary)
    x, y, v = _data(n=12, binary=binary)
    z = np.random.default_rng(5).normal(size=(12, 5)).astype(np.float32)
    samples = _weight_samples(tm)
    for i in (0, 5):
        w = [samples[k][i] for k in "ghf"]
        want = np.asarray(jm.get_log_posterior(x, y, v, z, *w))
        got = tm.get_log_posterior(x, y, v, z, *w).numpy()
        np.testing.assert_allclose(got, want, **VAL_TOL)


def test_one_weight_index_per_mh_step(tmp_path):
    """Both sides of each MH step are judged under ONE weight triple (the
    reference's one rand_idx per step, JAX's shared_eval_key=True): the
    chain evaluates the initial state once, then one stacked [proposed;
    current] pass per step, each under a single sample index drawn that
    step; the indices vary over the steps."""
    _, tm = _models(tmp_path)
    samples = _weight_samples(tm, n=8)
    x, y, v = _data(n=10)
    calls, orig = [], tm._neg_log_posterior_with_weights

    def recording(z, xx, yy, vv, gw, hw, fw):
        rows = [int(np.argmin(np.abs(samples[k] - w.numpy()).sum(axis=1)))
                for k, w in zip("ghf", (gw, hw, fw))]
        calls.append((z.shape[0], rows))
        return orig(z, xx, yy, vv, gw, hw, fw)

    tm._neg_log_posterior_with_weights = recording
    draws = tm.metropolis_hastings_sampler((x, y, v), *(samples[k] for k in "ghf"),
                                           burn_in=15, n_keep=10)
    assert draws.shape == (10, 10, 5)
    assert [c[0] for c in calls] == [10] + [20] * 25
    assert all(len(set(rows)) == 1 for _, rows in calls)  # g, h and f: the same index
    assert len({rows[0] for _, rows in calls}) > 1


# -- effects -----------------------------------------------------------------------


@pytest.mark.parametrize("binary", [False, True], ids=["continuous", "binary"])
def test_infer_from_latent_posterior_matches_jax(tmp_path, binary):
    """The same (Z draw, f-weight draw) pairs with sample_y=False give
    JAX's effect draws: binary (n_keep, n) ITEs, continuous (n_keep, X);
    70 draws cross the 64-draw chunk."""
    jm, tm = _models(tmp_path, binary_treatment=binary)
    rng = np.random.default_rng(6)
    z = rng.normal(size=(70, 9, 5)).astype(np.float32)
    f_w = _weight_samples(tm, n=70)["f"]
    xv = None if binary else [0.25, 1.0, 2.0]
    want = np.asarray(jm.infer_from_latent_posterior(z, f_net_weights=f_w, x_values=xv,
                                                     sample_y=False))
    got = tm.infer_from_latent_posterior(z, f_net_weights=f_w, x_values=xv, sample_y=False)
    assert got.shape == want.shape == ((70, 9) if binary else (70, 3))
    np.testing.assert_allclose(got, want, **VAL_TOL)
    tm.f_net_samples = f_w
    noisy = tm.infer_from_latent_posterior(z, x_values=xv)
    assert noisy.shape == got.shape and np.all(np.isfinite(noisy))


def test_predict_matches_jax_within_monte_carlo_error(tmp_path):
    """The same nets and weight samples, the same 16 subjects: the latent
    chain (one weight draw per step) then the paired effect draws, on both
    sides; each ADRF point within 4 * sqrt(se_port^2 + se_jax^2), se =
    sd(draws) / sqrt(ESS)."""
    jm, tm = _models(tmp_path)
    samples = _weight_samples(tm, n=20, scale=0.02)
    data = tuple(a[:16] for a in _data())
    xv = [0.25, 1.0, 2.0]
    draws = {}
    for name, m in (("jax", jm), ("port", tm)):
        zs = m.metropolis_hastings_sampler(data, *(samples[k] for k in "ghf"), burn_in=100,
                                           n_keep=400, q_sd=0.5)
        draws[name] = np.asarray(m.infer_from_latent_posterior(zs, x_values=xv))
    se = {k: d.std(axis=0) / np.sqrt(tmcmc.effective_sample_size(d)) for k, d in draws.items()}
    bound = 4.0 * np.sqrt(se["jax"] ** 2 + se["port"] ** 2)
    gap = np.abs(draws["port"].mean(axis=0) - draws["jax"].mean(axis=0))
    assert np.all(gap <= bound), (gap, bound)


# -- the model's surface -------------------------------------------------------------


def test_fullmcmc_lifecycle(tmp_path):
    """tests/test_variants.py::test_fullmcmc_lifecycle and
    ::test_fullmcmc_weight_sampling_changes_output on the port."""
    x, y, v = _data()
    m = FullMCMCCausalBGM(_params(tmp_path, use_bnn=True), random_seed=3, device="cpu")
    assert not m.cfg.use_bnn and isinstance(m.nets["g"], tnn.MLP)
    m.fit((x, y, v), epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0)
    m.run_mcmc_training((x, y, v), num_samples=20, num_burnin=20)
    assert m.g_net_samples.shape[0] == 20 and m.f_net_samples.ndim == 2
    assert m.f_net_samples.shape[1] == sum(p.numel() for p in m.nets["f"].parameters())

    z = np.random.RandomState(1).randn(8, 5).astype("float32")
    lp = m.get_log_posterior(x[:8], y[:8], v[:8], z, m.g_net_samples[0], m.h_net_samples[0],
                             m.f_net_samples[0]).numpy()
    assert lp.shape == (8,) and np.all(np.isfinite(lp))
    lp_b = m.get_log_posterior(x[:8], y[:8], v[:8], z, m.g_net_samples[-1],
                               m.h_net_samples[-1], m.f_net_samples[-1]).numpy()
    assert not np.allclose(lp, lp_b)

    adrf, ci = m.predict((x[:16], y[:16], v[:16]), alpha=0.1, n_mcmc=10, burn_in=20,
                         x_values=[0.5, 1.0])
    assert adrf.shape == (2,) and ci.shape == (2, 2) and np.all(ci[:, 0] <= ci[:, 1])
    adrf, ci, diag = m.predict((x[:16], y[:16], v[:16]), alpha=0.1, n_mcmc=10, burn_in=20,
                               x_values=[0.5, 1.0], return_diagnostics=True)
    assert diag["ess"].shape == (2,) and diag["rhat"].shape == (2,)
    zs = m.metropolis_hastings_sampler((x[:8], y[:8], v[:8]), burn_in=10, n_keep=5)
    assert m.infer_from_latent_posterior(zs, x_values=[1.0]).shape == (5, 1)


def test_fullmcmc_refusals(tmp_path):
    m = FullMCMCCausalBGM(_params(tmp_path), random_seed=0, device="cpu")
    data = _data(n=16)
    with pytest.raises(RuntimeError, match="fit"):
        m.run_mcmc_training(data)
    with pytest.raises(RuntimeError, match="run_mcmc_training"):
        m.predict(data, x_values=[1.0])
    for call in (lambda: m.run_mcmc_training(data, mesh=object()),
                 lambda: m.metropolis_hastings_sampler(data, mesh=object()),
                 lambda: m.predict(data, x_values=[1.0], mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()


def test_fullmcmc_resume_is_exact(tmp_path):
    """tests/test_resume.py::test_fullmcmc_resume_exact: 4 epochs against
    2 and a new instance resuming to 4 give the same nets, latent table and
    generator states bit for bit."""
    data = _data(n=64, v_dim=4)
    kw = dict(batch_size=16, epochs_per_eval=1, use_egm_init=False, verbose=0)

    def model(sub):
        return FullMCMCCausalBGM(_params(tmp_path / sub, v_dim=4, save_model=True, g_units=[8],
                                         e_units=[8], dataset="resume"),
                                 timestamp="ts", random_seed=7, device="cpu")

    ma = model("a")
    ma.fit(data, epochs=4, **kw)
    model("b").fit(data, epochs=2, **kw)
    mb = model("b")
    mb.fit(data, epochs=4, **kw)
    for k in ma.nets:
        for p, q in zip(ma.nets[k].parameters(), mb.nets[k].parameters()):
            assert torch.equal(p, q), k
    assert torch.equal(ma.data_z, mb.data_z)
    assert torch.equal(ma._gen.get_state(), mb._gen.get_state())
    assert ma.best_epoch == mb.best_epoch
    assert sorted(os.listdir(mb.checkpoint_path))[-1] == "ckpt-4.npz"
