"""MNISTBGM's HMC imputation against the JAX package's: one ``_hmc_step``
on the Bernoulli target with the same momentum, uniforms and generator
draws for both generators (the target is stochastic for both: the logits'
reparameterisation noise, and the flipout generator's weight noise), the
sampler's evaluation count, ``predict`` in law on bridged nets, and the
coupling of a subject batch's chains through channel BatchNorm."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import distributions as jdist  # noqa: E402
from bayesgm_tpu.ops import mcmc as jmcmc  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_tpu.models import mnist as jmn  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import mnist as tmn  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402
from bayesgm_torch.utils import helpers as thelpers  # noqa: E402

from test_torch_conv import GEN_LAYERS, Queue, patch_jax_draws  # noqa: E402
from test_torch_mnist import Z_DIM, _bridged, _gen_draws, _images  # noqa: E402

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# HMC
# ---------------------------------------------------------------------------


N_ROWS, LEAPFROG = 6, 3


@pytest.mark.parametrize("t,use_bnn", [(0, False), (10, False), (0, True), (10, True)],
                         ids=["plain-adapting", "plain-adapted", "flipout-adapting",
                              "flipout-adapted"])
def test_hmc_step_matches_jax(tmp_path, monkeypatch, t, use_bnn):
    """One HMC step on the Bernoulli target under a shared pixel mask, the
    momentum and uniforms injected on both sides.  JAX's draws are keyed by
    its PRNG key (every call under one key takes the same generator draw,
    the i-th distinct key draw i), so every leapfrog gradient under
    ``k_grad`` shares one draw and the value under ``k_lp`` takes the next:
    the draws the port's ``noise`` gives in that order.  The target is
    stochastic for both generators, so the port evaluates it ``L + 2``
    times (L + 1 gradients, one value)."""
    jm, tm = _bridged(tmp_path, monkeypatch, use_bnn)
    rng = np.random.default_rng(7)
    data = _images(N_ROWS, 7).reshape(N_ROWS, -1)
    _, miss = thelpers.mnist_mask_indices(mode="upper_half")
    mask = np.ones((N_ROWS, 784), np.float32)
    mask[:, miss] = 0.0
    state = rng.normal(size=(N_ROWS, Z_DIM)).astype(np.float32)
    mom = rng.normal(size=(N_ROWS, Z_DIM)).astype(np.float32)
    unif = np.where(np.arange(N_ROWS) % 2 == 0, 1e-6, 0.9).astype(np.float32)
    kw = dict(num_leapfrog=LEAPFROG, target_accept=0.75, n_adapt=10, adaptation_rate=0.05)
    g_tree = bridge.net_to_numpy(tm.nets["g"])
    draws = [_gen_draws(g_tree, N_ROWS, rng, use_bnn) for _ in range(3)]
    with torch.no_grad():  # a carried value: the state's, under a draw of its own
        logp0 = tmn._masked_log_prob(tm.cfg, tm.nets["g"], torch.as_tensor(state),
                                     torch.as_tensor(data), torch.as_tensor(mask),
                                     draws.pop()[2]).numpy()

    seen, queues = {}, {}

    def normal(key, shape, dtype=None):
        return jnp.asarray(mom) if tuple(shape) == mom.shape else queues["normal"].pop(0)

    def j_lp(z, key):  # the log_prob of JAX's MNISTBGM.tfp_mcmc_sampler, under draw i
        i = seen.setdefault(np.asarray(key).tobytes(), len(seen))
        queues["normal"] = [jnp.asarray(a) for a in draws[i][0]]
        queues["sign"] = [jnp.asarray(a) for a in draws[i][1]]
        k_g, k_rep = jax.random.split(key)
        mu, var = jmn._gen_apply(jm.cfg, jm.nets["g"], z, k_g)
        logits = jnp.clip(jnn.reparameterize(k_rep, mu, var), -10.0, 10.0)
        lf = logits.reshape(z.shape[0], -1)
        ll = jnp.sum((data * lf - jax.nn.softplus(lf)) * mask, axis=1)
        return -jdist.standard_normal_neg_log_prior(z) + ll

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(jax.random, "rademacher", lambda *a, **k: queues["sign"].pop(0))
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(unif))
        (js, jl, jstep, _), (jacc, _) = jmcmc._hmc_step(
            (jnp.asarray(state), jnp.asarray(logp0), jnp.float32(0.3), jnp.int32(t)),
            jax.random.PRNGKey(0), log_prob_fn=j_lp,
            grad_fn=jax.grad(lambda s, k: jnp.sum(j_lp(s, k))), **kw)
    assert len(seen) == 2

    calls = []
    port_draws = Queue([d[2] for d in draws])
    t_data, t_mask, g = torch.as_tensor(data), torch.as_tensor(mask), tm.nets["g"]

    def t_lp(z, d):
        calls.append(z.requires_grad)
        return tmn._masked_log_prob(tm.cfg, g, z, t_data, t_mask, d)

    with monkeypatch.context() as mp:
        mp.setattr(torch, "randn", lambda *a, **k: torch.as_tensor(mom))
        mp.setattr(torch, "rand", lambda *a, **k: torch.as_tensor(unif))
        (ts, tl, tstep, tt), tacc = tmcmc._hmc_step_stochastic(
            (torch.as_tensor(state), torch.as_tensor(logp0), torch.tensor(0.3), t), None,
            log_prob_fn=t_lp, noise=port_draws, **kw)
    assert calls == [True] * (LEAPFROG + 1) + [False] and not port_draws.items
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert 0 < int(tacc.sum()) < N_ROWS
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tstep), float(jstep), rtol=1e-7)
    assert tt == t + 1


def test_sampler_evaluates_the_target_l_plus_2_times_per_step(tmp_path, monkeypatch):
    """Through tfp_mcmc_sampler, for both generators: one value for the
    initial state, then L + 2 evaluations per step."""
    for use_bnn in (False, True):
        _, tm = _bridged(tmp_path / str(use_bnn), monkeypatch, use_bnn)
        calls, hmc = [], tmcmc.hmc

        def counting(log_prob_fn, *a, **kw):
            return hmc(lambda p, z, d: calls.append(1) or log_prob_fn(p, z, d), *a, **kw)

        monkeypatch.setattr(tmcmc, "hmc", counting)
        z = tm.tfp_mcmc_sampler(_images(3), ind_x1=np.arange(392), n_mcmc=4, burn_in=3,
                                num_leapfrog_steps=LEAPFROG)
        monkeypatch.setattr(tmcmc, "hmc", hmc)
        assert z.shape == (4, 3, Z_DIM) and np.all(np.isfinite(z))
        assert len(calls) == 1 + 7 * (LEAPFROG + 2)


def _quiet_generator(jm, tm):
    """Set both models' variance head's bias to -8 (and the flipout
    layers' rho to -6): a trained generator's small pixel variance.  With
    random nets the reparameterised logits' noise would move the target's
    value by tens between draws, and the stochastic chains would accept
    nothing."""
    g = bridge.net_to_numpy(tm.nets["g"])
    g["var"]["b"] = np.full_like(g["var"]["b"], -8.0)
    if tm.cfg.use_bnn:
        for k in GEN_LAYERS:
            g[k]["rho"] = np.full_like(g[k]["rho"], -6.0)
    jm.nets = {**jm.nets, "g": jax.tree.map(jnp.asarray, g)}
    tm._copy_nets(bridge.nets_from_numpy({**bridge.nets_to_numpy(tm.nets), "g": g}), "quiet")


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_predict_matches_jax_in_law(tmp_path, monkeypatch, use_bnn):
    """Same bridged nets, the same images with all but a central 6 x 6
    patch hidden: each image's imputed probability averaged over its
    missing pixels and the kept draws within 4 Monte-Carlo standard errors
    of JAX's (se = sd of the per-draw series over sqrt(its ESS)); the
    diagnostics NaN at the same pixels; the intervals of JAX's shape;
    observed pixels passed through.  (A small patch keeps the posterior
    close to the N(0, I) prior the chains start from, so they need no
    burn-in, and the step size stays 0.15 in both.)"""
    jm, tm = _bridged(tmp_path, monkeypatch, use_bnn)
    _quiet_generator(jm, tm)
    observed = np.zeros((28, 28), bool)
    observed[11:17, 11:17] = True
    observed = observed.ravel()
    test = _images(4, 8).reshape(4, -1)
    test[:, ~observed] = np.nan
    test = test.reshape(4, 28, 28, 1)
    kw = dict(alpha=0.1, n_mcmc=250, burn_in=0, step_size=0.15, num_leapfrog_steps=2,
              return_samples=True, return_diagnostics=True)
    cube_j, iv_j, diag_j = jm.predict(test, **kw)
    cube_t, iv_t, diag_t = tm.predict(test, **kw)
    cube_j = np.asarray(cube_j)
    assert cube_t.shape == cube_j.shape == (250, 4, 28, 28, 1)
    assert iv_t.shape == np.asarray(iv_j).shape == (4, 784 - 36, 2)
    assert np.all(iv_t[..., 0] <= iv_t[..., 1])
    np.testing.assert_array_equal(np.isnan(diag_t["ess"]), np.isnan(np.asarray(diag_j["ess"])))
    stats = [c.reshape(250, 4, -1)[:, :, ~observed].mean(axis=2) for c in (cube_t, cube_j)]
    se = [s.std(axis=0) / np.sqrt(tmcmc.effective_sample_size(s)) for s in stats]
    gap = np.abs(stats[0].mean(axis=0) - stats[1].mean(axis=0))
    assert np.all(gap <= 4.0 * np.sqrt(se[0] ** 2 + se[1] ** 2)), (gap, se)
    imputed, _ = tm.predict(test, n_mcmc=5, burn_in=5)
    np.testing.assert_array_equal(imputed.reshape(4, -1)[:, observed],
                                  test.reshape(4, -1)[:, observed])
    assert np.all(np.isfinite(imputed)) and np.all((imputed >= 0) & (imputed <= 1))


def test_subject_batch_chains_share_batchnorm(tmp_path, monkeypatch):
    """Reference-side fault (b): channel BatchNorm's batch statistics couple
    the rows of one subject batch, in JAX and in the port alike: moving one
    row's z moves another row's log posterior under the same draw."""
    jm, tm = _bridged(tmp_path, monkeypatch)
    rng = np.random.default_rng(6)
    n = 4
    x, z = _images(n, 6), rng.normal(size=(n, Z_DIM)).astype(np.float32)
    z2 = z.copy()
    z2[0] += 1.0
    g_tree = bridge.net_to_numpy(tm.nets["g"])
    _, _, draws = _gen_draws(g_tree, n, rng, False)
    rep = np.asarray(draws.rep.permute(0, 2, 3, 1))
    with monkeypatch.context() as mp:
        patch_jax_draws(mp, normals=[rep, rep])
        j1, j2 = (np.asarray(jm.get_log_posterior(zz, x, key=jax.random.PRNGKey(0)))
                  for zz in (z, z2))
        mp.setattr(tmn, "_gen_draws", Queue([draws, draws]))
        t1, t2 = (tm.get_log_posterior(zz, x).detach().numpy() for zz in (z, z2))
    for a, b in ((j1, j2), (t1, t2)):
        assert np.all(np.abs(a[1:] - b[1:]) > 1e-3), (a, b)
