"""The port's weight-space sampler, ``ops.mcmc.hmc``, against the JAX
package's: one ``_hmc_step`` with the same injected momentum and accept
uniforms gives the same state, log target, acceptance and adapted step
size, the step-size nudge rounds as JAX's jitted chain rounds it, fifty
such steps in float64 across the end of the step-size adaptation give the
same chain, and the chain-level cases of ``tests/test_mcmc.py`` (a shifted
normal recovered, the step size adapting up, params mode equal to closure
mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import mcmc as jmcmc  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402

from _torch_parity import jax_chain_step_size  # noqa: E402

torch.set_num_threads(2)

# f32 arithmetic of three leapfrog steps through tanh, summed in another
# order than XLA's
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _j_logp(s, key):
    return -0.5 * jnp.sum(s**2, axis=-1) - jnp.sum(jnp.log(jnp.cosh(1.5 * s - 0.3)), axis=-1)


def _t_logp(s, generator):
    return -0.5 * torch.sum(s**2, dim=-1) - torch.sum(torch.log(torch.cosh(1.5 * s - 0.3)), dim=-1)


@pytest.mark.parametrize("t,n_adapt", [(0, 10), (10, 10)], ids=["adapting", "adapted"])
def test_hmc_step_matches_jax_with_injected_draws(monkeypatch, t, n_adapt):
    """The same momentum (N(0, I)) and uniforms on both sides; the port
    carries the current gradient, JAX evaluates it again (same numbers).
    Uniforms chosen so some chains accept and some reject."""
    rng = np.random.default_rng(0)
    state = rng.normal(size=(16, 3)).astype(np.float32)
    mom = rng.normal(size=(16, 3)).astype(np.float32)
    unif = np.where(np.arange(16) % 2 == 0, 1e-6, 0.999).astype(np.float32)
    kw = dict(num_leapfrog=3, target_accept=0.75, n_adapt=n_adapt, adaptation_rate=0.05)

    j_state = jnp.asarray(state)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(mom))
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(unif))
        (js, jl, jstep, jt), (jacc, _) = jmcmc._hmc_step(
            (j_state, _j_logp(j_state, None), jnp.float32(0.4), jnp.int32(t)),
            jax.random.PRNGKey(0), log_prob_fn=_j_logp,
            grad_fn=jax.grad(lambda s, k: jnp.sum(_j_logp(s, k))), **kw)

    t_state = torch.as_tensor(state)
    logp0, grad0 = tmcmc._value_and_grad(_t_logp, t_state, None)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "randn", lambda *a, **k: torch.as_tensor(mom))
        mp.setattr(torch, "rand", lambda *a, **k: torch.as_tensor(unif))
        (ts, tl, tg, tstep, tt), tacc = tmcmc._hmc_step(
            (t_state, logp0, grad0, torch.tensor(0.4), t), None,
            value_and_grad_fn=lambda s, g: tmcmc._value_and_grad(_t_logp, s, g), **kw)

    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert 0 < int(tacc.sum()) < 16
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **STEP_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    np.testing.assert_allclose(float(tstep), float(jstep), rtol=1e-7)
    assert tt == int(jt) == t + 1
    # the carried gradient is the gradient at the carried state
    np.testing.assert_allclose(tg.numpy(), tmcmc._value_and_grad(_t_logp, ts, None)[1].numpy(),
                               rtol=1e-6, atol=1e-7)


# float64 arithmetic of fifty steps of three leapfrog steps each, summed in
# another order than XLA's
F64_TOL = dict(rtol=1e-10, atol=1e-10)


def _jitted_jax_step(monkeypatch, log_prob_fn, **kw):
    """JAX's ``_hmc_step`` jitted, as its chain runs it, with the momentum
    and the accept uniforms as arguments: ``step(carry, momentum, u)``."""
    grad = jax.grad(lambda s, k: jnp.sum(log_prob_fn(s, k)))

    @jax.jit
    def step(carry, mom, u):
        with monkeypatch.context() as mp:  # active while the step is traced
            mp.setattr(jax.random, "normal", lambda key, shape, dtype=None: mom)
            mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: u)
            return jmcmc._hmc_step(carry, jax.random.PRNGKey(0), log_prob_fn=log_prob_fn,
                                   grad_fn=grad, **kw)

    return step


def test_step_size_nudge_rounds_as_jax_jitted_chain():
    """The down nudge ``step / (1 + rate)`` inside JAX's jitted chain is a
    product with the float32 reciprocal (XLA's rewrite of a division by a
    constant); the port's step size equals it bit for bit, up and down, at
    three hundred step sizes and three rates, and stays put once adapted."""
    rng = np.random.default_rng(11)
    sizes = np.exp(rng.uniform(np.log(1e-6), np.log(1.0), 300)).astype(np.float32)
    for rate in (0.01, 0.05, 0.2):
        for lar, up in ((0.0, True), (-5.0, False)):
            for t in (0, 10):
                want = np.array([jax_chain_step_size(s, up, t=t, adaptation_rate=rate)
                                 for s in sizes], np.float32)
                got = np.array([float(tmcmc._adapt_step_size(
                    torch.tensor(s), torch.full((4,), lar), t, 10, 0.75, rate)) for s in sizes],
                    np.float32)
                np.testing.assert_array_equal(got, want, err_msg=f"rate {rate}, up {up}, t {t}")
                if t:
                    np.testing.assert_array_equal(want, sizes)
                else:
                    assert ((want > sizes) if up else (want < sizes)).all()


def test_hmc_steps_match_jax_in_f64_across_the_adaptation_boundary(monkeypatch):
    """Fifty consecutive steps of both packages' ``_hmc_step`` in float64 on
    the same injected momenta and uniforms, JAX's jitted as its chain runs
    it, the step size adapted over the first thirty (n_adapt 30) and fixed
    after: every step's state, log target, accept decisions and step size
    equal JAX's.  The uniforms are float32 values, so both sides compare
    the same numbers; the start step is wide enough that some steps reject
    and the step size moves both ways."""
    rng = np.random.default_rng(5)
    n, d, steps, n_adapt = 8, 3, 50, 30
    state = rng.normal(size=(n, d))
    moms = rng.normal(size=(steps, n, d))
    unifs = rng.random((steps, n)).astype(np.float32).astype(np.float64)
    kw = dict(num_leapfrog=3, target_accept=0.75, n_adapt=n_adapt, adaptation_rate=0.05)

    with jax.enable_x64(True):
        step = _jitted_jax_step(monkeypatch, _j_logp, **kw)
        js = jnp.asarray(state)
        j_carry = (js, _j_logp(js, None), jnp.float32(0.9), jnp.int32(0))
        j_chain = []
        for i in range(steps):
            j_carry, (j_acc, _) = step(j_carry, jnp.asarray(moms[i]), jnp.asarray(unifs[i]))
            j_chain.append([np.asarray(j_carry[0]), np.asarray(j_carry[1]),
                            float(j_carry[2]), np.asarray(j_acc)])
        assert j_carry[0].dtype == jnp.float64

    at = [0]
    ts = torch.as_tensor(state)
    vg = lambda s, g: tmcmc._value_and_grad(_t_logp, s, g)  # noqa: E731
    t_carry = (ts, *vg(ts, None), torch.tensor(0.9), 0)
    with monkeypatch.context() as mp:
        mp.setattr(tmcmc, "_momentum", lambda s, g: torch.as_tensor(moms[at[0]]))
        mp.setattr(tmcmc, "_rand_rows", lambda like, g: torch.as_tensor(unifs[at[0]]))
        for i, (j_state, j_logp, j_step, j_acc) in enumerate(j_chain):
            at[0] = i
            t_carry, t_acc = tmcmc._hmc_step(t_carry, None, value_and_grad_fn=vg, **kw)
            assert t_carry[0].dtype == torch.float64
            np.testing.assert_array_equal(t_acc.numpy(), j_acc, err_msg=f"step {i}")
            np.testing.assert_allclose(t_carry[0].numpy(), j_state, **F64_TOL)
            np.testing.assert_allclose(t_carry[1].numpy(), j_logp, **F64_TOL)
            assert float(t_carry[3]) == j_step, f"step {i}"
    accepts = np.array([c[3] for c in j_chain])
    assert 0 < accepts.sum() < accepts.size
    sizes = np.array([c[2] for c in j_chain])
    nudges = np.sign(np.diff(sizes[:n_adapt]))
    assert (nudges > 0).any() and (nudges < 0).any()
    assert np.all(sizes[n_adapt - 1:] == sizes[n_adapt - 1])


def test_hmc_recovers_shifted_normal():
    """tests/test_mcmc.py::test_hmc_recovers_shifted_normal, same settings
    and limits."""
    mu = torch.tensor([1.5, -0.5])
    res = tmcmc.hmc(lambda z, g: -0.5 * torch.sum((z - mu) ** 2, dim=-1), torch.zeros((32, 2)),
                    torch.Generator().manual_seed(0), burn_in=300, n_keep=1000, step_size=0.2,
                    num_leapfrog=5)
    samples = res.samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.mean(axis=0), mu.numpy(), atol=0.12)
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.12)
    assert float(res.accept_rate) > 0.5


def test_hmc_step_size_adapts_up():
    """tests/test_mcmc.py::test_hmc_step_size_adapts_up."""
    res = tmcmc.hmc(lambda z, g: -0.5 * torch.sum(z**2, dim=-1), torch.zeros((8, 2)),
                    torch.Generator().manual_seed(1), burn_in=500, n_keep=50, step_size=0.001,
                    num_leapfrog=3)
    assert float(res.step_size) > 0.001


def test_hmc_params_mode_matches_closure_mode():
    """tests/test_mcmc.py::test_hmc_params_mode_matches_closure_mode: the
    same draws bit for bit, and params reach the target and the collector."""
    def lp(params, s, g):
        return -0.5 * torch.sum((s - params["mu"]) ** 2, dim=-1)

    init = torch.randn((8, 2), generator=torch.Generator().manual_seed(8))
    params = {"mu": torch.ones(2)}
    kw = dict(burn_in=100, n_keep=50, step_size=0.2, num_leapfrog=3)
    r_p = tmcmc.hmc(lp, init, torch.Generator().manual_seed(9), params=params, **kw)
    r_c = tmcmc.hmc(lambda s, g: lp(params, s, g), init, torch.Generator().manual_seed(9), **kw)
    assert torch.equal(r_p.samples, r_c.samples)
    assert torch.equal(r_p.step_size, r_c.step_size)
    r2 = tmcmc.hmc(lp, init, torch.Generator().manual_seed(9), params={"mu": 4.0 * torch.ones(2)},
                   collect=lambda p, s, g: s.mean(dim=0) - p["mu"], **kw)
    assert r2.samples.shape == (50, 2)
    assert abs(float(r2.samples.mean())) < 1.0


def test_hmc_shapes_and_refusals():
    res = tmcmc.hmc(lambda z, g: -0.5 * torch.sum(z**2, dim=-1), torch.zeros((3, 4)),
                    torch.Generator().manual_seed(2), burn_in=5, n_keep=0, num_leapfrog=2)
    assert res.samples is None and float(res.accept_rate) == 0.0
    with pytest.raises(ValueError, match="num_leapfrog"):
        tmcmc.hmc(lambda z, g: -z.sum(dim=-1), torch.zeros((3, 4)), torch.Generator(),
                  burn_in=1, n_keep=1, num_leapfrog=0)
