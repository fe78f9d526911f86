"""The rest of the port's inference surface against the JAX package on the
same bridged weights and data: the doubly-robust ADRF collector and
``predict(estimator="dr")``, the ESS gate (``adaptive_mh(early_stop=)`` and
``predict(ess_target=)``), ``metropolis_hastings_sampler`` and
``infer_from_latent_posterior``, and binary ITE predict in law."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.datasets import Sim_Hirano_Imbens_sampler  # noqa: E402
from bayesgm_tpu.models import causalbgm as jcb  # noqa: E402
from bayesgm_tpu.ops import mcmc as jmcmc  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402
from _torch_parity import FlipoutDraws  # noqa: E402

torch.set_num_threads(2)

# f32 forward values summed in another order than XLA's (dots 5 to 16 wide);
# the collector's Hajek ratio sums n kernel weights on top
VAL_TOL = dict(rtol=1e-5, atol=1e-5)
X_VALUES = np.linspace(0, 3, 5)
Z_DIM = 5


def _params(tmp_path, **kw):
    p = dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="t",
             output_dir=str(tmp_path), save_res=False, g_units=[16, 16], e_units=[16],
             h_units=[8], f_units=[8], dz_units=[8])
    p.update(kw)
    return p


def _data(n=64, binary=False):
    x, y, v = Sim_Hirano_Imbens_sampler(batch_size=32, N=n, v_dim=6, seed=0).load_all()
    if binary:
        x = (x > np.median(x)).astype(np.float32)
    return x, y, v


@pytest.fixture(scope="module", params=[True, False], ids=["bnn", "plain"])
def pair(request, tmp_path_factory):
    """A JAX model (random init) and the port model holding its weights."""
    tmp = tmp_path_factory.mktemp("pair")
    jm = jcb.CausalBGM(_params(tmp, use_bnn=request.param), random_seed=0)
    path = str(tmp / "w.npz")
    jm.save_weights(path)
    tm = tcb.CausalBGM(_params(tmp, use_bnn=request.param), random_seed=3,
                       device="cpu").load_weights(path)
    return dict(jax=jm, port=tm, path=path, use_bnn=request.param, tmp=tmp)


def _binary_pair(pair, tmp_path):
    jm = jcb.CausalBGM(_params(tmp_path, use_bnn=pair["use_bnn"], binary_treatment=True),
                       random_seed=0).load_weights(pair["path"])
    tm = tcb.CausalBGM(_params(tmp_path, use_bnn=pair["use_bnn"], binary_treatment=True),
                       random_seed=3, device="cpu").load_weights(pair["path"])
    return jm, tm


def _within_mc_error(got, want, se_got, se_want, k=4.0):
    bound = k * np.sqrt(se_got**2 + se_want**2)
    assert np.all(np.abs(got - want) <= bound), (got, want, bound)
    return float(np.max(np.abs(got - want) / bound))


# -- the doubly-robust collector ------------------------------------------------


@pytest.mark.parametrize("fixed_sigma_x", [False, True])
def test_dr_collector_matches_jax(pair, monkeypatch, fixed_sigma_x):
    """Same z, x, y and weights (BNN nets: the same injected flipout draws,
    one shared by the grid's points as under JAX's vmap): the Hajek
    kernel-AIPW ADRF of both packages."""
    jm, tm = pair["jax"], pair["port"]
    jcfg, tcfg = jm.cfg, tm.cfg
    if fixed_sigma_x:
        jcfg, tcfg = jcfg._replace(sigma_x=0.7), tcfg._replace(sigma_x=0.7)
    x, y, v = _data(n=48)
    z = np.random.default_rng(4).normal(size=(48, Z_DIM)).astype(np.float32)
    draws = FlipoutDraws(monkeypatch, broadcast_lead=True)
    want = jcb._dr_effect_collector_p(jcfg, X_VALUES, 0.4, 1e-3)(
        {"nets": jm.nets, "data": tuple(map(jnp.asarray, (x, y, v)))}, jnp.asarray(z),
        jax.random.PRNGKey(0))
    got = tcb._dr_effect_collector_p(tcfg, X_VALUES, 0.4, 1e-3)(
        {"nets": tm.nets, "data": tuple(map(torch.as_tensor, (x, y, v)))}, torch.as_tensor(z),
        torch.Generator().manual_seed(0))
    assert draws.jax_calls == draws.port_calls == (3 if pair["use_bnn"] else 0)
    assert got.shape == (len(X_VALUES),)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL_TOL)


def test_default_dr_bandwidth_is_jaxs(pair, monkeypatch):
    """Without dr_bw both packages hand the collector Silverman's bandwidth
    of the whole test sample (and the same gps floor)."""
    seen = {}

    class Stop(Exception):
        pass

    def recorder(name):
        def build(cfg, x_values, h_bw, gps_floor=1e-3):
            seen[name] = (h_bw, gps_floor)
            raise Stop
        return build

    monkeypatch.setattr(jcb, "_dr_effect_collector_p", recorder("jax"))
    monkeypatch.setattr(tcb, "_dr_effect_collector_p", recorder("port"))
    data = _data(n=37)
    for name, model in (("jax", pair["jax"]), ("port", pair["port"])):
        with pytest.raises(Stop):
            model.predict(data, x_values=[1.0], estimator="dr", dr_gps_floor=0.05, bs=10)
    want = float(1.06 * np.std(data[0]) * 37 ** (-0.2))
    assert seen["port"] == seen["jax"] == (want, 0.05)


@pytest.mark.parametrize("kw,binary", [
    (dict(estimator="dr"), True),
    (dict(estimator="dr", sampler="mala"), False),
    (dict(ess_target=100.0, sampler="mala"), False),
    (dict(estimator="aipw"), False),
], ids=["dr-binary", "dr-mala", "ess-mala", "unknown-estimator"])
def test_refusals_raise_as_in_jax(pair, tmp_path, kw, binary):
    jm, tm = _binary_pair(pair, tmp_path) if binary else (pair["jax"], pair["port"])
    data = _data(n=8, binary=binary)
    xv = None if binary else [1.0]
    errors = []
    for model in (jm, tm):
        with pytest.raises(ValueError) as e:
            model.predict(data, x_values=xv, burn_in=1, n_mcmc=1, **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_dr_predict_matches_jax_within_monte_carlo_error(pair):
    """As tests/test_torch_causalbgm.py's plugin test: each DR ADRF point
    within 4 standard errors, se = sd(draws) / sqrt(ESS)."""
    data = _data()
    kw = dict(x_values=X_VALUES, alpha=0.05, burn_in=150, n_mcmc=300, q_sd=1.0,
              estimator="dr", return_diagnostics=True, return_draws=True)
    adrf_j, _, diag_j, draws_j = pair["jax"].predict(data, **kw)
    adrf_t, ci_t, diag_t, draws_t = pair["port"].predict(data, **kw)
    assert np.all(ci_t[:, 0] <= ci_t[:, 1])
    se = lambda draws, diag: draws.std(axis=1) / np.sqrt(diag["ess"])
    _within_mc_error(adrf_t, adrf_j, se(draws_t, diag_t), se(draws_j, diag_j))


# -- binary ITE predict in law ------------------------------------------------


def test_binary_ite_predict_matches_jax_within_monte_carlo_error(pair, tmp_path):
    """Binary treatment, 48 subjects: each subject's ITE within 4 standard
    errors of JAX's on the same bridged weights."""
    jm, tm = _binary_pair(pair, tmp_path)
    data = _data(n=48, binary=True)
    kw = dict(alpha=0.05, burn_in=200, n_mcmc=600, q_sd=1.0, return_diagnostics=True,
              return_draws=True)
    ite_j, _, diag_j, draws_j = jm.predict(data, **kw)
    ite_t, ci_t, diag_t, draws_t = tm.predict(data, **kw)
    assert ite_t.shape == (48,) and draws_t.shape == (600, 48)
    assert np.all(ci_t[:, 0] <= ci_t[:, 1])
    se = lambda draws, diag: draws.std(axis=0) / np.sqrt(diag["ess"])
    _within_mc_error(ite_t, ite_j, se(draws_t, diag_t), se(draws_j, diag_j))


# -- the sampler API ----------------------------------------------------------------


@pytest.mark.parametrize("binary", [False, True], ids=["continuous", "binary"])
def test_infer_from_latent_posterior_matches_jax(pair, tmp_path, binary):
    """Plain nets without outcome noise: equal to JAX at f32 tolerance.
    BNN nets (own noise per draw and grid point): each effect's mean over
    the draws within 4 standard errors of JAX's."""
    jm, tm = _binary_pair(pair, tmp_path) if binary else (pair["jax"], pair["port"])
    n_keep = 7 if not pair["use_bnn"] else 200
    z = np.random.default_rng(5).normal(size=(n_keep, 12, Z_DIM)).astype(np.float32)
    xv = None if binary else X_VALUES
    sample_y = pair["use_bnn"]
    want = np.asarray(jm.infer_from_latent_posterior(z, x_values=xv, sample_y=sample_y))
    got = tm.infer_from_latent_posterior(z, x_values=xv, sample_y=sample_y)
    shape = (n_keep, 12) if binary else (len(X_VALUES), n_keep)
    assert got.shape == want.shape == shape and np.all(np.isfinite(got))
    if not pair["use_bnn"]:
        np.testing.assert_allclose(got, want, **VAL_TOL)
        return
    axis = 0 if binary else 1
    se = lambda a: a.std(axis=axis) / np.sqrt(n_keep)
    _within_mc_error(got.mean(axis=axis), want.mean(axis=axis), se(got), se(want))


def test_metropolis_hastings_sampler_matches_jax_in_law(pair):
    """(n_keep, n, z_dim) draws whose per-subject posterior means lie within
    4 standard errors (sd / sqrt(ESS) per series) of JAX's."""
    data = _data(n=12)
    kw = dict(burn_in=200, n_keep=400)
    want = np.asarray(pair["jax"].metropolis_hastings_sampler(data, **kw))
    got = pair["port"].metropolis_hastings_sampler(data, **kw)
    assert got.shape == want.shape == (400, 12, Z_DIM) and got.dtype == np.float32
    se = lambda d: d.std(axis=0) / np.sqrt(tmcmc.effective_sample_size(d))
    _within_mc_error(got.mean(axis=0), want.mean(axis=0), se(got), se(want))


# -- the ESS gate --------------------------------------------------------------------


def _toy(n_keep, min_ess, **early):
    """Both packages' MH on N(0, I) over 4 chains of 2 dims, collecting the
    first coordinate; returns the numbers of kept rows."""
    early = dict(min_ess=min_ess, max_rhat=1.2, **early)
    init = np.random.default_rng(0).normal(size=(4, 2)).astype(np.float32)
    j = jmcmc.adaptive_mh(lambda s, k: -0.5 * jnp.sum(s**2, axis=1), jnp.asarray(init),
                          jax.random.PRNGKey(1), burn_in=100, n_keep=n_keep, q_sd=1.0,
                          collect=lambda s, k: s[:, 0], early_stop=early)
    t = tmcmc.adaptive_mh(lambda p, s, g: -0.5 * torch.sum(s**2, dim=1), torch.as_tensor(init),
                          torch.Generator().manual_seed(1), burn_in=100, n_keep=n_keep,
                          q_sd=1.0, collect=lambda p, s, g: s[:, 0], early_stop=early)
    return j.samples.shape[0], tuple(t.samples.shape)


@pytest.mark.parametrize("min_ess,n_keep,want", [(20.0, 2000, 1000), (1e9, 1500, 1500)],
                         ids=["reached", "never"])
def test_early_stop_follows_jaxs_cadence(min_ess, n_keep, want):
    """A target the chains reach stops both packages at the first check
    (1000 kept); min_ess=1e9 runs both to n_keep."""
    j_rows, t_shape = _toy(n_keep, min_ess)
    assert j_rows == want and t_shape == (want, 4)


def test_gate_columns_equal_jaxs(monkeypatch):
    """A statistic wider than gate_cols is judged on the same sorted column
    subsample in both packages."""
    taken, chosen = [], []
    take = jnp.take
    monkeypatch.setattr(jnp, "take", lambda a, idx, axis=None: taken.append(
        np.asarray(idx)) or take(a, idx, axis=axis))
    pick = tmcmc._gate_column_index
    monkeypatch.setattr(tmcmc, "_gate_column_index",
                        lambda width, k: chosen.append(pick(width, k)) or chosen[-1])
    init = np.random.default_rng(0).normal(size=(40, 2)).astype(np.float32)
    early = dict(min_ess=1e9, gate_cols=8)
    jmcmc.adaptive_mh(lambda s, k: -0.5 * jnp.sum(s**2, axis=1), jnp.asarray(init),
                      jax.random.PRNGKey(1), burn_in=0, n_keep=600, collect=lambda s, k: s[:, 0],
                      early_stop=early)
    tmcmc.adaptive_mh(lambda p, s, g: -0.5 * torch.sum(s**2, dim=1), torch.as_tensor(init),
                      torch.Generator().manual_seed(1), burn_in=0, n_keep=600,
                      collect=lambda p, s, g: s[:, 0], early_stop=early)
    assert len(taken) == 2 and len(chosen) == 1  # two JAX chunks, one choice
    for idx in taken:
        np.testing.assert_array_equal(chosen[0], idx)
    assert len(chosen[0]) == 8 and np.all(np.diff(chosen[0]) > 0)


@pytest.mark.parametrize("gate_cols", [0, -3])
def test_non_positive_gate_cols_raise(gate_cols):
    """JAX takes an empty subsample and fails at its first check; the port
    refuses the option when adaptive_mh is entered."""
    with pytest.raises(ValueError, match="gate_cols must be positive"):
        tmcmc.adaptive_mh(lambda p, s, g: -0.5 * torch.sum(s**2, dim=1), torch.zeros((4, 2)),
                          torch.Generator(), burn_in=0, n_keep=1,
                          early_stop=dict(min_ess=10, gate_cols=gate_cols))


@pytest.mark.parametrize("binary", [False, True], ids=["continuous", "binary"])
@pytest.mark.parametrize("ess_target,want", [(5.0, 1000), (1e9, 1500)], ids=["stops", "cap"])
def test_predict_ess_target_keeps_multiples_of_500(tmp_path, binary, ess_target, want):
    model = tcb.CausalBGM(_params(tmp_path, use_bnn=False, binary_treatment=binary),
                          random_seed=0, device="cpu")
    out = model.predict(_data(n=16, binary=binary), x_values=None if binary else [0.5, 1.5],
                        burn_in=20, n_mcmc=1500, ess_target=ess_target, return_draws=True)
    kept = out[-1].shape[0 if binary else 1]
    assert kept == want and kept % 500 == 0 and 1000 <= kept <= 1500
    assert np.all(np.isfinite(out[0])) and np.all(out[1][:, 0] <= out[1][:, 1])
