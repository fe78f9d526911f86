"""The port's ``IdentifiableCausalBGM`` against the JAX package's: the
conditional-prior log posterior and one training step under the same
flipout draws (BNN and plain nets), the 7-tuple evaluate, the lifecycle of
``tests/test_variants.py``, predict within Monte-Carlo error on bridged
nets and the same segments, the skipped incomplete batch, exact resume with
the prior net and U, and the restore of a JAX checkpoint's prior net."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.models import identifiable as jid  # noqa: E402
from bayesgm_tpu.ops import optim as joptim  # noqa: E402
from bayesgm_tpu.utils import checkpoint as jckpt  # noqa: E402
from bayesgm_torch import IdentifiableCausalBGM, bridge  # noqa: E402
from bayesgm_torch.models import identifiable as tid  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402
from bayesgm_torch.ops import optim as toptim  # noqa: E402
from _torch_parity import FlipoutDraws  # noqa: E402

torch.set_num_threads(2)

# f32 forward values summed in another order than XLA's (dots 5 to 16 wide),
# as tests/test_torch_fit.py
VAL_TOL = dict(rtol=1e-5, atol=1e-5)
# parameters after one Adam step at lr 1e-2 (tests/test_torch_fit.py's
# STEP_TOL: an element whose gradient is near Adam's eps carries the
# gradient's summation error into the step)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
N_SEG = 4


def _data(n=64, v_dim=5, seed=0):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, v_dim).astype("float32")
    x = rng.rand(n, 1).astype("float32")
    y = (x + v[:, :1] + 0.1 * rng.randn(n, 1)).astype("float32")
    return x, y, v


def _params(tmpdir, **kw):
    p = dict(v_dim=5, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="unit",
             output_dir=str(tmpdir), use_bnn=False, g_units=[8, 8], e_units=[8, 8],
             f_units=[8], h_units=[8], dz_units=[8], save_res=False, save_model=False,
             prior_units=[8], n_segments=N_SEG, lr=1e-2, lr_theta=1e-2, lr_z=1e-2)
    p.update(kw)
    return p


def _models(tmp_path, **kw):
    """A JAX and a port IdentifiableCausalBGM holding the same five nets
    (save_weights / load_weights) and the same prior net (the bridge)."""
    jm = jid.IdentifiableCausalBGM(_params(tmp_path / "j", **kw), random_seed=0)
    path = str(tmp_path / "w.npz")
    jm.save_weights(path)
    tm = IdentifiableCausalBGM(_params(tmp_path / "t", **kw), random_seed=1, device="cpu")
    tm.load_weights(path)
    tm._copy_prior_net(jax.tree.map(np.asarray, jm.prior_net), "the JAX model")
    return jm, tm


def _segments(n, seed=7):
    return np.eye(N_SEG, dtype=np.float32)[np.random.default_rng(seed).integers(0, N_SEG, n)]


def _assert_tree_close(got, want, **tol):
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(np.asarray(a), b, err_msg=jax.tree_util.keystr(path), **tol)


# -- deterministic parity ------------------------------------------------------------


@pytest.mark.parametrize("use_bnn", [True, False], ids=["bnn", "plain"])
def test_get_log_posterior_matches_jax(monkeypatch, tmp_path, use_bnn):
    """log p(z | x, y, v, u): the likelihood rows (draws g, h, f) less the
    N(0, I) prior plus the conditional prior (a draw of the prior net)."""
    jm, tm = _models(tmp_path, use_bnn=use_bnn)
    x, y, v = _data(n=12)
    z = np.random.default_rng(1).normal(size=(12, 5)).astype(np.float32)
    u = _segments(12)
    draws = FlipoutDraws(monkeypatch)
    want = np.asarray(jm.get_log_posterior(x, y, v, z, u, key=jax.random.PRNGKey(0)))
    got = tm.get_log_posterior(x, y, v, z, u).numpy()
    assert draws.jax_calls == draws.port_calls == (4 if use_bnn else 0)
    np.testing.assert_allclose(got, want, **VAL_TOL)


@pytest.mark.parametrize("use_bnn", [True, False], ids=["bnn", "plain"])
def test_train_batch_step_matches_jax(monkeypatch, tmp_path, use_bnn):
    """One step: g, h and f each an Adam step on their own draw, then ONE
    evaluation of the latent loss whose two gradients step the batch's Z
    rows (table Adam) and the prior net (Adam): nets, prior net and its
    moments, the latent table and its moments, and the losses agree."""
    jm, tm = _models(tmp_path, use_bnn=use_bnn)
    n, batch = 40, 16
    x, y, v = _data(n=n)
    u = _segments(n)
    table = np.random.default_rng(4).normal(size=(n, 5)).astype(np.float32)
    idx = np.random.default_rng(5).permutation(n)[:batch]
    kl = float(jm.params["kl_weight"])
    draws = FlipoutDraws(monkeypatch)

    j_table = jnp.asarray(table)
    step = jax.jit(lambda c, i, k, d, du: jid._ivae_train_batch_step(jm.cfg, kl, c, i, k, d, du,
                                                                       lr_scale=0.5))
    carry, j_losses = step(
        (jm.nets, jm.opts, jm.prior_net, jm._prior_opt, j_table, joptim.table_adam_init(j_table)),
        jnp.asarray(idx), jax.random.PRNGKey(1), tuple(map(jnp.asarray, (x, y, v))),
        jnp.asarray(u))
    j_nets, j_opts, j_prior, j_popt, j_table, j_zopt = carry
    t_table = torch.as_tensor(table.copy())
    t_opts, t_popt, t_zopt, t_losses = tid._ivae_train_batch_step(
        tm.cfg, kl, tm.nets, tm.opts, tm.prior_net, tm._prior_opt, t_table,
        toptim.table_adam_init(t_table), torch.as_tensor(idx), None, tm._data((x, y, v)),
        torch.as_tensor(u), lr_scale=0.5)

    assert draws.jax_calls == draws.port_calls == (7 if use_bnn else 0)
    assert set(t_losses) == set(j_losses)
    for k in j_losses:
        np.testing.assert_allclose(float(t_losses[k]), float(j_losses[k]), err_msg=k, **VAL_TOL)
    for k in "ghf":
        _assert_tree_close(bridge.net_to_numpy(tm.nets[k]), j_nets[k], **STEP_TOL)
    _assert_tree_close(bridge.net_to_numpy(tm.prior_net), j_prior, **STEP_TOL)
    got_popt = bridge.adam_to_jax(t_popt, tm.prior_net)
    _assert_tree_close(got_popt.m, j_popt.m, rtol=1e-4, atol=1e-7)
    _assert_tree_close(got_popt.v, j_popt.v, rtol=1e-4, atol=1e-9)
    assert int(got_popt.t) == int(j_popt.t) == 1
    np.testing.assert_allclose(t_table.numpy(), np.asarray(j_table), **STEP_TOL)
    np.testing.assert_allclose(t_zopt.m.numpy(), np.asarray(j_zopt.m), rtol=5e-4, atol=5e-7)
    untouched = np.setdiff1d(np.arange(n), idx)
    np.testing.assert_array_equal(t_table.numpy()[untouched], table[untouched])


def test_evaluate_is_jaxs_7_tuple(monkeypatch, tmp_path):
    """(causal_pre, mse_x, mse_y, mse_v, x_pred, y_pred, v_pred) under the
    same draws (e, g, f, h, then one draw for the ADRF grid)."""
    jm, tm = _models(tmp_path, use_bnn=True)
    x, y, v = _data(n=31)
    draws = FlipoutDraws(monkeypatch)
    want = jid._ivae_evaluate(jm.cfg, jm.nets, tuple(map(jnp.asarray, (x, y, v))), None,
                              jax.random.PRNGKey(2))
    got = tm.evaluate((x, y, v))
    assert len(got) == len(want) == 7 and draws.jax_calls == draws.port_calls == 5
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VAL_TOL)
    assert got[4].shape == (31, 1) and got[6].shape == (31, 5)


def test_conditional_prior_matters(tmp_path):
    """tests/test_variants.py::test_identifiable_conditional_prior_matters."""
    x, y, v = _data()
    m = IdentifiableCausalBGM(_params(tmp_path, n_segments=10), random_seed=2, device="cpu")
    z = np.zeros((4, 5), dtype="float32")
    u1 = np.eye(10, dtype="float32")[[0, 0, 0, 0]]
    u2 = np.eye(10, dtype="float32")[[5, 5, 5, 5]]
    lp1 = m.get_log_posterior(x[:4], y[:4], v[:4], z, u1).numpy()
    lp2 = m.get_log_posterior(x[:4], y[:4], v[:4], z, u2).numpy()
    assert not np.allclose(lp1, lp2)


# -- the model's surface -------------------------------------------------------------


def test_identifiable_lifecycle(tmp_path):
    """tests/test_variants.py::test_identifiable_lifecycle on the port (96
    rows, 10 segments), plus the refusals."""
    x, y, v = _data(n=96)
    m = IdentifiableCausalBGM(_params(tmp_path, n_segments=10, lr=2e-4, lr_theta=1e-4,
                                      lr_z=1e-4), random_seed=1, device="cpu")
    m.fit((x, y, v), epochs=2, epochs_per_eval=2, batch_size=16, use_egm_init=False, verbose=0)
    assert m.data_u.shape == (96, 10) and bool(torch.all(m.data_u.sum(dim=1) == 1))
    out = m.evaluate((x, y, v), m.data_z)
    assert len(out) == 7
    causal_pre, mse_x, mse_y, mse_v, x_pred, y_pred, v_pred = out
    assert x_pred.shape == (96, 1) and v_pred.shape == (96, 5) and causal_pre.shape == (200,)

    u = m._sample_u(10)
    z = np.random.RandomState(0).randn(10, 5).astype("float32")
    lp = m.get_log_posterior(x[:10], y[:10], v[:10], z, u).numpy()
    assert lp.shape == (10,) and np.all(np.isfinite(lp))

    zs, du = m.metropolis_hastings_sampler((x[:8], y[:8], v[:8]), burn_in=20, n_keep=10)
    assert zs.shape == (10, 8, 5) and du.shape == (8, 10)

    adrf, ci = m.predict((x, y, v), alpha=0.1, n_mcmc=10, burn_in=20, x_values=[0.5, 1.0])
    assert adrf.shape == (2,) and ci.shape == (2, 2) and np.all(ci[:, 0] <= ci[:, 1])
    adrf, ci, diag = m.predict((x, y, v), alpha=0.1, n_mcmc=30, burn_in=30, x_values=[0.5, 1.0],
                               return_diagnostics=True)
    assert diag["ess"].shape == (2,) and diag["rhat"].shape == (2,)
    assert 0.0 <= diag["accept_rate"] <= 1.0
    adrf_m, ci_m, diag_m = m.predict((x, y, v), alpha=0.1, n_mcmc=30, burn_in=30,
                                     x_values=[0.5, 1.0], sampler="mala",
                                     return_diagnostics=True)
    assert adrf_m.shape == (2,) and np.all(np.isfinite(adrf_m)) and np.all(ci_m[:, 0] <= ci_m[:, 1])
    assert 0.0 <= diag_m["accept_rate"] <= 1.0
    with pytest.raises(ValueError, match="Unknown sampler"):
        m.predict((x, y, v), x_values=[0.5], sampler="hmcx")
    with pytest.raises(ValueError, match="ess_target requires"):
        m.predict((x, y, v), x_values=[0.5], sampler="mala", ess_target=100)
    for call in (lambda: m.fit((x, y, v), mesh=object()),
                 lambda: m.predict((x, y, v), x_values=[0.5], mesh=object())):
        with pytest.raises(TypeError, match="Mesh"):
            call()


def test_predict_matches_jax_within_monte_carlo_error(monkeypatch, tmp_path):
    """BNN nets and prior net bridged from JAX, the same segments U on both
    sides (each package's _sample_u replaced), 48 subjects: each ADRF point
    within 4 * sqrt(se_port^2 + se_jax^2), se = sd(draws) / sqrt(ESS), and
    the acceptance within 0.05, as tests/test_torch_causalbgm.py does for
    CausalBGM."""
    jm, tm = _models(tmp_path, use_bnn=True, lr=2e-4, lr_theta=1e-4, lr_z=1e-4)
    data = _data(n=48)
    u = _segments(48, seed=9)
    monkeypatch.setattr(jm, "_sample_u", lambda n: jnp.asarray(u[:n]))
    monkeypatch.setattr(tm, "_sample_u", lambda n: torch.as_tensor(u[:n]))
    kw = dict(x_values=np.linspace(0, 1, 4), alpha=0.05, burn_in=150, n_mcmc=300, q_sd=1.0,
              return_diagnostics=True, return_draws=True)
    adrf_j, _, diag_j, draws_j = jm.predict(data, **kw)
    adrf_t, ci_t, diag_t, draws_t = tm.predict(data, **kw)
    assert adrf_t.shape == (4,) and draws_t.shape == draws_j.shape == (4, 300)
    assert np.all(ci_t[:, 0] <= ci_t[:, 1])
    se = lambda draws, diag: draws.std(axis=1) / np.sqrt(diag["ess"])
    bound = 4.0 * np.sqrt(se(draws_t, diag_t) ** 2 + se(draws_j, diag_j) ** 2)
    assert np.all(np.abs(adrf_t - adrf_j) <= bound), (adrf_t, adrf_j, bound)
    assert abs(diag_t["accept_rate"] - diag_j["accept_rate"]) <= 0.05


def test_fit_skips_the_incomplete_batch(monkeypatch, tmp_path):
    """40 rows at batch 16: two full batches per pass, the last 8 rows of
    each permutation skipped, as JAX's identifiable fit does; batch_size >
    n raises before any work."""
    x, y, v = _data(n=40)
    m = IdentifiableCausalBGM(_params(tmp_path), random_seed=3, device="cpu")
    sizes, orig = [], tid._ivae_train_batch_step

    def counting(*a, **k):
        sizes.append(int(a[8].shape[0]))
        return orig(*a, **k)

    monkeypatch.setattr(tid, "_ivae_train_batch_step", counting)
    m.fit((x, y, v), epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0)
    assert sizes == [16] * 4
    with pytest.raises(ValueError, match="exceeds n=40"):
        m.fit((x, y, v), epochs=1, batch_size=41, use_egm_init=False, verbose=0)


# -- checkpoints ----------------------------------------------------------------------


def _port(tmpdir, **kw):
    return IdentifiableCausalBGM(_params(tmpdir, save_model=True, dataset="resume", **kw),
                                 timestamp="ts", random_seed=7, device="cpu")


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "bnn"])
def test_resume_is_exact(tmp_path, use_bnn):
    """tests/test_resume.py::test_identifiable_resume_exact: 4 epochs
    against 2 and a new instance resuming to 4; the nets, the prior net, U,
    the latent table and both generators equal bit for bit."""
    data = _data()
    kw = dict(batch_size=16, epochs_per_eval=1, use_egm_init=False, verbose=0)
    ma = _port(tmp_path / "a", use_bnn=use_bnn)
    ma.fit(data, epochs=4, **kw)
    _port(tmp_path / "b", use_bnn=use_bnn).fit(data, epochs=2, **kw)
    mb = _port(tmp_path / "b", use_bnn=use_bnn)
    mb.fit(data, epochs=4, **kw)
    for k in ma.nets:
        for p, q in zip(ma.nets[k].parameters(), mb.nets[k].parameters()):
            assert torch.equal(p, q), k
    for p, q in zip(ma.prior_net.parameters(), mb.prior_net.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(ma.data_u, mb.data_u) and torch.equal(ma.data_z, mb.data_z)
    assert torch.equal(ma._gen.get_state(), mb._gen.get_state())
    assert torch.equal(ma._host_gen.get_state(), mb._host_gen.get_state())
    assert ma.best_epoch == mb.best_epoch
    with np.load(os.path.join(ma.checkpoint_path, "ckpt-4.npz")) as fa, \
            np.load(os.path.join(mb.checkpoint_path, "ckpt-4.npz")) as fb:
        for key in fa.files:
            if not key.startswith(("['swa_nets']", "['swa_count']")):
                np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX identifiable fit of 1 epoch with save_model=True."""
    tmp = tmp_path_factory.mktemp("jaxckpt")
    jm = jid.IdentifiableCausalBGM(_params(tmp, save_model=True, dataset="resume"),
                                   timestamp="ts", random_seed=0)
    jm.fit(_data(), epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0)
    return tmp, jm


def test_init_restores_the_prior_net_of_a_jax_checkpoint(jax_checkpoint, capsys):
    """As JAX's __init__ restores ['nets'] and ['prior_net']: a port model
    on the JAX run's folder holds JAX's fitted prior net and nets, whatever
    its seed; its fit falls back to them (no generator states in the file)."""
    tmp, jm = jax_checkpoint
    tm = _port(tmp)
    assert "Latest checkpoint restored!!" in capsys.readouterr().out
    _assert_tree_close(bridge.net_to_numpy(tm.prior_net), jm.prior_net, rtol=0, atol=0)
    _assert_tree_close(bridge.net_to_numpy(tm.nets["g"]), jm.nets["g"], rtol=0, atol=0)
    tm.fit(_data(), epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0)
    assert "Full-state resume unavailable" in capsys.readouterr().out


def test_port_file_has_the_jax_keys(jax_checkpoint, tmp_path):
    """The port's full-state file holds JAX's keys (prior_net, prior_opt and
    data_u among them) with the two generator states for JAX's key."""
    tmp, jm = jax_checkpoint
    tm = _port(tmp_path)
    tm.fit(_data(), epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0)
    with np.load(os.path.join(tm.checkpoint_path, "ckpt-1.npz")) as p, \
            np.load(jckpt.latest_checkpoint(jm.checkpoint_path)) as j:
        port_keys, jax_keys = set(p.files), set(j.files)
        np.testing.assert_array_equal(p["['data_u']"], tm.data_u.numpy())
    assert port_keys == (jax_keys - {"['key']"}) | {"['gen']", "['host_gen']"}
    assert {"['data_u']", "['prior_opt'].t"} <= port_keys
