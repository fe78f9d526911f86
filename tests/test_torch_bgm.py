"""The port's BGM against the JAX package's: the two variational decoders
with their running statistics, one training step and one EGM iteration
with the same injected draws, the log posterior in both forms and the
dense-mask target, save and load both ways, exact resume, the simulators
and prior samplers, the config driver's BGM branch, the ``bgm`` CLI, and a
no-JAX subprocess that fits and predicts with each decoder."""

import glob
import os
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.datasets import prior_samplers as jps  # noqa: E402
from bayesgm_tpu.datasets import simulators as jsim  # noqa: E402
from bayesgm_tpu.models import bgm as jbgm  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch import main as driver  # noqa: E402
from bayesgm_torch.cli import cli as tcli  # noqa: E402
from bayesgm_torch.datasets import prior_samplers as tps  # noqa: E402
from bayesgm_torch.datasets import simulators as tsim  # noqa: E402
from bayesgm_torch.models import bgm as tbgm  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402
from bayesgm_torch.utils import config_io  # noqa: E402

from _torch_parity import FlipoutDraws  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 forward of a 3-layer decoder, summed in another order than XLA's
APPLY_TOL = dict(rtol=1e-5, atol=1e-6)
# one Adam step (b2 0.99 / 0.9: the first update is ~lr * sign(grad), so a
# rounding difference in a tiny gradient moves a weight by up to lr * 1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _params(tmp_path, **kw):
    p = dict(x_dim=5, z_dim=2, dataset="t", output_dir=str(tmp_path), save_res=False,
             g_units=[16, 16], e_units=[16, 16], dz_units=[8], dx_units=[8])
    p.update(kw)
    return p


def _jax_model(tmp_path, seed=0, **kw):
    """A JAX BGM with random nets and random running statistics."""
    m = jbgm.BGM(_params(tmp_path, **kw), random_seed=seed)
    rng = np.random.default_rng(seed)
    m.g_state = {"norm": {"mean": jnp.asarray(rng.normal(size=m.cfg.z_dim), jnp.float32),
                          "var": jnp.asarray(rng.uniform(0.5, 2.0, m.cfg.z_dim), jnp.float32)}}
    return m


def _bridged(tmp_path, seed=0, **kw):
    """``(jax_model, port_model)`` holding the same nets and statistics."""
    jm = _jax_model(tmp_path / "j", seed, **kw)
    path = str(tmp_path / "w.npz")
    jm.save_weights(path)
    tm = tbgm.BGM(_params(tmp_path / "t", **kw), random_seed=seed + 1, device="cpu")
    return jm, tm.load_weights(path)


def _port_tree(net):
    return bridge.net_to_numpy(net)


def _assert_tree_close(port_tree, jax_tree, **tol):
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    assert len(flat_p) == len(flat_j)
    for path, leaf in flat_p:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_j[path]),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _low_rank(n=64):
    return tsim.simulate_low_rank_data(n_samples=n, z_dim=2, x_dim=4)[0].astype(np.float32)


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("flipout", [False, True], ids=["plain", "flipout"])
def test_variational_decoder_matches_jax(monkeypatch, flipout, train):
    """Mean, variance, the running statistics after the call and (flipout)
    the KL, on bridged weights and statistics, under the shared flipout
    stream."""
    draws = FlipoutDraws(monkeypatch)
    init = jnn.init_flipout_variational_mlp if flipout else jnn.init_variational_mlp
    jp, _ = init(jax.random.PRNGKey(3), 3, 5, [16, 16])
    rng = np.random.default_rng(0)
    state = {"norm": {"mean": jnp.asarray(rng.normal(size=3), jnp.float32),
                      "var": jnp.asarray(rng.uniform(0.5, 2.0, 3), jnp.float32)}}
    x = rng.normal(1.0, 2.0, size=(12, 3)).astype(np.float32)
    net = bridge.net_from_numpy(jax.tree.map(np.asarray, jp))
    assert type(net) is (tnn.FlipoutVariationalMLP if flipout else tnn.VariationalMLP)
    net.set_bn_state(bridge.bn_state_from_numpy(state))
    if flipout:
        jm, jv, js = jnn.flipout_variational_mlp_apply(jp, jnp.asarray(x), jax.random.PRNGKey(0),
                                                       state=state, train=train)
        tm, tv, ts = tnn.flipout_variational_mlp_apply(net, torch.as_tensor(x), None, train=train)
        assert draws.jax_calls == draws.port_calls == 1
        np.testing.assert_allclose(float(tnn.flipout_variational_mlp_kl(net)),
                                   float(jnn.flipout_variational_mlp_kl(jp)), rtol=1e-5)
    else:
        jm, jv, js = jnn.variational_mlp_apply(jp, jnp.asarray(x), state=state, train=train)
        tm, tv, ts = tnn.variational_mlp_apply(net, torch.as_tensor(x), train=train)
    for got, want in ((tm, jm), (tv, jv), (ts[0], js["norm"]["mean"]), (ts[1], js["norm"]["var"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **APPLY_TOL)
    # the apply leaves the buffers alone: the caller commits the new state
    np.testing.assert_array_equal(net.bn_mean.numpy(), np.asarray(state["norm"]["mean"]))
    assert _port_tree(net).keys() == jp.keys()


# ---------------------------------------------------------------------------
# training step and EGM iteration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_train_batch_step_matches_jax(tmp_path, monkeypatch, use_bnn):
    """Two steps of the iterative phase (the second with Adam moments):
    g, its running statistics, the latent table and the losses."""
    FlipoutDraws(monkeypatch)
    jm, tm = _bridged(tmp_path, use_bnn=use_bnn, lr_theta=0.01, lr_z=0.02)
    data = np.random.default_rng(1).normal(size=(40, 5)).astype(np.float32)
    z0 = np.random.default_rng(2).normal(size=(40, 2)).astype(np.float32)
    idxs = [np.arange(0, 16), np.arange(20, 36)[::-1].copy()]

    from bayesgm_tpu.ops import optim as joptim

    carry = (jm.nets["g"], jm.g_state, joptim.adam_init(jm.nets["g"]), jnp.asarray(z0),
             joptim.table_adam_init(jnp.asarray(z0)))
    from bayesgm_torch.ops import optim as toptim

    g = tm.nets["g"]
    z_table = torch.as_tensor(z0.copy())
    opt_g, z_opt = tm.opt_g, toptim.table_adam_init(z_table)
    for idx in idxs:
        carry, jl = jbgm._train_batch_step(jm.cfg, carry, jnp.asarray(idx), jax.random.PRNGKey(0),
                                           jnp.asarray(data), lr_scale=0.5)
        opt_g, z_opt, tl = tbgm._train_batch_step(tm.cfg, g, opt_g, z_table, z_opt,
                                                  torch.as_tensor(idx), None,
                                                  torch.as_tensor(data), lr_scale=0.5)
        for k in ("loss_x", "loss_mse_x", "loss_postrior_z"):
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    jg, jstate, _, jz, _ = carry
    _assert_tree_close(_port_tree(g), jg, **STEP_TOL)
    _assert_tree_close(bridge.bn_state_to_numpy(g), jstate, **STEP_TOL)
    np.testing.assert_allclose(z_table.numpy(), np.asarray(jz), **STEP_TOL)


class _Queue:
    def __init__(self, items):
        self.items = list(items)

    def __call__(self, *a, **k):
        return self.items.pop(0)


@pytest.mark.parametrize("gamma,use_bnn", [(0.0, False), (10.0, False), (10.0, True)],
                         ids=["gamma0-plain", "gamma10-plain", "gamma10-flipout"])
def test_egm_iter_matches_jax(tmp_path, monkeypatch, gamma, use_bnn):
    """One EGM iteration (a critic step and a generator step) with the same
    batch indices, batch z, interpolation weights and reparameterisation
    noise on both sides: the four nets, g's running statistics (chained
    through the generator step's two passes) and the losses."""
    FlipoutDraws(monkeypatch)
    jm, tm = _bridged(tmp_path, use_bnn=use_bnn, gamma=gamma, alpha=0.1, lr=0.01)
    rng = np.random.default_rng(4)
    n, bs = 30, 8
    data = rng.normal(size=(n, 5)).astype(np.float32)
    idx_d, idx_g = rng.integers(0, n, bs), rng.integers(0, n, bs)
    z_d, z_g = (rng.normal(size=(bs, 2)).astype(np.float32) for _ in range(2))
    eps_z, eps_x = 0.3, 0.8
    rep = [rng.normal(size=(bs, 5)).astype(np.float32) for _ in range(3)]

    from bayesgm_tpu.ops import optim as joptim

    j = lambda a: jnp.asarray(a)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "randint", _Queue([j(idx_d), j(idx_g)]))
        mp.setattr(jax.random, "normal", _Queue([j(z_d), j(rep[0]), j(z_g), j(rep[1]), j(rep[2])]))
        mp.setattr(jax.random, "uniform", _Queue([jnp.float32(eps_z), jnp.float32(eps_x)]))
        carry = (jm.nets, jm.g_state,
                 joptim.adam_init({"dz": jm.nets["dz"], "dx": jm.nets["dx"]}),
                 joptim.adam_init({"g": jm.nets["g"], "e": jm.nets["e"]}))
        (jnets, jstate, _, _), jl = jbgm._egm_iter(jm.cfg, carry, jax.random.PRNGKey(0),
                                                   j(data), bs)
    t = lambda a: torch.as_tensor(a)
    batches = _Queue([(t(idx_d), t(z_d)), (t(idx_g), t(z_g))])
    reps = _Queue([t(r) for r in rep])
    monkeypatch.setattr(tbgm, "_egm_batch", batches)
    monkeypatch.setattr(tbgm, "_interp_weights", lambda g, d: (t(eps_z), t(eps_x)))
    monkeypatch.setattr(tbgm, "reparameterize", lambda mean, var, g: mean + torch.sqrt(var) * reps())
    _, _, tl = tbgm._egm_iter(tm.cfg, tm.nets, tm._opt_d, tm._opt_ge, t(data), None, bs)

    assert not batches.items and not reps.items
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for k in tbgm.NET_NAMES:
        _assert_tree_close(_port_tree(tm.nets[k]), jnets[k], **STEP_TOL)
    _assert_tree_close(bridge.bn_state_to_numpy(tm.nets["g"]), jstate, **STEP_TOL)


# ---------------------------------------------------------------------------
# log posterior, save and load
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_log_posterior_forms_match_jax(tmp_path, monkeypatch, use_bnn):
    """Both forms of get_log_posterior against JAX on bridged nets, and the
    HMC target's dense mask against the gather form (after JAX's
    test_bgm_dense_mask_matches_gather_logp): equal for duplicate-free
    index lists; a duplicate index counts once in the dense mask and twice
    in the gather form, in both packages."""
    draws = FlipoutDraws(monkeypatch)
    jm, tm = _bridged(tmp_path, use_bnn=use_bnn)
    rng = np.random.default_rng(5)
    n = 5
    x = rng.normal(size=(n, 5)).astype(np.float32)
    z = rng.normal(size=(n, 2)).astype(np.float32)
    ind = [[0, 2, 4], [1], [0, 1, 2, 3, 4], [3, 4], [2, 4]]
    key = jax.random.PRNGKey(0)

    np.testing.assert_allclose(tm.get_log_posterior(z, x).detach().numpy(),
                               np.asarray(jm.get_log_posterior(z, x, key=key)), **APPLY_TOL)
    j_ind, j_mask = jm._prep_obs_indices(x, ind)
    t_ind, t_mask = tm._prep_obs_indices(x, ind)
    np.testing.assert_array_equal(t_ind.numpy(), np.asarray(j_ind))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    t_gather = tm.get_log_posterior(z, x, ind_x1=t_ind, obs_mask=t_mask).detach().numpy()
    np.testing.assert_allclose(t_gather, np.asarray(jm.get_log_posterior(
        z, x, ind_x1=j_ind, obs_mask=j_mask, key=key)), **APPLY_TOL)

    dense = tm._prep_obs_dense_mask(x, ind, 5)
    expect = np.zeros((n, 5), np.float32)
    for i, row in enumerate(ind):
        expect[i, row] = 1.0
    np.testing.assert_array_equal(dense.numpy(), expect)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jm._prep_obs_dense_mask(x, ind, 5)))
    call = draws.port_calls
    target = tbgm._masked_log_prob(tm.cfg, tm.nets["g"], torch.as_tensor(z),
                                   torch.as_tensor(x), dense)
    if use_bnn:  # the same draw the gather form above took
        draws.port_calls = call - 1
        target = tbgm._masked_log_prob(tm.cfg, tm.nets["g"], torch.as_tensor(z),
                                       torch.as_tensor(x), dense)
    np.testing.assert_allclose(target.detach().numpy(), t_gather, rtol=1e-5, atol=1e-5)

    dup = np.array([[0, 0, 1]] * n)
    d_dense = tm._prep_obs_dense_mask(x, dup, 5)
    assert d_dense.sum(dim=1).tolist() == [2.0] * n
    t_dup = tm.get_log_posterior(z, x, ind_x1=dup).detach().numpy()
    j_dup = np.asarray(jm.get_log_posterior(z, x, ind_x1=dup, key=key))
    np.testing.assert_allclose(t_dup, j_dup, **APPLY_TOL)
    once = tm.get_log_posterior(z, x, ind_x1=np.array([[0, 1]] * n)).detach().numpy()
    assert not np.allclose(t_dup, once)  # the gather form counts column 0 twice


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_save_and_load_both_ways(tmp_path, monkeypatch, use_bnn):
    """A fitted port model's save_weights is read by JAX load_weights (nets,
    running statistics, latent table) and by a new port model: the log
    posterior agrees (after tests/test_serving.py::test_bgm_save_load_roundtrip)."""
    draws = FlipoutDraws(monkeypatch)
    data = _low_rank(40)
    p = _params(tmp_path, x_dim=4, use_bnn=use_bnn, g_units=[4], e_units=[4], dz_units=[4],
                dx_units=[4])
    tm = tbgm.BGM(p, random_seed=2, device="cpu")
    tm.fit(data, epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0)
    assert float(tm.nets["g"].bn_var.sub(1.0).abs().max()) > 0  # the statistics moved
    path = str(tmp_path / "bgm.npz")
    tm.save_weights(path)
    with np.load(path) as f:
        assert {"['g_state']['norm']['mean']", "['data_z']"} <= set(f.files)

    jm = jbgm.BGM(p, random_seed=50)
    jm.load_weights(path)
    t2 = tbgm.BGM(p, random_seed=50, device="cpu").load_weights(path)
    z = np.random.default_rng(0).normal(size=(5, 2)).astype(np.float32)
    draws.port_calls = draws.jax_calls = 0  # the same flipout draw for the three calls
    want = tm.get_log_posterior(z, data[:5]).detach().numpy()
    np.testing.assert_allclose(np.asarray(jm.get_log_posterior(z, data[:5], key=jax.random.PRNGKey(0))),
                               want, rtol=1e-5)
    draws.port_calls = 0
    np.testing.assert_allclose(t2.get_log_posterior(z, data[:5]).detach().numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(jm.data_z), tm.data_z.numpy())
    np.testing.assert_array_equal(t2.data_z.numpy(), tm.data_z.numpy())
    wrong = tbgm.BGM(dict(p, g_units=[8]), random_seed=1, device="cpu")
    with pytest.raises(ValueError, match="dims"):
        wrong.load_weights(path)


def test_refusals(tmp_path):
    tm = tbgm.BGM(_params(tmp_path), random_seed=0, device="cpu")
    data = np.zeros((10, 5), np.float32)
    with pytest.raises(ValueError, match="exceeds n"):
        tm.fit(data, batch_size=16, epochs=0, use_egm_init=False, verbose=0)
    with pytest.raises(TypeError, match="Mesh"):
        tm.fit(data, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        tm.predict(data, mesh=object(), n_mcmc=1, burn_in=1)
    with pytest.raises(ValueError, match="alpha"):
        tm.predict(data, alpha=1.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tbgm.BGM(_params(tmp_path), random_seed=0)


# ---------------------------------------------------------------------------
# exact resume
# ---------------------------------------------------------------------------


def _assert_last_files_equal(a, b, epoch):
    with np.load(os.path.join(a.checkpoint_path, f"ckpt-{epoch}.npz")) as fa, \
            np.load(os.path.join(b.checkpoint_path, f"ckpt-{epoch}.npz")) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        assert {"['gen']", "['host_gen']", "['opt_ge'].m['g']['norm']['gamma']",
                "['g_state']['norm']['var']", "['z_opt'].v"} <= set(fa.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_resume_is_exact(tmp_path, use_bnn):
    """tests/test_resume.py::test_bgm_resume_exact: 4 epochs against 2 and a
    resumed 2 (with the EGM), bit for bit: nets, running statistics, latent
    table, the last checkpoint and the tail of the eval history."""
    data = _low_rank(64)
    p = _params(tmp_path, x_dim=4, use_bnn=use_bnn, save_model=True, g_units=[8],
                e_units=[8], dz_units=[8], dx_units=[8])
    kw = dict(epochs_per_eval=1, batch_size=16, egm_n_iter=4, egm_batches_per_eval=2,
              verbose=0)
    ma = tbgm.BGM(dict(p, output_dir=str(tmp_path / "a")), timestamp="ts", random_seed=7,
                  device="cpu")
    ma.fit(data, epochs=4, **kw)
    pb = dict(p, output_dir=str(tmp_path / "b"))
    tbgm.BGM(pb, timestamp="ts", random_seed=7, device="cpu").fit(data, epochs=2, **kw)
    mb = tbgm.BGM(pb, timestamp="ts", random_seed=7, device="cpu")
    mb.fit(data, epochs=4, **kw)
    _assert_last_files_equal(ma, mb, 4)
    for k in tbgm.NET_NAMES:
        for x, y in zip(ma.nets[k].parameters(), mb.nets[k].parameters()):
            assert torch.equal(x, y)
    assert torch.equal(ma.nets["g"].bn_var, mb.nets["g"].bn_var)
    assert torch.equal(ma.data_z, mb.data_z)
    assert ma.history_loss[-len(mb.history_loss):] == mb.history_loss
    assert len(mb.history_loss) == 2


def test_resume_after_a_kill_with_lr_decay(tmp_path, monkeypatch):
    """A cosine-decay fit with save_res, killed in the evaluate of epoch 2
    and resumed with the same epochs, equals an uninterrupted one bit for
    bit (the checkpoint comes after every draw of its epoch)."""
    data = _low_rank(64)
    p = _params(tmp_path, x_dim=4, save_model=True, save_res=True, lr_decay="cosine",
                g_units=[8], e_units=[8], dz_units=[8], dx_units=[8])
    monkeypatch.setattr(tbgm, "GEN_SAMPLES", 50)
    kw = dict(epochs=3, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0)
    ma = tbgm.BGM(dict(p, output_dir=str(tmp_path / "a")), timestamp="ts", random_seed=3,
                  device="cpu")
    ma.fit(data, **kw)
    pb = dict(p, output_dir=str(tmp_path / "b"))
    mk = tbgm.BGM(pb, timestamp="ts", random_seed=3, device="cpu")
    calls, evaluate = [0], mk.evaluate

    def dying(*a, **k):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("simulated kill")
        return evaluate(*a, **k)

    mk.evaluate = dying
    with pytest.raises(RuntimeError, match="simulated kill"):
        mk.fit(data, **kw)
    assert sorted(os.listdir(mk.checkpoint_path)) == ["ckpt-0.npz", "ckpt-1.npz"]
    mb = tbgm.BGM(pb, timestamp="ts", random_seed=3, device="cpu")
    mb.fit(data, **kw)
    _assert_last_files_equal(ma, mb, 3)
    with np.load(os.path.join(ma.save_dir, "data_gen_at_3.npz")) as fa, \
            np.load(os.path.join(mb.save_dir, "data_gen_at_3.npz")) as fb:
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("simulate_regression", (60, 5, 2)),
    ("simulate_regression", (60, 5, 2, 2)),
    ("simulate_low_rank_data", (500,)),
    ("simulate_low_rank_data", (500, 2, 4, 2, True)),
    ("simulate_heteroskedastic_data", (200, 5)),
    ("simulate_z_hetero", (300, 3, 19)),
])
def test_simulators_equal_jaxs(name, args):
    for got, want in zip(getattr(tsim, name)(*args), getattr(jsim, name)(*args)):
        np.testing.assert_array_equal(got, want)


def test_prior_samplers_equal_jaxs():
    """The samplers' pools, batches and densities, bit for bit (after
    tests/test_datasets.py's sampler tests)."""
    pairs = [(tps.Gaussian_sampler(mean=np.zeros(3), sd=1.0, N=1000),
              jps.Gaussian_sampler(mean=np.zeros(3), sd=1.0, N=1000)),
             (tps.GMM_indep_sampler(N=1000, sd=0.1, dim=2, n_components=3, bound=1),
              jps.GMM_indep_sampler(N=1000, sd=0.1, dim=2, n_components=3, bound=1)),
             (tps.Swiss_roll_sampler(N=500), jps.Swiss_roll_sampler(N=500))]
    for t, j in pairs:
        np.testing.assert_array_equal(t.X, j.X)
        np.testing.assert_array_equal(t.train(9), j.train(9))
    t, j = pairs[0]
    np.testing.assert_array_equal(t.get_batch(17), j.get_batch(17))
    for t, j in pairs[1:]:
        q = t.X[:5]
        np.testing.assert_array_equal(t.get_density(q), j.get_density(q))
        np.testing.assert_array_equal(t.X_test, j.X_test)


# ---------------------------------------------------------------------------
# the CLI and the driver
# ---------------------------------------------------------------------------


def test_bgm_cli_alpha_remap(tmp_path):
    """tests/test_cli.py::test_bgm_branch_alpha_remap on the port: the
    significance level goes to predict, --egm_reg_alpha to the model, and
    --device to the constructor."""
    data = np.random.RandomState(0).randn(20, 5).astype("float32")
    path = str(tmp_path / "d.npz")
    np.savez(path, data=data)
    fake = mock.MagicMock()
    fake.save_dir = str(tmp_path)
    fake.predict.return_value = (np.zeros((20, 5)), np.zeros((20, 0, 2)))
    with mock.patch("bayesgm_torch.models.bgm.BGM", return_value=fake) as M, \
            mock.patch("bayesgm_torch.utils.data_io.save_data") as S:
        tcli.main(["bgm", "-o", str(tmp_path), "-i", path, "--alpha", "0.1",
                   "--egm_reg_alpha", "0.02", "--step_size", "0.05", "--device", "cpu"])
    params = M.call_args.kwargs["params"]
    assert params["x_dim"] == 5 and params["alpha"] == 0.02 and params["gamma"] == 10.0
    assert M.call_args.kwargs["device"] == "cpu" and "device" not in params
    pred = fake.predict.call_args.kwargs
    assert pred["alpha"] == 0.1 and pred["step_size"] == 0.05 and pred["n_mcmc"] == 5000
    assert fake.fit.call_args.kwargs["egm_n_iter"] == 20000
    assert any("imputed_data.txt" in c.args[0] for c in S.call_args_list)
    assert os.path.exists(os.path.join(str(tmp_path), "prediction_intervals.npz"))


def test_bgm_cli_end_to_end_on_nan_holes(tmp_path):
    """A real run on a file with NaN holes: the columns are standardised
    over their observed entries, the fit sees the complete rows only, and
    the imputed file keeps the observed entries and fills every hole."""
    rng = np.random.RandomState(1)
    data = rng.randn(40, 4).astype("float32") * 3.0 + 1.0
    holes = [(0, 1), (3, 0), (3, 2), (7, 3)]
    for r, c in holes:
        data[r, c] = np.nan
    path = str(tmp_path / "d.npz")
    np.savez(path, data=data)
    out = str(tmp_path / "o")
    seen = []
    fit = tbgm.BGM.fit
    with mock.patch.object(tbgm.BGM, "fit",
                           lambda self, data, **kw: seen.append(len(data)) or fit(self, data, **kw)):
        tcli.main(["bgm", "-o", out, "-i", path, "-d", "e2e", "--device", "cpu", "--no-use_bnn",
                   "--z_dim", "2", "--g_units", "8", "--e_units", "8", "--dz_units", "8",
                   "--dx_units", "8", "-N", "2", "--egm_batches_per_eval", "2", "-E", "1",
                   "--epochs_per_eval", "1", "--batch_size", "8", "-M", "5", "--burn_in", "5"])
    assert seen == [37]
    res, = glob.glob(os.path.join(out, "results", "e2e", "*"))
    imputed = np.loadtxt(os.path.join(res, "imputed_data.txt"))
    mean, std = np.nanmean(data, axis=0), np.nanstd(data, axis=0)
    observed = ~np.isnan(data)
    np.testing.assert_allclose(imputed[observed], ((data - mean) / std)[observed], atol=1e-5)
    assert np.all(np.isfinite(imputed))
    with np.load(os.path.join(res, "prediction_intervals.npz"), allow_pickle=True) as f:
        assert len(f["intervals"]) == 40


def _small_bgm_config(monkeypatch, tmp_path, name):
    """configs/{name} as config_io reads it, cut in the test alone: narrow
    nets, 64 rows from the config's own simulator, and predict's depth
    through a predict: block (the driver's own code keeps its sizes)."""
    params = config_io.load(os.path.join(REPO, "configs", name))
    params.update(output_dir=str(tmp_path), g_units=[8], e_units=[8], dz_units=[8],
                  dx_units=[8], predict=dict(burn_in=5, n_mcmc=10))
    if params["dataset"] == "Sim_low_rank":
        small = (_low_rank(1200), None, None)
    else:
        X, Y = tsim.simulate_z_hetero(n=80, k=params["z_dim"], d=params["x_dim"] - 1)
        small = (np.hstack([X[:64], Y[:64, None]]).astype("float32"), X[64:], Y[64:])
    monkeypatch.setattr(driver, "_load_bgm_dataset", lambda p: small)
    return params


@pytest.mark.parametrize("config", ["Sim_low_rank.yaml", "Sim_heteroskedastic.yaml"])
def test_run_bgm_on_both_configs(monkeypatch, tmp_path, capsys, config):
    params = _small_bgm_config(monkeypatch, tmp_path, config)
    out, intervals = driver.run_bgm(params, epochs=1, egm_iters=2, device="cpu")
    printed = capsys.readouterr().out
    assert np.all(np.isfinite(out))
    if config == "Sim_low_rank.yaml":
        assert out.shape == (1000, 4) and intervals.shape == (1000, 1, 2)
        assert "Imputation RMSE" in printed
    else:
        assert out.shape == (16,) and intervals.shape == (16, 1, 2)
        assert "Pearson corr (posterior median)" in printed
        assert glob.glob(os.path.join(str(tmp_path), "results", "Sim_heteroskedastic", "*",
                                      "data_pred_heter.npz"))
    assert glob.glob(os.path.join(str(tmp_path), "checkpoints", params["dataset"], "*",
                                  "ckpt-0.npz"))


def test_run_bgm_checks_its_overrides_before_the_fit(tmp_path):
    params = config_io.load(os.path.join(REPO, "configs", "Sim_low_rank.yaml"))
    with mock.patch.object(driver, "_load_bgm_dataset") as load, \
            pytest.raises(ValueError, match="not supported by model 'bgm'"):
        driver.run_bgm(dict(params, predict=dict(q_sd=1.0)), epochs=0, egm_iters=0,
                       device="cpu")
    with pytest.raises(ValueError, match="not supported by model 'bgm'"):
        driver.run_bgm(dict(params, fit=dict(startoff=1)), epochs=0, egm_iters=0, device="cpu")
    load.assert_not_called()


def test_load_bgm_dataset_matches_the_jax_driver():
    """The driver's split of Sim_heteroskedastic, on the JAX driver's sizes."""
    params = config_io.load(os.path.join(REPO, "configs", "Sim_heteroskedastic.yaml"))
    train, x_test, y_test = driver._load_bgm_dataset(params)
    X, Y = jsim.simulate_z_hetero(n=20000, k=10, d=99)
    assert train.shape == (18000, 100) and train.dtype == np.float32
    np.testing.assert_array_equal(x_test, X[-2000:])
    np.testing.assert_array_equal(y_test, Y[-2000:])
    np.testing.assert_array_equal(train[:, -1], Y[:-2000].astype("float32"))


# ---------------------------------------------------------------------------
# no JAX
# ---------------------------------------------------------------------------


def test_port_bgm_never_imports_jax(tmp_path):
    """BGM with each decoder, the samplers, and MNISTBGM with each generator
    fit and predict in a new process that imports neither JAX nor the JAX
    package."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from bayesgm_torch import BGM, simulate_low_rank_data, simulate_z_hetero
        from bayesgm_torch import Gaussian_sampler, GMM_indep_sampler, Swiss_roll_sampler
        from bayesgm_torch import main as driver
        from bayesgm_torch.cli import cli
        X, _ = simulate_low_rank_data(n_samples=48)
        for bnn in (False, True):
            m = BGM(dict(x_dim=4, z_dim=2, dataset="t", output_dir={str(tmp_path)!r} + str(bnn),
                         use_bnn=bnn, g_units=[8], e_units=[8], dz_units=[8], dx_units=[8],
                         save_res=False, save_model=True, gamma=10.0), random_seed=0,
                    device="cpu")
            m.fit(X, epochs=1, epochs_per_eval=1, batch_size=16, egm_n_iter=3,
                  egm_batches_per_eval=2, verbose=0)
            test = X[:6].copy()
            test[:, 0] = np.nan
            imputed, iv = m.predict(test, n_mcmc=5, burn_in=5)
            assert imputed.shape == (6, 4) and iv.shape == (6, 1, 2)
            assert np.all(np.isfinite(imputed))
        GMM_indep_sampler(N=20, sd=0.1, dim=2, n_components=3).get_density(np.zeros((2, 2)))
        from bayesgm_torch import MNISTBGM, make_ellipse_images, mnist_mask_indices
        images = make_ellipse_images(16)
        _, miss = mnist_mask_indices(mode="upper_half")
        for bnn in (False, True):
            m = MNISTBGM(dict(z_dim=3, dataset="m", output_dir={str(tmp_path)!r} + "m" + str(bnn),
                              use_bnn=bnn, dz_units=[8], save_res=False, save_model=True),
                         random_seed=0, device="cpu")
            m.fit(images, epochs=0, epochs_per_eval=1, batch_size=16, egm_n_iter=1,
                  egm_batches_per_eval=1, verbose=0)
            test = images[:2].reshape(2, -1).copy()
            test[:, miss] = np.nan
            imputed, iv = m.predict(test.reshape(2, 28, 28, 1), n_mcmc=2, burn_in=2)
            assert imputed.shape == (2, 28, 28, 1) and iv.shape == (2, 392, 2)
            assert np.all(np.isfinite(imputed))
        bad = [m for m in ("yaml", "pandas", "sklearn", "bayesgm_tpu") if m in sys.modules]
        print("OTHERS_IMPORTED", bad)
        print("JAX_IMPORTED", "jax" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_IMPORTED False" in out.stdout
    assert "OTHERS_IMPORTED []" in out.stdout
