"""The ported fit slice against the JAX package: loss terms, one training
step (through K2's plain version and through autograd), the EGM critic and
generator steps, the evaluation, and a small fit -> predict from the same
bridged init.

Every random draw is injected on both sides: the flipout draws through
:class:`_torch_parity.FlipoutDraws`, the kernels' sign words through the
stubbed TPU PRNG and ``sign_words=``, and the EGM batches and interpolation
weights through monkeypatches of ``jax.random`` and of the port's helpers."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.datasets import Sim_Hirano_Imbens_sampler  # noqa: E402
from bayesgm_tpu.models import causalbgm as jcb  # noqa: E402
from bayesgm_tpu.ops import _pk_bnn_hosteps as jk  # noqa: E402
from bayesgm_tpu.ops import _pk_util as jpk  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_tpu.ops import optim as joptim  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from bayesgm_torch.ops import _pk_bnn_hosteps as tk  # noqa: E402
from bayesgm_torch.ops import _pk_util as tpk  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402
from bayesgm_torch.ops import optim as toptim  # noqa: E402
from _torch_parity import (  # noqa: E402
    FlipoutDraws,
    patch_interp_weights,
    replayed_words,
    stub_prng,
)

torch.set_num_threads(2)

Z_DIM = 5
# f32 forward values summed in another order than XLA's (dots 5 to 16 wide)
VAL_TOL = dict(rtol=1e-5, atol=1e-5)
# parameters after an Adam step at lr 1e-2: the first step is
# lr * g / (|g| + 1e-6), so an element whose gradient is near 1e-6 carries the
# gradient's f32 summation error into the step; 1e-5 absolute is 1e-3 of a step
STEP_TOL = dict(rtol=1e-5, atol=1e-5)

VARIANTS = {"continuous": {}, "binary": dict(binary_treatment=True),
            "deconf": dict(deconf_weight=0.5),
            "fixed_sigmas": dict(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3)}


def _params(tmp_path, **kw):
    p = dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="t",
             output_dir=str(tmp_path), save_res=False, g_units=[16, 16], e_units=[16],
             h_units=[8], f_units=[8], dz_units=[8], lr=1e-2, lr_theta=1e-2, lr_z=1e-2)
    p.update(kw)
    return p


def _models(tmp_path, **kw):
    """A JAX model and a port model holding the same five nets (bridged
    through JAX ``save_weights`` and the port's ``load_weights``)."""
    p = _params(tmp_path, **kw)
    jm = jcb.CausalBGM(p, random_seed=0)
    path = str(tmp_path / "init.npz")
    jm.save_weights(path)
    return jm, tcb.CausalBGM(p, random_seed=5, device="cpu").load_weights(path)


def _data(n, binary=False):
    x, y, v = Sim_Hirano_Imbens_sampler(batch_size=32, N=n, v_dim=6, seed=0).load_all()
    if binary:
        x = (x > np.median(x)).astype(np.float32)
    return x, y, v


def _latents(n, seed=2):
    return np.random.default_rng(seed).normal(size=(n, Z_DIM)).astype(np.float32)


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a, np.float32)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a, jnp.float32) for a in arrays)


def _tree(net, tensors=None):
    """A port net (or per-parameter tensors in its ``parameters()`` order,
    e.g. gradients or Adam moments) in the JAX pytree layout."""
    if tensors is not None:
        net = copy.deepcopy(net)
        with torch.no_grad():
            for p, t in zip(net.parameters(), tensors, strict=True):
                p.copy_(t)
    return bridge.net_to_numpy(net)


def _assert_tree_close(got, want, **tol):
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(np.asarray(a), b, err_msg=jax.tree_util.keystr(path), **tol)


def _assert_losses_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **tol)


def test_critic_matches_jax():
    """The critic (dense, frozen-BN affine, tanh; linear last layer) and its
    input gradient, from the same weights."""
    jnet = jax.tree.map(np.asarray, jnn.init_critic(jax.random.PRNGKey(3), Z_DIM, [8, 4]))
    for bn in jnet["bn"]:
        bn["gamma"] = bn["gamma"] * 1.3
        bn["beta"] = bn["beta"] + 0.2
    tnet = bridge.critic_from_numpy(jnet)
    z = _latents(11)
    want = jnn.critic_apply(jnet, jnp.asarray(z))
    want_dz = jax.grad(lambda a: jnp.sum(jnn.critic_apply(jnet, a)))(jnp.asarray(z))
    (tz,) = _t(z)
    tz.requires_grad_(True)
    got = tnn.critic_apply(tnet, tz)
    (got_dz,) = torch.autograd.grad(got.sum(), tz)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL_TOL)
    np.testing.assert_allclose(got_dz.numpy(), np.asarray(want_dz), **VAL_TOL)
    assert tnet.dims == [Z_DIM, 8, 4, 1]


def test_critic_init_is_glorot_uniform_with_zero_bias():
    net = tnn.Critic(40, [60], torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (40 + 60))
    w = net.w[0].detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit
    assert abs(w.mean()) < 0.02 * limit and abs(w.std() - limit / np.sqrt(3)) < 0.05 * limit
    assert all(not b.detach().any() for b in net.b)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_terms_and_gradients_match_jax(monkeypatch, tmp_path, variant):
    """_loss_v, _loss_x and _loss_y (NLL batch mean + kl_weight * KL, the
    deconfounding penalty, binary cross-entropy) and their gradients with
    respect to every parameter of g, h and f, under the same draws."""
    jm, tm = _models(tmp_path, **VARIANTS[variant])
    x, y, v = _data(24, binary=variant == "binary")
    z = _latents(24)
    draws = FlipoutDraws(monkeypatch)
    key = jax.random.PRNGKey(0)
    for name, jfn, tfn, args in (("g", jcb._loss_v, tcb._loss_v, (z, v)),
                                 ("h", jcb._loss_x, tcb._loss_x, (z, x)),
                                 ("f", jcb._loss_y, tcb._loss_y, (z, x, y))):
        (j_loss, j_aux), j_grad = jax.value_and_grad(
            lambda net: jfn(jm.cfg, net, *_j(*args), key), has_aux=True)(jm.nets[name])
        net = tm.nets[name]
        t_loss, t_aux = tfn(tm.cfg, net, *_t(*args), None)
        t_grad = torch.autograd.grad(t_loss, list(net.parameters()))
        np.testing.assert_allclose(t_loss.item(), float(j_loss), **VAL_TOL)
        np.testing.assert_allclose(t_aux.item(), float(j_aux), **VAL_TOL)
        _assert_tree_close(_tree(net, t_grad), j_grad, rtol=1e-4, atol=1e-6)
    assert draws.jax_calls == draws.port_calls == 3


def _k2_closures(jm, tm, batch):
    """``fused_latent_vg`` for JAX (the interpret-mode K2 under the stubbed
    PRNG) and ``latent_vg`` for the port (K2's plain version with the words
    that stub gives), both flattening the nets they are handed and scaling
    the same numpy eps by those nets' sigmas."""
    dims = [jpk.flipout_mlp_layer_dims(jm.nets[k]) for k in "ghf"]
    rng = np.random.default_rng(8)
    eps = [rng.normal(size=(1, a, b)).astype(np.float32)
           for d in dims for a, b in zip(d[:-1], d[1:])]
    fused = jk.make_fused_causal_logp_and_grad_bnn_hosteps(jm.cfg, *dims, block_rows=batch,
                                                           interpret=True)
    words = replayed_words(dims, batch, batch)

    def jax_vg(bz, bx, by, bv, nets, key):
        ws, sigs = zip(*(jpk.split_flipout_flat(jpk.flatten_flipout_params(nets[k]))
                         for k in "ghf"))
        ps = [s[None] * jnp.asarray(e) for s, e in zip(sum(sigs, []), eps)]
        return fused(bz, bx, by, bv, jnp.zeros((2,), jnp.int32), *ws, ps)

    calls = []

    def port_vg(bz, bx, by, bv, nets, generator):
        ws, sigs = zip(*(tpk.split_flipout_flat(tpk.flatten_flipout_params(nets[k]))
                         for k in "ghf"))
        ps = [s[None] * torch.as_tensor(e) for s, e in zip(sum(sigs, []), eps)]
        calls.append(bz.shape[0])
        return tk.logp_and_grad_plain(tm.cfg, bz, bx, by, bv, torch.zeros(2, dtype=torch.int32),
                                      *ws, ps, sign_words=words)

    return jax_vg, port_vg, calls


@pytest.mark.parametrize("latent", ["k2", "autograd"])
def test_train_batch_step_matches_jax(monkeypatch, tmp_path, latent):
    """One iterative-updating step: g, h and f each take their own draw and
    an Adam step, then the latent rows take a table-Adam step whose gradient
    comes from the UPDATED nets (through K2, divided by the batch size, or
    through autograd of the batch-mean loss).  Nets, Adam moments, latent
    table and its moments, and the losses agree with JAX."""
    jm, tm = _models(tmp_path)
    n, batch = 40, 16
    x, y, v = _data(n)
    table = _latents(n, seed=4)
    idx = np.random.default_rng(5).permutation(n)[:batch]
    draws = FlipoutDraws(monkeypatch)
    jax_vg = port_vg = None
    if latent == "k2":
        stub_prng(monkeypatch)
        jax_vg, port_vg, calls = _k2_closures(jm, tm, batch)

    j_table = jnp.asarray(table)
    (j_nets, j_opts, j_table, j_zopt), j_losses = jcb._train_batch_step(
        jm.cfg, (jm.nets, jm.opts, j_table, joptim.table_adam_init(j_table)), jnp.asarray(idx),
        jax.random.PRNGKey(1), _j(x, y, v), fused_latent_vg=jax_vg, lr_scale=0.5)
    (t_table,) = _t(table)
    t_opts, t_zopt, t_losses = tcb._train_batch_step(
        tm.cfg, tm.nets, tm.opts, t_table, toptim.table_adam_init(t_table), torch.as_tensor(idx), None,
        _t(x, y, v), latent_vg=port_vg, lr_scale=0.5)

    assert draws.jax_calls == draws.port_calls == (3 if latent == "k2" else 6)
    if latent == "k2":
        assert calls == [batch]
    _assert_losses_close(t_losses, j_losses, **VAL_TOL)
    for k in "ghf":
        _assert_tree_close(_tree(tm.nets[k]), j_nets[k], **STEP_TOL)
        _assert_tree_close(_tree(tm.nets[k], t_opts[k].m), j_opts[k].m, rtol=1e-4, atol=1e-7)
        _assert_tree_close(_tree(tm.nets[k], t_opts[k].v), j_opts[k].v, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(t_table.numpy(), np.asarray(j_table), **STEP_TOL)
    np.testing.assert_allclose(t_zopt.m.numpy(), np.asarray(j_zopt.m), rtol=5e-4, atol=5e-7)
    np.testing.assert_allclose(t_zopt.v.numpy(), np.asarray(j_zopt.v), rtol=1e-3, atol=1e-9)
    assert t_zopt.t == int(j_zopt.t) == 1
    untouched = np.setdiff1d(np.arange(n), idx)
    np.testing.assert_array_equal(t_table.numpy()[untouched], table[untouched])


def test_egm_disc_step_matches_jax(monkeypatch, tmp_path):
    """The WGAN-GP critic step (Wasserstein loss + 10 x the gradient
    penalty, a double backward) updates the critic as JAX does."""
    jm, tm = _models(tmp_path)
    z, v = _latents(16), _data(16)[2]
    draws = FlipoutDraws(monkeypatch)
    patch_interp_weights(monkeypatch, [0.3])
    j_nets, j_opt, j_losses = jcb._egm_disc_step(jm.cfg, jm.nets, jm._opt_d, *_j(z, v),
                                                 jax.random.PRNGKey(2))
    t_opt, t_losses = tcb._egm_disc_step(tm.cfg, tm.nets, tm._opt_d, *_t(z, v), None)
    assert draws.jax_calls == draws.port_calls == 1
    _assert_losses_close(t_losses, j_losses, **VAL_TOL)
    assert float(t_losses["d_loss"]) != pytest.approx(float(t_losses["dz_loss"]), abs=1e-3)
    _assert_tree_close(_tree(tm.nets["dz"]), j_nets["dz"], **STEP_TOL)
    _assert_tree_close(_tree(tm.nets["dz"], t_opt.m), j_opt.m, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("variant", ["continuous", "binary"])
def test_egm_gen_step_matches_jax(monkeypatch, tmp_path, variant):
    """The joint g/e/f/h generator step (adversarial, roundtrip, supervised
    and 0.001 x raw variance-head terms; e also learns through
    z_rec = e(g(z))) updates all four nets as JAX does."""
    jm, tm = _models(tmp_path, **VARIANTS[variant])
    x, y, v = _data(16, binary=variant == "binary")
    z = _latents(16)
    draws = FlipoutDraws(monkeypatch)
    j_nets, _, j_losses = jcb._egm_gen_step(jm.cfg, jm.nets, jm._opt_ge, *_j(z, v, x, y),
                                            jax.random.PRNGKey(3))
    before_e = _tree(tm.nets["e"])
    _, t_losses = tcb._egm_gen_step(tm.cfg, tm.nets, tm._opt_ge, *_t(z, v, x, y), None)
    assert draws.jax_calls == draws.port_calls == 6
    _assert_losses_close(t_losses, j_losses, **VAL_TOL)
    for k in ("g", "e", "f", "h"):
        _assert_tree_close(_tree(tm.nets[k]), j_nets[k], **STEP_TOL)
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()), _tree(tm.nets["e"]), before_e)
    assert max(jax.tree.leaves(moved)) > 1e-3


def test_egm_iter_draws_its_own_batch_per_step(monkeypatch, tmp_path):
    """g_d_freq critic steps then one generator step, each on its own batch
    indices and batch z (handed to both packages in the same order)."""
    jm, tm = _models(tmp_path, g_d_freq=2)
    n = 30
    x, y, v = _data(n)
    rng = np.random.default_rng(6)
    batches = [(rng.integers(0, n, size=8), rng.normal(size=(8, Z_DIM)).astype(np.float32))
               for _ in range(3)]
    j_idx, j_z, t_it = iter(batches), iter(batches), iter(batches)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k: jnp.asarray(next(j_idx)[0]))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(next(j_z)[1]))

    def port_batch(generator, n_rows, batch_size, z_dim, device):
        idx, z = next(t_it)
        assert (n_rows, batch_size, z_dim) == (n, 8, Z_DIM)
        return torch.as_tensor(idx), torch.as_tensor(z)

    monkeypatch.setattr(tcb, "_egm_batch", port_batch)
    patch_interp_weights(monkeypatch, [0.25, 0.75])
    draws = FlipoutDraws(monkeypatch)
    (j_nets, _, _), j_losses = jcb._egm_iter(jm.cfg, (jm.nets, jm._opt_d, jm._opt_ge),
                                             jax.random.PRNGKey(4), _j(x, y, v), 8)
    tm._opt_d, tm._opt_ge, t_losses = tcb._egm_iter(tm.cfg, tm.nets, tm._opt_d, tm._opt_ge,
                                                    _t(x, y, v), None, 8)
    assert draws.jax_calls == draws.port_calls == 2 + 6
    _assert_losses_close(t_losses, j_losses, **VAL_TOL)
    for k in tcb.NET_NAMES:
        _assert_tree_close(_tree(tm.nets[k]), j_nets[k], **STEP_TOL)


@pytest.mark.parametrize("n", [2, 3, 21, 31, 41, 101, 200, 257])
def test_percentile_nearest_matches_jnp(n):
    """'nearest' percentiles at 5 and 95; n = 21, 31, 41, 101 put the index
    on an exact .5 tie."""
    x = np.random.default_rng(n).normal(size=(n, 1)).astype(np.float32)
    for pct in (5.0, 95.0):
        want = float(jnp.percentile(jnp.asarray(x), pct, method="nearest"))
        assert float(tcb._percentile_nearest(torch.as_tensor(x), pct)) == want


@pytest.mark.parametrize("variant,given_z", [("continuous", False), ("continuous", True),
                                             ("binary", False)])
def test_evaluate_matches_jax(monkeypatch, tmp_path, variant, given_z):
    """The evaluation's MSEs and its ITE / 200-point ADRF grid.  n = 31 puts
    both percentile indices (1.5 and 28.5) on a 'nearest' tie; the grid takes
    one draw that every grid point shares, as JAX's vmap over one key."""
    jm, tm = _models(tmp_path, **VARIANTS[variant])
    n = 31
    x, y, v = _data(n, binary=variant == "binary")
    z = _latents(n) if given_z else None
    draws = FlipoutDraws(monkeypatch)
    want = jcb._evaluate(jm.cfg, jm.nets, _j(x, y, v), None if z is None else jnp.asarray(z),
                         jax.random.PRNGKey(5))
    got = tcb._evaluate(tm.cfg, tm.nets, _t(x, y, v), None if z is None else _t(z)[0], None)
    n_draws = (3 if given_z else 4) + (2 if variant == "binary" else 1)
    assert draws.jax_calls == draws.port_calls == n_draws
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VAL_TOL)
    if variant == "continuous":
        assert got[0].shape == (200,)


def test_load_weights_restores_all_five_nets(tmp_path):
    """Every tensor of g, e, f, h and the critic dz comes across from a JAX
    save_weights file, and the port keeps training its own parameters."""
    jm, tm = _models(tmp_path)
    for k in tcb.NET_NAMES:
        _assert_tree_close(_tree(tm.nets[k]), jm.nets[k], rtol=0, atol=0)
    assert isinstance(tm.nets["dz"], tnn.Critic)
    assert tm.opts["g"].m[0].shape == tm.nets["g"].gamma.shape


@pytest.mark.parametrize("what", ["mesh"])
def test_unported_fit_options_raise(tmp_path, what):
    model = tcb.CausalBGM(_params(tmp_path), random_seed=0, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):  # a mesh must be a parallel.Mesh
        model.fit(_data(8), epochs=1, egm_n_iter=1, mesh=object())


# -- the slice as a whole -----------------------------------------------------

FIT_N = 256
FIT_KW = dict(epochs=4, epochs_per_eval=2, batch_size=32, egm_n_iter=60,
              egm_batches_per_eval=30, verbose=0)


def _fit_params(tmp_path, **kw):
    return _params(tmp_path, lr=1e-3, lr_theta=1e-3, lr_z=1e-3, lr_decay="cosine", **kw)


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """One JAX fit from a saved init, with the untrained and the fitted MSEs."""
    tmp = tmp_path_factory.mktemp("jaxfit")
    data = _data(FIT_N)
    jm = jcb.CausalBGM(_fit_params(tmp), random_seed=0)
    init = str(tmp / "init.npz")
    jm.save_weights(init)
    untrained = [float(a) for a in jm.evaluate(data)[1:]]
    jm.fit(data, **FIT_KW)
    fitted = [float(a) for a in jm.evaluate(data, jm.data_z)[1:]]
    return dict(tmp=tmp, data=data, init=init, untrained=untrained, fitted=fitted)


def test_fit_then_predict_tracks_jax(jax_fit, tmp_path):
    """From the same five nets, the port's fit reaches mse_v and mse_y
    within [0.5x, 2x] of JAX's (different random streams: the two trajectories
    agree in law, not draw for draw), below the untrained model's; predict
    then runs on the fitted model, with its best and SWA snapshots too."""
    data = jax_fit["data"]
    tm = tcb.CausalBGM(_fit_params(tmp_path), random_seed=1, device="cpu")
    tm.load_weights(jax_fit["init"])
    untrained = [float(a) for a in tm.evaluate(data)[1:]]
    tm.fit(data, **FIT_KW)
    fitted = [float(a) for a in tm.evaluate(data, tm.data_z)[1:]]
    (_, jy, jv), (_, ty, tv) = jax_fit["fitted"], fitted
    print("untrained mse_x/y/v port", untrained, "jax", jax_fit["untrained"])
    print("fitted mse_x/y/v port", fitted, "jax", jax_fit["fitted"])
    assert 0.5 * jy <= ty <= 2.0 * jy and 0.5 * jv <= tv <= 2.0 * jv
    assert ty < untrained[1] and tv < untrained[2]
    assert tm.data_z.shape == (FIT_N, Z_DIM) and bool(torch.isfinite(tm.data_z).all())
    assert all(np.isfinite(a) for a in {**tm.egm_losses, **tm.fit_losses}.values())
    assert tm.best_epoch in (0, 2, 4) and tm._swa_count == 2
    for kw in ({}, dict(use_best_nets=True), dict(use_swa_nets=True)):
        adrf, ci = tm.predict(data, x_values=[0.5, 1.0, 2.0], burn_in=20, n_mcmc=30, **kw)
        assert adrf.shape == (3,) and np.all(np.isfinite(ci)) and np.all(ci[:, 0] <= ci[:, 1])


def test_save_weights_round_trips_through_jax_load_weights(tmp_path):
    """A fitted port model's save_weights file loads in JAX load_weights with
    every tensor (five nets and the latent table) exactly equal."""
    tm = tcb.CausalBGM(_fit_params(tmp_path), random_seed=2, device="cpu")
    tm.fit(_data(40), epochs=1, epochs_per_eval=1, batch_size=16, egm_n_iter=3,
           egm_batches_per_eval=2, verbose=0)
    path = tm.save_weights(str(tmp_path / "port.npz"))
    jm = jcb.CausalBGM(_fit_params(tmp_path), random_seed=9).load_weights(path)
    for k in tcb.NET_NAMES:
        _assert_tree_close(_tree(tm.nets[k]), jm.nets[k], rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(jm.data_z), tm.data_z.numpy())
    again = tcb.CausalBGM(_fit_params(tmp_path), random_seed=3, device="cpu").load_weights(path)
    for k in tcb.NET_NAMES:
        for a, b in zip(again.nets[k].parameters(), tm.nets[k].parameters()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("binary", [False, True])
def test_fit_through_k2_plain_version_on_cpu(tmp_path, binary):
    """use_pallas_latent=True on the CPU drives fit's kernel path (K2's
    wrapper, here its plain version): one call per batch, epochs + 1
    passes, no kernel launch counted, and a finite latent table."""
    tm = tcb.CausalBGM(_fit_params(tmp_path, use_pallas_latent=True, binary_treatment=binary),
                       random_seed=0, device="cpu")
    fused = tm.kernels["bnn_hosteps_grad"]
    calls = []
    original = fused.__class__.__call__

    def spy(self, *args):
        calls.append(args[0].shape[0])
        return original(self, *args)

    fused.__class__ = type("Spy", (fused.__class__,), {"__call__": spy})
    tm.fit(_data(40, binary=binary), epochs=2, epochs_per_eval=1, batch_size=16, egm_n_iter=3,
           egm_batches_per_eval=2, verbose=0)
    assert calls == [16, 16, 8] * 3 and fused.launches == 0
    assert bool(torch.isfinite(tm.data_z).all())
    auto = tcb.CausalBGM(_fit_params(tmp_path), random_seed=0, device="cpu")
    assert auto._build_fused_latent_vg() is None  # "auto" on the CPU: the autograd composite


@pytest.mark.parametrize("value", [False, 0, 1, None, "", "xla"])
def test_use_pallas_latent_takes_only_auto_or_true(tmp_path, value):
    """Only "auto" and True are modes: any other value raises rather than
    let fit or the MH target pick a path the other does not."""
    with pytest.raises(ValueError, match="use_pallas_latent"):
        tcb.CausalBGM(_params(tmp_path, use_pallas_latent=value), random_seed=0, device="cpu")


# -- the log-target for gradient samplers -------------------------------------


def test_get_log_posterior_matches_jax(monkeypatch, tmp_path):
    jm, tm = _models(tmp_path)
    x, y, v = _data(20)
    z = _latents(20)
    draws = FlipoutDraws(monkeypatch)
    want = jm.get_log_posterior(x, y, v, z, key=jax.random.PRNGKey(6))
    got = tm.get_log_posterior(x, y, v, z)
    assert draws.jax_calls == draws.port_calls == 3
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL_TOL)


def test_differentiable_log_prob_backward_is_k2_gradient(tmp_path):
    """On the kernel path the differentiable target is K2 under an autograd
    Function: the value is -neg and the backward of sum(w * log_prob) is
    -w * K2's gradient, row by row; the plain target is K1's value."""
    tm = tcb.CausalBGM(_params(tmp_path, use_pallas_latent=True), random_seed=0, device="cpu")
    x, y, v = _data(12)
    seen = {}
    for name in ("bnn_hosteps", "bnn_hosteps_grad"):
        def spy(*args, _fn=tm.kernels[name], _name=name):
            seen[_name] = _fn(*args)
            return seen[_name]
        tm.kernels[name] = spy
    (z,) = _t(_latents(12))
    z.requires_grad_(True)
    w = torch.linspace(-1.0, 2.0, 12)
    lp = tm._make_log_prob(x, y, v, differentiable=True)(z, torch.Generator().manual_seed(1))
    (lp * w).sum().backward()
    neg, grad = seen["bnn_hosteps_grad"]
    assert torch.equal(lp.detach(), -neg)
    torch.testing.assert_close(z.grad, -w[:, None] * grad, rtol=0, atol=0)
    value = tm._make_log_prob(x, y, v)(z.detach(), torch.Generator().manual_seed(1))
    assert torch.equal(value, -seen["bnn_hosteps"]) and torch.equal(value, lp.detach())


def test_log_prob_on_cpu_is_the_composite(tmp_path):
    tm = tcb.CausalBGM(_params(tmp_path), random_seed=0, device="cpu")
    x, y, v = _data(10)
    z = _t(_latents(10))[0]
    lp = tm._make_log_prob(x, y, v, differentiable=True)
    got = lp(z, torch.Generator().manual_seed(2))
    want = tm.get_log_posterior(x, y, v, z, generator=torch.Generator().manual_seed(2))
    assert torch.equal(got, want)
