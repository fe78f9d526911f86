"""CausalBGM with plain MLP nets (``use_bnn=False``) against the JAX package:
one training step (through K3's plain version and through autograd), the EGM
critic and generator steps, the evaluation, a CPU fit through K3's wrapper
against the autograd fit, weights both ways, and predict by MH and by MALA
from the same bridged weights.

Plain nets draw no noise, so the steps are deterministic; the one random
draw left, the WGAN-GP interpolation weight, is injected on both sides."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.datasets import Sim_Hirano_Imbens_sampler  # noqa: E402
from bayesgm_tpu.models import causalbgm as jcb  # noqa: E402
from bayesgm_tpu.ops import _pk_plain as jk  # noqa: E402
from bayesgm_tpu.ops import _pk_util as jpk  # noqa: E402
from bayesgm_tpu.ops import optim as joptim  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402
from bayesgm_torch.ops import optim as toptim  # noqa: E402
from _torch_parity import patch_interp_weights  # noqa: E402

torch.set_num_threads(2)

Z_DIM = 5
# f32 values summed in another order than XLA's (dots 5 to 16 wide)
VAL_TOL = dict(rtol=1e-5, atol=1e-5)
# parameters after an Adam step at lr 1e-2 (see tests/test_torch_fit.py)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = {"continuous": {}, "binary": dict(binary_treatment=True),
            "fixed_sigmas": dict(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3)}


def _params(tmp_path, **kw):
    p = dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="t",
             output_dir=str(tmp_path), save_res=False, use_bnn=False, g_units=[16, 16],
             e_units=[16], h_units=[8], f_units=[8], dz_units=[8], lr=1e-2, lr_theta=1e-2,
             lr_z=1e-2)
    p.update(kw)
    return p


def _models(tmp_path, **kw):
    """A JAX model and a port model holding the same five plain nets
    (bridged through JAX ``save_weights`` and the port's ``load_weights``)."""
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


def _tree(net, tensors):
    """Per-parameter tensors of ``net`` (e.g. gradients), in its
    ``parameters()`` order, laid out as the JAX pytree of the net."""
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


def test_model_builds_plain_nets_and_the_plain_kernels(tmp_path):
    jm, tm = _models(tmp_path)
    assert all(isinstance(tm.nets[k], tnn.MLP) for k in ("g", "e", "f", "h"))
    assert isinstance(tm.nets["dz"], tnn.Critic)
    assert set(tm.kernels) == {"plain", "plain_grad"}
    assert tm.nets["g"].dims == jpk.mlp_layer_dims(jm.nets["g"]) == [5, 16, 16, 7]
    for k in tcb.NET_NAMES:
        _assert_tree_close(bridge.net_to_numpy(tm.nets[k]), jm.nets[k], rtol=0, atol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_terms_and_gradients_match_jax(tmp_path, variant):
    """_loss_v, _loss_x and _loss_y of plain nets (no KL term) and their
    gradients with respect to every parameter."""
    jm, tm = _models(tmp_path, **VARIANTS[variant])
    x, y, v = _data(24, binary=variant == "binary")
    z = _latents(24)
    for name, jfn, tfn, args in (("g", jcb._loss_v, tcb._loss_v, (z, v)),
                                 ("h", jcb._loss_x, tcb._loss_x, (z, x)),
                                 ("f", jcb._loss_y, tcb._loss_y, (z, x, y))):
        (j_loss, j_aux), j_grad = jax.value_and_grad(
            lambda net: jfn(jm.cfg, net, *_j(*args), jax.random.PRNGKey(0)),
            has_aux=True)(jm.nets[name])
        net = tm.nets[name]
        t_loss, t_aux = tfn(tm.cfg, net, *_t(*args), None)
        t_grad = torch.autograd.grad(t_loss, list(net.parameters()))
        np.testing.assert_allclose(t_loss.item(), float(j_loss), **VAL_TOL)
        np.testing.assert_allclose(t_aux.item(), float(j_aux), **VAL_TOL)
        _assert_tree_close(_tree(net, t_grad), j_grad, rtol=1e-4, atol=1e-6)


def _k3_closures(jm, batch):
    """JAX's ``fused_latent_vg`` through its K3 in interpret mode, over the
    nets it is handed."""
    dims = [jpk.mlp_layer_dims(jm.nets[k]) for k in "ghf"]
    fused = jk.make_fused_causal_logp_and_grad(jm.cfg, *dims, block_rows=batch, interpret=True)

    def jax_vg(bz, bx, by, bv, nets, key):
        return fused(bz, bx, by, bv, *(jpk.flatten_mlp_params(nets[k]) for k in "ghf"))

    return jax_vg


@pytest.mark.parametrize("latent", ["k3", "autograd"])
def test_train_batch_step_matches_jax(tmp_path, latent):
    """One iterative-updating step with plain nets: g, h and f take an Adam
    step each, then the latent rows a table-Adam step whose gradient comes
    from the updated nets, through K3 (JAX: the interpret-mode kernel; the
    port: K3's wrapper, i.e. its plain version) or through autograd."""
    jm, tm = _models(tmp_path, use_pallas_latent=True if latent == "k3" else "auto")
    n, batch = 40, 16
    x, y, v = _data(n)
    table = _latents(n, seed=4)
    idx = np.random.default_rng(5).permutation(n)[:batch]
    jax_vg = _k3_closures(jm, batch) if latent == "k3" else None
    port_vg = tm._build_fused_latent_vg()
    assert (port_vg is None) == (latent == "autograd")

    j_table = jnp.asarray(table)
    (j_nets, j_opts, j_table, j_zopt), j_losses = jcb._train_batch_step(
        jm.cfg, (jm.nets, jm.opts, j_table, joptim.table_adam_init(j_table)), jnp.asarray(idx),
        jax.random.PRNGKey(1), _j(x, y, v), fused_latent_vg=jax_vg, lr_scale=0.5)
    (t_table,) = _t(table)
    t_opts, t_zopt, t_losses = tcb._train_batch_step(
        tm.cfg, tm.nets, tm.opts, t_table, toptim.table_adam_init(t_table),
        torch.as_tensor(idx), None, _t(x, y, v), latent_vg=port_vg, lr_scale=0.5)

    _assert_losses_close(t_losses, j_losses, **VAL_TOL)
    for k in "ghf":
        _assert_tree_close(bridge.net_to_numpy(tm.nets[k]), j_nets[k], **STEP_TOL)
    np.testing.assert_allclose(t_table.numpy(), np.asarray(j_table), **STEP_TOL)
    np.testing.assert_allclose(t_zopt.m.numpy(), np.asarray(j_zopt.m), rtol=5e-4, atol=5e-7)
    untouched = np.setdiff1d(np.arange(n), idx)
    np.testing.assert_array_equal(t_table.numpy()[untouched], table[untouched])
    assert tm.kernels["plain_grad"].launches == 0  # the CPU runs the plain version


def test_egm_disc_step_matches_jax(monkeypatch, tmp_path):
    jm, tm = _models(tmp_path)
    z, v = _latents(16), _data(16)[2]
    patch_interp_weights(monkeypatch, [0.3])
    j_nets, j_opt, j_losses = jcb._egm_disc_step(jm.cfg, jm.nets, jm._opt_d, *_j(z, v),
                                                 jax.random.PRNGKey(2))
    _, t_losses = tcb._egm_disc_step(tm.cfg, tm.nets, tm._opt_d, *_t(z, v), None)
    _assert_losses_close(t_losses, j_losses, **VAL_TOL)
    _assert_tree_close(bridge.net_to_numpy(tm.nets["dz"]), j_nets["dz"], **STEP_TOL)


@pytest.mark.parametrize("variant", ["continuous", "binary"])
def test_egm_gen_step_matches_jax(tmp_path, variant):
    """The joint g/e/f/h generator step updates the four plain nets as JAX
    does (e also learns through z_rec = e(g(z)))."""
    jm, tm = _models(tmp_path, **VARIANTS[variant])
    x, y, v = _data(16, binary=variant == "binary")
    z = _latents(16)
    j_nets, _, j_losses = jcb._egm_gen_step(jm.cfg, jm.nets, jm._opt_ge, *_j(z, v, x, y),
                                            jax.random.PRNGKey(3))
    _, t_losses = tcb._egm_gen_step(tm.cfg, tm.nets, tm._opt_ge, *_t(z, v, x, y), None)
    _assert_losses_close(t_losses, j_losses, **VAL_TOL)
    for k in ("g", "e", "f", "h"):
        _assert_tree_close(bridge.net_to_numpy(tm.nets[k]), j_nets[k], **STEP_TOL)


@pytest.mark.parametrize("variant,given_z", [("continuous", False), ("continuous", True),
                                             ("binary", False)])
def test_evaluate_matches_jax(tmp_path, variant, given_z):
    """The MSEs and the ITE / 200-point ADRF grid of plain nets (no draw)."""
    jm, tm = _models(tmp_path, **VARIANTS[variant])
    n = 31
    x, y, v = _data(n, binary=variant == "binary")
    z = _latents(n) if given_z else None
    want = jcb._evaluate(jm.cfg, jm.nets, _j(x, y, v), None if z is None else jnp.asarray(z),
                         jax.random.PRNGKey(5))
    got = tcb._evaluate(tm.cfg, tm.nets, _t(x, y, v), None if z is None else _t(z)[0], None)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VAL_TOL)


def _fit(tmp_path, **kw):
    tm = tcb.CausalBGM(_params(tmp_path, lr=1e-3, lr_theta=1e-3, lr_z=1e-3,
                               lr_decay="cosine", **kw), random_seed=0, device="cpu")
    tm.fit(_data(40), epochs=2, epochs_per_eval=1, batch_size=16, egm_n_iter=3,
           egm_batches_per_eval=2, verbose=0)
    return tm


def test_fit_through_k3_plain_version_equals_the_autograd_fit(tmp_path):
    """use_pallas_latent=True on the CPU drives fit's latent update through
    K3's wrapper (its plain version): one call per batch, and the same latent
    table and nets as the autograd fit from the same seed."""
    calls = []
    original = tcb.CausalBGM._build_fused_latent_vg

    def spy(self):
        vg = original(self)
        return None if vg is None else (lambda *a: calls.append(a[0].shape[0]) or vg(*a))

    tcb.CausalBGM._build_fused_latent_vg = spy
    try:
        kernel = _fit(tmp_path, use_pallas_latent=True)
        auto = _fit(tmp_path)
    finally:
        tcb.CausalBGM._build_fused_latent_vg = original
    assert calls == [16, 16, 8] * 3 and kernel.kernels["plain_grad"].launches == 0
    np.testing.assert_allclose(kernel.data_z.numpy(), auto.data_z.numpy(), rtol=1e-5, atol=1e-5)
    for k in tcb.NET_NAMES:
        _assert_tree_close(bridge.net_to_numpy(kernel.nets[k]),
                           bridge.net_to_numpy(auto.nets[k]), rtol=1e-5, atol=1e-5)
    assert kernel.best_nets is not None and kernel.swa_nets is not None


def test_save_weights_round_trips_through_jax_load_weights(tmp_path):
    """A fitted plain port model's save_weights file loads in JAX
    load_weights with every tensor exactly equal, and back into the port."""
    tm = _fit(tmp_path)
    path = tm.save_weights(str(tmp_path / "port.npz"))
    jm = jcb.CausalBGM(_params(tmp_path), random_seed=9).load_weights(path)
    for k in tcb.NET_NAMES:
        _assert_tree_close(bridge.net_to_numpy(tm.nets[k]), jm.nets[k], rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(jm.data_z), tm.data_z.numpy())
    again = tcb.CausalBGM(_params(tmp_path), random_seed=3, device="cpu").load_weights(path)
    for k in tcb.NET_NAMES:
        for a, b in zip(again.nets[k].parameters(), tm.nets[k].parameters()):
            assert torch.equal(a, b)


def test_load_weights_refuses_the_other_kind_of_net(tmp_path):
    path = _fit(tmp_path).save_weights(str(tmp_path / "plain.npz"))
    bnn = tcb.CausalBGM(_params(tmp_path, use_bnn=True), random_seed=0, device="cpu")
    with pytest.raises(ValueError, match="FlipoutMLP"):
        bnn.load_weights(path)


@pytest.fixture(scope="module")
def jax_plain(tmp_path_factory):
    """A JAX plain-net CausalBGM (random init) saved with save_weights."""
    tmp = tmp_path_factory.mktemp("jaxplain")
    model = jcb.CausalBGM(_params(tmp), random_seed=0)
    path = str(tmp / "w.npz")
    model.save_weights(path)
    return model, path


@pytest.mark.parametrize("sampler,burn_in", [("mh", 150), ("mala", 1000)])
def test_predict_matches_jax_within_monte_carlo_error(jax_plain, tmp_path, sampler, burn_in):
    """Same bridged plain weights, same data: each ADRF point within
    4 * sqrt(se_port^2 + se_jax^2), se = sd(draws) / sqrt(ESS); MH runs with
    the cached current value (one K4 evaluation per step), MALA with the
    cached value and gradient (one K3 evaluation per step).  MALA starts at
    step size 0.1 (~99 % acceptance) and grows it by 1.1x per 50 burn-in
    steps: after 150 steps its chains still drift from their random starts,
    so the spread between runs (of either package) exceeds the ESS-based
    error; after 1000 it does not."""
    jmodel, path = jax_plain
    data = _data(64)
    kw = dict(x_values=np.linspace(0, 3, 5), alpha=0.05, burn_in=burn_in, n_mcmc=300,
              q_sd=1.0, sampler=sampler, return_diagnostics=True, return_draws=True)
    adrf_j, _, diag_j, draws_j = jmodel.predict(data, **kw)
    tmodel = tcb.CausalBGM(_params(tmp_path, use_pallas_latent=True), random_seed=3,
                           device="cpu").load_weights(path)
    calls = {"plain": 0, "plain_grad": 0}
    for name in calls:
        def spy(*args, _fn=tmodel.kernels[name], _name=name):
            calls[_name] += 1
            return _fn(*args)
        tmodel.kernels[name] = spy
    adrf_t, ci_t, diag_t, draws_t = tmodel.predict(data, **kw)

    assert adrf_t.shape == adrf_j.shape == (5,) and np.all(ci_t[:, 0] <= ci_t[:, 1])
    evals = 1 + burn_in + 300
    want = {"mh": {"plain": evals, "plain_grad": 0}, "mala": {"plain": 0, "plain_grad": evals}}
    assert calls == want[sampler]
    se = lambda draws, diag: draws.std(axis=1) / np.sqrt(diag["ess"])
    bound = 4.0 * np.sqrt(se(draws_t, diag_t) ** 2 + se(draws_j, diag_j) ** 2)
    assert np.all(np.abs(adrf_t - adrf_j) <= bound), (adrf_t, adrf_j, bound)
    assert abs(diag_t["accept_rate"] - diag_j["accept_rate"]) <= 0.1


def test_mala_target_backward_is_k3_gradient(tmp_path):
    """On the kernel path the differentiable plain target is K3 under an
    autograd Function: one K3 call gives the value and, in the backward,
    -cotangent * K3's gradient; the plain target is K4's value."""
    tm = tcb.CausalBGM(_params(tmp_path, use_pallas_latent=True), random_seed=0, device="cpu")
    x, y, v = _data(12)
    seen = {}
    for name in ("plain", "plain_grad"):
        def spy(*args, _fn=tm.kernels[name], _name=name):
            seen.setdefault(_name, []).append(_fn(*args))
            return seen[_name][-1]
        tm.kernels[name] = spy
    (z,) = _t(_latents(12))
    z.requires_grad_(True)
    w = torch.linspace(-1.0, 2.0, 12)
    lp = tm._make_log_prob(x, y, v, differentiable=True)(z, None)
    (lp * w).sum().backward()
    assert len(seen["plain_grad"]) == 1
    neg, grad = seen["plain_grad"][0]
    assert torch.equal(lp.detach(), -neg)
    torch.testing.assert_close(z.grad, -w[:, None] * grad, rtol=0, atol=0)
    value = tm._make_log_prob(x, y, v)(z.detach(), None)
    assert torch.equal(value, -seen["plain"][0]) and torch.equal(value, lp.detach())
