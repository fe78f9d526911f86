"""Parity of the port's likelihood and flipout-net layer with the JAX package:
the same numpy inputs go through both, compared at the stated tolerance."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import _pk_util as jpk  # noqa: E402
from bayesgm_tpu.ops import distributions as jdist  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.ops import _pk_util as tpk  # noqa: E402
from bayesgm_torch.ops import distributions as tdist  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _dist_inputs(name, rng):
    n, d = 16, 6
    pos = lambda *s: rng.uniform(0.1, 3.0, size=s).astype(np.float32)
    nrm = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        # wide range: the overflow-safe form must hold at |x| ~ 100
        "softplus": (nrm(64) * 40.0,),
        "softplus_var": (nrm(64) * 5.0,),
        "gaussian_nll_iso": (nrm(n, d), nrm(n, d), pos(n), d),
        "gaussian_nll_diag": (nrm(n, d), nrm(n, d), pos(n, d)),
        "bernoulli_logits_nll": ((rng.uniform(size=(n, 1)) < 0.5).astype(np.float32),
                                 nrm(n, 1) * 5.0),
        "standard_normal_neg_log_prior": (nrm(n, d),),
        "conditional_gaussian_neg_log_prior": (nrm(n, d), nrm(n, d), pos(n, d)),
    }[name]


@pytest.mark.parametrize("name", [
    "softplus", "softplus_var", "gaussian_nll_iso", "gaussian_nll_diag",
    "bernoulli_logits_nll", "standard_normal_neg_log_prior",
    "conditional_gaussian_neg_log_prior"])
def test_distributions_match_jax(name):
    args = _dist_inputs(name, np.random.default_rng(0))
    jfn = jax.nn.softplus if name == "softplus" else getattr(jdist, name)
    want = np.asarray(jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(tdist, name)(*[_t(a) if isinstance(a, np.ndarray) else a for a in args])
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _jax_net(seed=0, dims=(5, 16, 8, 7)):
    """A JAX flipout MLP with non-trivial norm parameters, as numpy."""
    net = jnn.init_flipout_mlp(jax.random.PRNGKey(seed), dims[0], dims[-1], list(dims[1:-1]))
    tree = jax.tree.map(np.asarray, net)
    rng = np.random.default_rng(seed + 100)
    tree["norm"]["gamma"] = (1.0 + 0.3 * rng.normal(size=dims[0])).astype(np.float32)
    tree["norm"]["beta"] = (0.2 * rng.normal(size=dims[0])).astype(np.float32)
    for layer in tree["layers"]:
        layer["b"] = (0.1 * rng.normal(size=layer["b"].shape)).astype(np.float32)
    return tree


def test_frozen_batchnorm_matches_jax():
    tree = _jax_net()
    x = np.random.default_rng(1).normal(size=(32, 5)).astype(np.float32)
    want = np.asarray(jnn.frozen_batchnorm_apply(tree["norm"], x))
    got = tnn.frozen_batchnorm_apply(_t(tree["norm"]["gamma"]), _t(tree["norm"]["beta"]), _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flipout_dense_pre_matches_jax_with_injected_noise():
    tree = _jax_net()
    layer = tree["layers"][0]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 5)).astype(np.float32)
    eps = rng.normal(size=(5, 16)).astype(np.float32)
    r_in = rng.choice([-1.0, 1.0], size=(32, 5)).astype(np.float32)
    r_out = rng.choice([-1.0, 1.0], size=(32, 16)).astype(np.float32)
    want = np.asarray(jnn._flipout_dense_pre(layer, x, eps, r_in, r_out))
    got = tnn._flipout_dense_pre((_t(layer["loc"]), _t(layer["rho"]), _t(layer["b"])),
                                 _t(x), _t(eps), _t(r_in), _t(r_out))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flipout_mlp_mean_apply_matches_jax():
    tree = _jax_net()
    x = np.random.default_rng(3).normal(size=(32, 5)).astype(np.float32)
    want = np.asarray(jnn.flipout_mlp_mean_apply(tree, x))
    got = tnn.flipout_mlp_mean_apply(bridge.flipout_mlp_from_numpy(tree), _t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prior_scale,bias_prior_scale", [(1.0, None), (0.5, 0.3)])
def test_flipout_mlp_kl_matches_jax(prior_scale, bias_prior_scale):
    tree = _jax_net()
    want = float(jnn.flipout_mlp_kl(tree, prior_scale, bias_prior_scale))
    with torch.no_grad():
        got = float(tnn.flipout_mlp_kl(bridge.flipout_mlp_from_numpy(tree), prior_scale,
                                       bias_prior_scale))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_flatten_flipout_params_matches_jax():
    tree = _jax_net()
    want = [np.asarray(a) for a in jpk.flatten_flipout_params(tree)]
    got = tpk.flatten_flipout_params(bridge.flipout_mlp_from_numpy(tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    assert tpk.flipout_mlp_layer_dims(bridge.flipout_mlp_from_numpy(tree)) == \
        jpk.flipout_mlp_layer_dims(tree)


def test_split_flipout_flat_roundtrip():
    flat = tpk.flatten_flipout_params(tnn.FlipoutMLP(4, 3, [8, 6], torch.Generator().manual_seed(0)))
    w, sigs = tpk.split_flipout_flat(flat)
    n_layers = (len(flat) - 2) // 3
    assert len(w) == 2 + 2 * n_layers and len(sigs) == n_layers
    for i in range(n_layers):
        assert w[2 + 2 * i] is flat[2 + 3 * i]
        assert sigs[i] is flat[3 + 3 * i]
        assert w[3 + 2 * i] is flat[4 + 3 * i]


def test_flipout_step_perturbations_law():
    gen = torch.Generator().manual_seed(0)
    sigs = [torch.full((64, 32), 0.5), torch.full((32, 8), 2.0)]
    ps = tpk.flipout_step_perturbations(sigs, gen)
    assert [tuple(p.shape) for p in ps] == [(1, 64, 32), (1, 32, 8)]
    assert abs(float(ps[0].std()) - 0.5) < 0.02
    ps2 = tpk.flipout_step_perturbations(sigs, gen, n_sets=2)
    assert float((ps2[0][0] - ps2[0][1]).abs().max()) > 0.1  # independent sets
    psa = tpk.flipout_step_perturbations(sigs, gen, n_sets=2, antithetic=True)
    for p in psa:
        torch.testing.assert_close(p[1], -p[0])


def test_init_law():
    net = tnn.FlipoutMLP(64, 64, [64, 64, 64], torch.Generator().manual_seed(0))
    net.requires_grad_(False)
    loc = torch.cat([t.detach().ravel() for t in net.loc])
    rho = torch.cat([t.detach().ravel() for t in net.rho])
    assert abs(float(loc.mean())) < 0.005 and abs(float(loc.std()) - 0.1) < 0.005
    assert abs(float(rho.mean()) + 3.0) < 0.005 and abs(float(rho.std()) - 0.1) < 0.005
    assert all(float(b.abs().max()) == 0.0 for b in net.b)
    assert float(net.gamma.min()) == 1.0 and float(net.beta.abs().max()) == 0.0
    # the same seed gives the same net
    again = tnn.FlipoutMLP(64, 64, [64, 64, 64], torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(net.loc, again.loc))


def test_flipout_mlp_apply_deterministic_limit_and_batched_draws():
    tree = _jax_net()
    for layer in tree["layers"]:
        layer["rho"] = np.full_like(layer["rho"], -20.0)  # sigma ~ 2e-9
    net = bridge.flipout_mlp_from_numpy(tree)
    x = _t(np.random.default_rng(4).normal(size=(32, 5)))
    gen = torch.Generator().manual_seed(1)
    torch.testing.assert_close(tnn.flipout_mlp_apply(net, x, gen),
                               tnn.flipout_mlp_mean_apply(net, x), rtol=1e-5, atol=1e-5)
    # leading axes: each leading index gets its own eps draw
    eps, r_in, r_out = tnn._fused_flipout_draws(net.layers(), (3, 32, 5), gen)
    assert tuple(eps[0].shape) == (3, 5, 16) and tuple(r_in[0].shape) == (3, 32, 5)
    assert tuple(r_out[-1].shape) == (3, 32, 7)
    assert float((eps[0][0] - eps[0][1]).abs().max()) > 0.1
    out = tnn.flipout_mlp_apply(net, x.expand(3, 32, 5), gen)
    assert tuple(out.shape) == (3, 32, 7)


def test_bridge_nets_from_numpy_keeps_flipout_nets_only():
    """Flipout nets, the critic and plain MLPs come across, each as its own
    kind (the port builds all three); an entry of no net's shape is left
    out."""
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    tree = {"g": jax.tree.map(np.asarray, jnn.init_flipout_mlp(keys[0], 4, 7, [8])),
            "dz": jax.tree.map(np.asarray, jnn.init_critic(keys[1], 4, [8])),
            "plain": jax.tree.map(np.asarray, jnn.init_mlp(keys[2], 4, 2, [8])),
            "other": {"layers": [{"kernel": np.zeros((4, 2), np.float32)}]}}
    nets = bridge.nets_from_numpy(tree)
    assert set(nets) == {"g", "dz", "plain"}
    assert isinstance(nets["dz"], tnn.Critic) and nets["dz"].dims == [4, 8, 1]
    assert isinstance(nets["plain"], tnn.MLP) and nets["plain"].dims == [4, 8, 2]
    for name in ("dz", "plain"):
        assert bridge.nets_to_numpy({name: nets[name]})[name].keys() == tree[name].keys()
    g = nets["g"]
    assert g.dims == [4, 8, 7]
    for i, layer in enumerate(tree["g"]["layers"]):
        for name in ("loc", "rho", "b"):
            np.testing.assert_array_equal(getattr(g, name)[i].detach().numpy(), layer[name])


@pytest.mark.parametrize("key", ["['nets']['g'", "nets.g", "['a'][x]", ""])
def test_bridge_rejects_malformed_keys(key):
    with pytest.raises(ValueError):
        bridge._parse_key(key)
