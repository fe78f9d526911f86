"""The plain MLP (``use_bnn=False``) against the JAX package: the net, its
bridge and flattening, and K4 and K3 (the plain-MLP log-posterior and its
z-gradient): the port's plain versions against the JAX kernels in interpret
mode, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.models import causalbgm as jcb  # noqa: E402
from bayesgm_tpu.ops import _pk_plain as jk  # noqa: E402
from bayesgm_tpu.ops import _pk_util as jpk  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from bayesgm_torch.ops import _pk_plain as tk  # noqa: E402
from bayesgm_torch.ops import _pk_util as tpk  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(2)

# f32 dots 5 to 16 wide and the 6-column v sum, in another order than XLA's
TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = {"continuous": {}, "binary": dict(binary_treatment=True),
            "fixed_sigma_v": dict(sigma_v=0.5),
            "fixed_sigmas": dict(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3)}


def _cfgs(**kw):
    base = dict(v_dim=6, z_dims=(1, 1, 1, 2), binary_treatment=False, use_bnn=False,
                kl_weight=1e-4, sigma_v=None, sigma_x=None, sigma_y=None, use_z_rec=1.0,
                lr=2e-4, lr_theta=1e-4, lr_z=1e-4, g_d_freq=5)
    base.update(kw)
    return jcb.CBGMConfig(**base), tcb.CBGMConfig(**base)


def _jax_nets(cfg):
    keys = jax.random.split(jax.random.PRNGKey(21), 3)
    d0, d1, d2, _ = cfg.z_dims
    nets = {"g": jnn.init_mlp(keys[0], sum(cfg.z_dims), cfg.v_dim + 1, [16, 16]),
            "h": jnn.init_mlp(keys[1], d0 + d2, 2, [8]),
            "f": jnn.init_mlp(keys[2], d0 + d1 + 1, 2, [8])}
    nets = jax.tree.map(np.asarray, nets)
    for net in nets.values():  # non-zero biases, so the bias path is exercised
        for i, layer in enumerate(net["layers"]):
            layer["b"] = (0.1 * (i + 1) * np.cos(np.arange(layer["b"].size))).astype(np.float32)
    return nets


def _data(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, sum(cfg.z_dims))).astype(np.float32)
    x = ((rng.uniform(size=(n, 1)) < 0.5) if cfg.binary_treatment
         else rng.normal(size=(n, 1))).astype(np.float32)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    v = rng.normal(size=(n, cfg.v_dim)).astype(np.float32)
    return z, x, y, v


def _t(*arrays):
    return tuple(torch.as_tensor(np.array(a, np.float32)) for a in arrays)


def _flats(nets):
    """(jax flats, port flats, dims) of g, h and f."""
    j = [jpk.flatten_mlp_params(nets[k]) for k in "ghf"]
    port = [tpk.flatten_mlp_params(bridge.mlp_from_numpy(nets[k])) for k in "ghf"]
    return j, port, [jpk.mlp_layer_dims(nets[k]) for k in "ghf"]


def test_mlp_apply_matches_jax():
    jnet = jax.tree.map(np.asarray, jnn.init_mlp(jax.random.PRNGKey(3), 5, 7, [16, 8]))
    tnet = bridge.mlp_from_numpy(jnet)
    x = np.random.default_rng(0).normal(size=(13, 5)).astype(np.float32)
    want = np.asarray(jnn.mlp_apply(jnet, jnp.asarray(x)))
    got = tnn.mlp_apply(tnet, *_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tnet(*_t(x)).detach().numpy(), got)
    assert tnet.dims == jpk.mlp_layer_dims(jnet) == [5, 16, 8, 7]


def test_mlp_init_is_glorot_uniform_with_zero_bias():
    net = tnn.MLP(40, 20, [60], torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (40 + 60))
    w = net.w[0].detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit
    assert abs(w.mean()) < 0.02 * limit and abs(w.std() - limit / np.sqrt(3)) < 0.05 * limit
    assert all(not b.detach().any() for b in net.b)
    assert net.dims == [40, 60, 20] and len(list(net.parameters())) == 4


def test_flatten_mlp_params_matches_jax():
    nets = _jax_nets(_cfgs()[0])
    jflat, tflat, dims = _flats(nets)
    for j, t, k in zip(jflat, tflat, "ghf"):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert tpk.mlp_layer_dims(bridge.mlp_from_numpy(nets[k])) == dims["ghf".index(k)]


def test_bridge_round_trips_a_plain_net():
    jnet = jax.tree.map(np.asarray, jnn.init_mlp(jax.random.PRNGKey(4), 3, 2, [8, 4]))
    back = bridge.net_to_numpy(bridge.mlp_from_numpy(jnet))
    assert jax.tree.structure(back) == jax.tree.structure(jnet)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnet)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant,n", [("continuous", 32), ("continuous", 37),
                                       ("binary", 37), ("fixed_sigma_v", 37),
                                       ("fixed_sigmas", 37)])
def test_k4_plain_matches_jax_kernel_interpret(variant, n):
    """K4's plain version against the JAX K4 in interpret mode with 16-row
    blocks (n = 37 leaves a ragged last block)."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    nets = _jax_nets(jcfg)
    z, x, y, v = _data(jcfg, n)
    jflat, tflat, dims = _flats(nets)
    fused = jk.make_fused_causal_logp(jcfg, *dims, block_rows=16, interpret=True)
    want = np.asarray(fused(z, x, y, v, *jflat))
    got = tk.logp_plain(tcfg, *_t(z, x, y, v), *tflat).numpy()
    assert got.shape == (n,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_k3_plain_matches_jax_kernel_interpret(variant):
    """K3's plain version (autograd of K4's) against the JAX K3 in interpret
    mode: values and z-gradients, with a ragged last block."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    nets = _jax_nets(jcfg)
    n = 37
    z, x, y, v = _data(jcfg, n, seed=1)
    jflat, tflat, dims = _flats(nets)
    fused = jk.make_fused_causal_logp_and_grad(jcfg, *dims, block_rows=16, interpret=True)
    want_neg, want_grad = (np.asarray(a) for a in fused(z, x, y, v, *jflat))
    neg, grad = tk.logp_and_grad_plain(tcfg, *_t(z, x, y, v), *tflat)
    np.testing.assert_allclose(neg.numpy(), want_neg, **TOL)
    np.testing.assert_allclose(grad.numpy(), want_grad, **TOL)
    assert not neg.requires_grad and not grad.requires_grad


def test_k4_plain_equals_the_model_composite():
    """K4's plain version is the model's own negative log-posterior for
    plain nets (which takes no randomness)."""
    _, tcfg = _cfgs()
    nets = {k: bridge.mlp_from_numpy(net) for k, net in _jax_nets(_cfgs()[0]).items()}
    z, x, y, v = _t(*_data(tcfg, 20))
    want = tcb._neg_log_posterior_rows(tcfg, nets, z, x, y, v, None)
    got = tk.logp_plain(tcfg, z, x, y, v, *(tpk.flatten_mlp_params(nets[k]) for k in "ghf"))
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-5)


def test_k3_gradient_matches_finite_differences():
    _, tcfg = _cfgs()
    nets = _jax_nets(_cfgs()[0])
    _, tflat, _ = _flats(nets)
    z, x, y, v = (a.double() for a in _t(*_data(tcfg, 5, seed=2)))
    flat64 = [[t.double() for t in f] for f in tflat]
    _, grad = tk.logp_and_grad_plain(tcfg, z, x, y, v, *flat64)
    h = 1e-6
    for k in range(z.shape[1]):
        dz = torch.zeros_like(z)
        dz[:, k] = h
        fd = (tk.logp_plain(tcfg, z + dz, x, y, v, *flat64)
              - tk.logp_plain(tcfg, z - dz, x, y, v, *flat64)) / (2 * h)
        torch.testing.assert_close(grad[:, k], fd, rtol=1e-6, atol=1e-6)


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    jcfg, tcfg = _cfgs()
    _, tflat, dims = _flats(_jax_nets(jcfg))
    args = (*_t(*_data(tcfg, 9)), *tflat)
    k4 = tk.make_fused_causal_logp(tcfg, *dims)
    k3 = tk.make_fused_causal_logp_and_grad(tcfg, *dims)
    assert torch.equal(k4(*args), tk.logp_plain(tcfg, *args))
    neg, grad = k3(*args)
    want_neg, want_grad = tk.logp_and_grad_plain(tcfg, *args)
    assert torch.equal(neg, want_neg) and torch.equal(grad, want_grad)
    assert k4.launches == k3.launches == 0


def test_wrappers_refuse_other_devices():
    jcfg, tcfg = _cfgs()
    _, tflat, dims = _flats(_jax_nets(jcfg))
    meta = [t.to("meta") for t in _t(*_data(tcfg, 4))]
    for fn in (tk.make_fused_causal_logp(tcfg, *dims),
               tk.make_fused_causal_logp_and_grad(tcfg, *dims)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*meta, *tflat)
