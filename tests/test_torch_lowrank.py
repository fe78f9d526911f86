"""The port's low-rank variational heads against the JAX package's
(``bayesgm_tpu/ops/nn.py`` ``lowrank_*`` and ``flipout_lowrank_*``): both
applies on bridged weights (the flipout one under the shared flipout
stream), the reparameterisation with replayed draws, Woodbury and
Sylvester against the dense inverse and ``slogdet``, the KL, the transfer
from a flipout twin and the bridge both ways."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402

from _torch_parity import FlipoutDraws  # noqa: E402

# f32 forward of a 3-layer net, summed in another order than XLA's
APPLY_TOL = dict(rtol=1e-5, atol=1e-6)
# f64 Woodbury / Sylvester against a dense f64 inverse and slogdet
DENSE_TOL = dict(rtol=1e-10, atol=1e-12)


def _jax_net(flipout, rank=2, seed=3):
    init = jnn.init_flipout_lowrank_variational_mlp if flipout else jnn.init_lowrank_variational_mlp
    params, _, meta = init(jax.random.PRNGKey(seed), 3, 5, [16, 16], rank=rank)
    rng = np.random.default_rng(seed)
    # a non-trivial input norm, so the frozen affine is exercised
    params["norm"] = {"gamma": jnp.asarray(rng.uniform(0.5, 1.5, 3), jnp.float32),
                      "beta": jnp.asarray(rng.normal(size=3), jnp.float32)}
    return params, meta


@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("flipout", [False, True], ids=["plain", "flipout"])
def test_lowrank_apply_matches_jax(monkeypatch, flipout, rank):
    """Mean, diagonal variance and U on bridged weights; the flipout net
    takes one fused draw over ``[*hidden, mean, var, lowrank]``."""
    draws = FlipoutDraws(monkeypatch)
    jp, meta = _jax_net(flipout, rank)
    net = bridge.net_from_numpy(jax.tree.map(np.asarray, jp))
    assert type(net) is (tnn.FlipoutLowRankVariationalMLP if flipout
                         else tnn.LowRankVariationalMLP)
    assert net.rank == rank and net.dims == [3, 16, 16, 5]
    x = np.random.default_rng(0).normal(1.0, 2.0, size=(12, 3)).astype(np.float32)
    if flipout:
        jm, jv, ju, _ = jnn.flipout_lowrank_variational_mlp_apply(
            jp, jnp.asarray(x), jax.random.PRNGKey(0), meta)
        tm, tv, tu, _ = tnn.flipout_lowrank_variational_mlp_apply(net, torch.as_tensor(x), None)
        assert draws.jax_calls == draws.port_calls == 1
    else:
        jm, jv, ju, _ = jnn.lowrank_variational_mlp_apply(jp, jnp.asarray(x), meta)
        tm, tv, tu, _ = tnn.lowrank_variational_mlp_apply(net, torch.as_tensor(x))
    assert tuple(tu.shape) == (12, 5, rank)
    for got, want in ((tm, jm), (tv, jv), (tu, ju)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **APPLY_TOL)


def test_flipout_lowrank_kl_matches_jax():
    jp, _ = _jax_net(True)
    net = bridge.net_from_numpy(jax.tree.map(np.asarray, jp))
    np.testing.assert_allclose(float(tnn.flipout_lowrank_variational_mlp_kl(net).detach()),
                               float(jnn.flipout_lowrank_variational_mlp_kl(jp)), rtol=1e-5)


def test_lowrank_reparameterize_draws_eps1_then_eps2():
    """``mean + sqrt(D) eps1 + U eps2`` with eps1 ``(b, p)`` drawn before
    eps2 ``(b, r)``: the same formula as JAX's, on the replayed draws."""
    rng = np.random.default_rng(1)
    mean = torch.as_tensor(rng.normal(size=(6, 4)), dtype=torch.float32)
    var = torch.as_tensor(rng.uniform(0.1, 2.0, size=(6, 4)), dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=(6, 4, 2)), dtype=torch.float32)
    got = tnn.lowrank_reparameterize(mean, var, u, torch.Generator().manual_seed(5))
    replay = torch.Generator().manual_seed(5)
    eps1, eps2 = torch.randn((6, 4), generator=replay), torch.randn((6, 2), generator=replay)
    want = (mean.numpy() + np.sqrt(var.numpy()) * eps1.numpy()
            + np.einsum("bpr,br->bp", u.numpy(), eps2.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p,rank", [(4, 1), (7, 2), (100, 2)])
def test_woodbury_and_sylvester_against_dense(p, rank):
    """Against the dense f64 Sigma's inverse and slogdet, and against JAX's
    functions in f32."""
    rng = np.random.default_rng(p)
    var = rng.uniform(0.2, 2.0, size=(3, p))
    u = rng.normal(size=(3, p, rank))
    dense = np.stack([np.diag(var[i]) + u[i] @ u[i].T for i in range(3)])
    inv = tnn.lowrank_covariance_inverse(torch.as_tensor(var), torch.as_tensor(u)).numpy()
    logdet = tnn.lowrank_log_det(torch.as_tensor(var), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(inv, np.linalg.inv(dense), **DENSE_TOL)
    np.testing.assert_allclose(logdet, np.linalg.slogdet(dense)[1], **DENSE_TOL)
    np.testing.assert_allclose(inv @ dense, np.broadcast_to(np.eye(p), dense.shape), atol=1e-10)
    var32, u32 = var.astype(np.float32), u.astype(np.float32)
    np.testing.assert_allclose(
        tnn.lowrank_covariance_inverse(torch.as_tensor(var32), torch.as_tensor(u32)).numpy(),
        np.asarray(jnn.lowrank_covariance_inverse(jnp.asarray(var32), jnp.asarray(u32))),
        rtol=1e-4, atol=1e-5)  # f32 inverse of a 2 x 2 capacitance, ~1e-6 relative apart
    np.testing.assert_allclose(
        tnn.lowrank_log_det(torch.as_tensor(var32), torch.as_tensor(u32)).numpy(),
        np.asarray(jnn.lowrank_log_det(jnp.asarray(var32), jnp.asarray(u32))), rtol=1e-5)


def test_transfer_from_flipout_mean_matches_jax():
    """The posterior-mean transfer equals JAX's on bridged weights; a drawn
    transfer moves every kernel by ``softplus(rho) eps`` and keeps the
    biases and the norm."""
    jp, meta = _jax_net(True)
    flip = bridge.net_from_numpy(jax.tree.map(np.asarray, jp))
    det = tnn.lowrank_transfer_from_flipout(flip)
    assert type(det) is tnn.LowRankVariationalMLP and det.rank == flip.rank
    want = jax.tree.map(np.asarray, jnn.lowrank_transfer_from_flipout(jp))
    got = bridge.net_to_numpy(det)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    x = np.random.default_rng(2).normal(size=(8, 3)).astype(np.float32)
    for g, j in zip(tnn.lowrank_variational_mlp_apply(det, torch.as_tensor(x))[:3],
                    jnn.lowrank_variational_mlp_apply(want, jnp.asarray(x), meta)[:3]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(j), **APPLY_TOL)

    drawn = tnn.lowrank_transfer_from_flipout(flip, torch.Generator().manual_seed(0))
    replay = torch.Generator().manual_seed(0)
    kernels = [drawn.w[0], drawn.w[1], drawn.mean_w, drawn.var_w, drawn.lowrank_w]
    for kernel, (loc, rho, _) in zip(kernels, flip.layers()):
        eps = torch.randn(loc.shape, generator=replay)
        np.testing.assert_allclose(kernel.detach().numpy(),
                                   (loc + tnn.softplus(rho) * eps).detach().numpy(), rtol=1e-6)
    np.testing.assert_array_equal(drawn.lowrank_b.detach().numpy(), jp["lowrank"]["b"])
    np.testing.assert_array_equal(drawn.gamma.detach().numpy(), jp["norm"]["gamma"])


@pytest.mark.parametrize("flipout", [False, True], ids=["plain", "flipout"])
def test_bridge_round_trip(tmp_path, flipout):
    """JAX tree -> port net -> JAX tree is the identity, and ``save_npz`` /
    ``load_npz`` carry the net under JAX's keys."""
    jp, _ = _jax_net(flipout)
    tree = jax.tree.map(np.asarray, jp)
    net = bridge.net_from_numpy(tree)
    back = bridge.net_to_numpy(net)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    path = bridge.save_npz(str(tmp_path / "w.npz"), {"lr": net})
    with np.load(path) as f:
        assert "['nets']['lr']['lowrank']['b']" in f.files
    loaded = bridge.load_npz(path)["nets"]["lr"]
    assert type(loaded) is type(net) and loaded.rank == net.rank
    for a, b in zip(loaded.parameters(), net.parameters()):
        assert torch.equal(a, b)
