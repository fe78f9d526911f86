"""The port's MNISTBGM against the JAX package's: the loss terms, the
training step and one EGM iteration (a critic step and a generator step, at
gamma 0 and 10) with the same injected draws, also through
``MNISTBGM.egm_init`` on NHWC images, and consecutive EGM iterations and
training steps at the shipped widths; both forms of the log posterior; the
entry points' convolutions in f32; the lifecycle, exact resume and a JAX
checkpoint's nets restored in ``__init__``; JAX's ``save_weights`` fault
and the port's file; the refusals; the inpainting masks and the images.
(The HMC step and predict are in ``test_torch_mnist_hmc.py``.)

The functions take nets of any width, so they are held against JAX at
filters 4 (encoder, generator) and 8 (critic); the model classes fix 32 and
64, which the lifecycle and the resume run as shipped on 16-32 images, and
which the parity tests of the classes cut (both packages' nets replaced by
the same narrow ones)."""

import importlib.util
import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.models import mnist as jmn  # noqa: E402
from bayesgm_tpu.ops import conv as jconv  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_tpu.ops import optim as joptim  # noqa: E402
from bayesgm_tpu.utils import checkpoint as jckpt  # noqa: E402
from bayesgm_tpu.utils import helpers as jhelpers  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.datasets import images as timages  # noqa: E402
from bayesgm_torch.models import bgm as tbgm  # noqa: E402
from bayesgm_torch.models import mnist as tmn  # noqa: E402
from bayesgm_torch.ops import conv as tconv  # noqa: E402
from bayesgm_torch.ops import optim as toptim  # noqa: E402
from bayesgm_torch.utils import helpers as thelpers  # noqa: E402

from test_torch_conv import (  # noqa: E402
    Queue,
    assert_tree_close,
    dropout_masks,
    generator_flipout_draws,
    jax_tree,
    nchw,
    patch_jax_draws,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z_DIM = 3
SMALL = dict(gen=4, enc=4, disc=8)  # the narrow nets' filters
# f32 forward and backward through the conv nets, in another order than XLA's
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
# one or two Adam steps (b2 0.99 / 0.9: the first update is ~lr * sign(grad),
# so a rounding difference in a tiny gradient moves a weight by up to ~lr * 1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def assert_grads_close(port_tree, jax_tree):
    """Gradient trees within rtol 1e-4 and an atol of 1e-5 times the
    leaf's largest JAX gradient (at least 1): the Bernoulli loss sums 784
    pixels per image, so its gradients reach O(10), and f32 rounding is
    relative to that scale."""
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree)
    assert len(flat_p) == len(flat_j)
    for path, got in flat_p:
        want = np.asarray(flat_j[path])
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                   err_msg=jax.tree_util.keystr(path))


def _cfgs(use_bnn=False, **kw):
    """The same config for both packages."""
    p = dict(z_dim=Z_DIM, use_bnn=use_bnn, kl_weight=1e-4, lr=0.01, lr_theta=0.01, lr_z=0.02,
             gamma=0.0, alpha=0.1, g_d_freq=1)
    p.update(kw)
    return jmn.MNISTConfig(**p), tmn.MNISTConfig(**p)


def _small_trees(use_bnn, seed=0):
    """The four nets' JAX trees at the narrow widths (numpy)."""
    return {
        "g": jax_tree(jconv.init_mnist_generator, seed, z_dim=Z_DIM, filters=SMALL["gen"],
                      use_bnn=use_bnn),
        "e": jax_tree(jconv.init_mnist_encoder, seed + 1, z_dim=Z_DIM, filters=SMALL["enc"]),
        "dz": jax_tree(jnn.init_critic, seed + 2, input_dim=Z_DIM, hidden=[8]),
        "dx": jax_tree(jconv.init_mnist_discriminator, seed + 3, filters=SMALL["disc"]),
    }


def _images(n, seed=0):
    return (np.random.RandomState(seed).rand(n, 28, 28, 1) > 0.5).astype("float32")


def _gen_draws(g_tree, n, rng, use_bnn):
    """One generator pass's draws: ``(jax_normals, jax_signs, port
    GenDraws)``; JAX takes the flipout layers' eps, then the logits'
    reparameterisation noise."""
    normals, signs, flip = generator_flipout_draws(g_tree, n, rng) if use_bnn else ([], [], None)
    rep = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    return normals + [rep], signs, tmn.GenDraws(flip, nchw(rep))


def _port_net(tree):
    return bridge.net_from_numpy(tree)


# ---------------------------------------------------------------------------
# loss terms and the training step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_losses_match_jax(monkeypatch, use_bnn):
    """``_g_loss`` (Bernoulli NLL, pixel MSE, the KL term) with its
    gradients in g, and ``_latent_loss`` with its gradient in z."""
    jcfg, tcfg = _cfgs(use_bnn)
    rng = np.random.default_rng(1)
    n = 6
    g_tree = _small_trees(use_bnn)["g"]
    g = _port_net(g_tree)
    z, x = rng.normal(size=(n, Z_DIM)).astype(np.float32), _images(n, 1)
    d1, d2 = _gen_draws(g_tree, n, rng, use_bnn), _gen_draws(g_tree, n, rng, use_bnn)
    with monkeypatch.context() as mp:
        patch_jax_draws(mp, normals=d1[0] + d2[0], signs=d1[1] + d2[1])
        (jl, jmse), jg = jax.jit(jax.value_and_grad(
            lambda p: jmn._g_loss(jcfg, p, jnp.asarray(z), jnp.asarray(x), jax.random.PRNGKey(0)),
            has_aux=True))(g_tree)
        jpost, jgz = jax.jit(jax.value_and_grad(
            lambda zz: jmn._latent_loss(jcfg, g_tree, zz, jnp.asarray(x), jax.random.PRNGKey(1))))(
            jnp.asarray(z))
    tl, tmse = tmn._g_loss(tcfg, g, torch.as_tensor(z), nchw(x), d1[2])
    tg = torch.autograd.grad(tl, list(g.parameters()))
    zt = torch.as_tensor(z).requires_grad_(True)
    tpost = tmn._latent_loss(tcfg, g, zt, nchw(x), d2[2])
    (tgz,) = torch.autograd.grad(tpost, zt)
    for got, want in ((tl, jl), (tmse, jmse), (tpost, jpost)):
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    assert_grads_close(bridge.params_to_tree(g, tg), jg)
    assert_grads_close({"z": tgz.numpy()}, {"z": jgz})


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_train_batch_step_matches_jax(monkeypatch, use_bnn):
    """Two steps of the iterative phase (the second with Adam moments and a
    repeated-free reversed index): g, the latent table and the losses."""
    jcfg, tcfg = _cfgs(use_bnn)
    rng = np.random.default_rng(2)
    n, bs = 20, 8
    g_tree = _small_trees(use_bnn)["g"]
    g = _port_net(g_tree)
    data = _images(n, 2)
    z0 = rng.normal(size=(n, Z_DIM)).astype(np.float32)
    idxs = [np.arange(0, bs), np.arange(10, 10 + bs)[::-1].copy()]
    draws = [[_gen_draws(g_tree, bs, rng, use_bnn) for _ in range(2)] for _ in idxs]

    carry = (jax.tree.map(jnp.asarray, g_tree), joptim.adam_init(g_tree), jnp.asarray(z0),
             joptim.table_adam_init(jnp.asarray(z0)))
    step = jax.jit(partial(jmn._train_batch_step, jcfg, lr_scale=0.5))
    z_table = torch.as_tensor(z0.copy())
    opt_g, z_opt = toptim.adam_init(g.parameters()), toptim.table_adam_init(z_table)
    for idx, (d1, d2) in zip(idxs, draws):
        with monkeypatch.context() as mp:
            patch_jax_draws(mp, normals=d1[0] + d2[0], signs=d1[1] + d2[1])
            mp.setattr(tmn, "_gen_draws", Queue([d1[2], d2[2]]))
            carry, jl = step(carry, jnp.asarray(idx), jax.random.PRNGKey(0),
                             data_x=jnp.asarray(data))
            step = jax.jit(partial(jmn._train_batch_step, jcfg, lr_scale=0.5))  # retrace: new draws
            opt_g, z_opt, tl = tmn._train_batch_step(tcfg, g, opt_g, z_table, z_opt,
                                                     torch.as_tensor(idx), None, nchw(data), 0.5)
        for k in ("loss_x", "loss_mse_x", "loss_postrior_z"):
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), err_msg=k, **LOSS_TOL)
    jg, _, jz, _ = carry
    assert_tree_close(bridge.net_to_numpy(g), jg, **STEP_TOL)
    np.testing.assert_allclose(z_table.numpy(), np.asarray(jz), **STEP_TOL)


# ---------------------------------------------------------------------------
# EGM
# ---------------------------------------------------------------------------


def _egm_draws(trees, use_bnn, gamma, n, bs, rng, z_dim=Z_DIM):
    """The draws of one EGM iteration (g_d_freq 1) over ``n`` images at
    batch ``bs``: keyword arguments of :func:`patch_jax_draws`, and a
    function that queues the same draws on the port's side and returns the
    queues (which the iteration must empty)."""
    idx_d, idx_g = rng.integers(0, n, bs), rng.integers(0, n, bs)
    z_d, z_g = (rng.normal(size=(bs, z_dim)).astype(np.float32) for _ in range(2))
    eps_z, eps_x = 0.3, 0.8
    gd, g1, g2 = (_gen_draws(trees["g"], bs, rng, use_bnn) for _ in range(3))
    masks = [dropout_masks(trees["dx"], bs, rng) for _ in range(4)]  # x_fake, x, penalty; gen
    jax_draws = dict(normals=[z_d, *gd[0], z_g, *g1[0], *g2[0]], signs=gd[1] + g1[1] + g2[1],
                     uniforms=[eps_z, eps_x], masks=[m for j, _ in masks for m in j],
                     randints=[idx_d, idx_g])

    def patch_port(mp):
        t = torch.as_tensor
        port_masks = [m for _, p in (masks if gamma else masks[:2] + masks[3:]) for m in p]
        queues = [Queue([(t(idx_d), t(z_d)), (t(idx_g), t(z_g))]),
                  Queue([gd[2], g1[2], g2[2]]), Queue(port_masks)]
        mp.setattr(tbgm, "_egm_batch", queues[0])
        mp.setattr(tmn, "_interp_weights", lambda g, d: (t(eps_z), t(eps_x)))
        mp.setattr(tmn, "_gen_draws", queues[1])
        mp.setattr(tconv, "_dropout_mask", queues[2])
        return queues
    return jax_draws, patch_port


def _capture(record, update):
    """``update`` (an Adam step) that first records its gradients."""
    def adam_update(grads, *a, **k):
        record.append(grads)
        return update(grads, *a, **k)
    return adam_update


def _jax_egm_iteration(monkeypatch, jcfg, trees, data, bs, jax_draws):
    """JAX's ``_egm_iter`` on NHWC ``data`` under ``jax_draws``: ``(nets
    after it, losses, the gradients of its two Adam steps)``."""
    def jax_iter(carry, key, data_x):  # returns the traced gradients beside the result
        j_grads = []
        with monkeypatch.context() as mp:
            mp.setattr(joptim, "adam_update", _capture(j_grads, joptim.adam_update))
            return jmn._egm_iter(jcfg, carry, key, data_x, bs), j_grads

    with monkeypatch.context() as mp:
        patch_jax_draws(mp, **jax_draws)
        carry = (jax.tree.map(jnp.asarray, trees),
                 joptim.adam_init({"dz": trees["dz"], "dx": trees["dx"]}),
                 joptim.adam_init({"g": trees["g"], "e": trees["e"]}))
        ((jnets, _, _), jl), j_grads = jax.jit(jax_iter)(carry, jax.random.PRNGKey(0),
                                                         jnp.asarray(data))
    return jnets, jl, j_grads


def _assert_egm_iteration_close(nets, tl, t_grads, jnets, jl, j_grads, lr):
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), err_msg=k, rtol=1e-5, atol=1e-6)
    for names, got, want in zip((("dz", "dx"), ("g", "e")), t_grads, j_grads):
        assert_grads_close(bridge.params_to_tree({k: nets[k] for k in names}, got), want)
    j_grads = {**j_grads[0], **j_grads[1]}
    for k in tbgm.NET_NAMES:
        assert_adam_step_close(bridge.net_to_numpy(nets[k]), jnets[k], j_grads[k], lr)


@pytest.mark.parametrize("gamma,use_bnn", [(0.0, False), (10.0, False), (10.0, True)],
                         ids=["gamma0-plain", "gamma10-plain", "gamma10-flipout"])
def test_egm_iter_matches_jax(monkeypatch, gamma, use_bnn):
    """One EGM iteration (a critic step with the critic's dropout on, and at
    gamma 10 both gradient penalties; then a generator step with two
    generator passes and a dropout critic pass), with the same batches,
    interpolation weights, generator draws and dropout masks on both sides:
    the losses and the four nets after it."""
    jcfg, tcfg = _cfgs(use_bnn, gamma=gamma)
    rng = np.random.default_rng(4)
    n, bs = 24, 6
    trees = _small_trees(use_bnn, seed=4)
    nets = {k: _port_net(t) for k, t in trees.items()}
    data = _images(n, 4)
    jax_draws, patch_port = _egm_draws(trees, use_bnn, gamma, n, bs, rng)
    jnets, jl, j_grads = _jax_egm_iteration(monkeypatch, jcfg, trees, data, bs, jax_draws)
    queues = patch_port(monkeypatch)
    t_grads = []
    monkeypatch.setattr(toptim, "adam_update", _capture(t_grads, toptim.adam_update))
    opt_d = toptim.adam_init(tbgm._params(nets, ("dz", "dx")))
    opt_ge = toptim.adam_init(tbgm._params(nets, ("g", "e")))
    # a generator switches the critic's dropout on; every draw comes from the queues
    _, _, tl = tbgm._egm_iter(tcfg, nets, opt_d, opt_ge, nchw(data), torch.Generator(), bs,
                              disc_step=tmn._egm_disc_step, gen_step=tmn._egm_gen_step)
    assert not any(q.items for q in queues)
    _assert_egm_iteration_close(nets, tl, t_grads, jnets, jl, j_grads, jcfg.lr)


SHIPPED = dict(z_dim=10, use_bnn=False, kl_weight=5e-5, lr=1e-3, lr_theta=5e-3, lr_z=5e-3,
               gamma=0.0, alpha=0.0, g_d_freq=1)  # the defaults the mnist_inpaint recipe runs


def _shipped_trees(seed):
    """The four nets' JAX trees at the shipped widths (numpy)."""
    return {
        "g": jax_tree(jconv.init_mnist_generator, seed, z_dim=10, filters=tmn.GEN_FILTERS),
        "e": jax_tree(jconv.init_mnist_encoder, seed + 1, z_dim=10, filters=tmn.ENC_FILTERS),
        "dz": jax_tree(jnn.init_critic, seed + 2, input_dim=10,
                       hidden=tbgm.DEFAULTS["dz_units"]),
        "dx": jax_tree(jconv.init_mnist_discriminator, seed + 3, filters=tmn.DISC_FILTERS),
    }


def assert_nets_close_after_steps(port_tree, jax_tree, n_steps, lr):
    """Nets after ``n_steps`` Adam steps: every weight within STEP_TOL of
    JAX's but at most 0.1 % of a net's, and those within ``2 lr`` per step
    (see :func:`assert_adam_step_close`: a rounding difference in a
    gradient near zero moves a weight by up to lr)."""
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    off = total = 0
    for path, got in jax.tree_util.tree_leaves_with_path(port_tree):
        want = np.asarray(flat_j[path])
        bad = ~np.isclose(got, want, **STEP_TOL)
        assert np.all(np.abs(got - want) <= 2 * lr * n_steps), jax.tree_util.keystr(path)
        off, total = off + int(bad.sum()), total + bad.size
    assert off <= 1e-3 * total, (off, total)


def test_consecutive_steps_match_jax_at_the_shipped_widths(monkeypatch):
    """The fit's two phases over several steps at the shipped widths
    (filters 32 / 64, z_dim 10, the default critic and rates): two EGM
    iterations, each from the state the one before left (nets, Adam moments
    and step counts), then ``e(x)`` as the latent table and three training
    steps, each carrying the Adam moments and the table: the four nets
    after the EGM, the table, then the losses, g and the table after each
    step, all under the same injected draws."""
    jcfg, tcfg = jmn.MNISTConfig(**SHIPPED), tmn.MNISTConfig(**SHIPPED)
    rng = np.random.default_rng(11)
    n, bs = 8, 4
    trees = _shipped_trees(11)
    data = timages.make_ellipse_images(n, seed=11)
    nets = {k: _port_net(t) for k, t in trees.items()}
    opt_d = toptim.adam_init(tbgm._params(nets, ("dz", "dx")))
    opt_ge = toptim.adam_init(tbgm._params(nets, ("g", "e")))
    carry = (jax.tree.map(jnp.asarray, trees),
             joptim.adam_init({"dz": trees["dz"], "dx": trees["dx"]}),
             joptim.adam_init({"g": trees["g"], "e": trees["e"]}))
    for _ in range(2):
        jax_draws, patch_port = _egm_draws(trees, False, 0.0, n, bs, rng, z_dim=10)
        with monkeypatch.context() as mp:
            patch_jax_draws(mp, **jax_draws)
            carry, _ = jax.jit(lambda c, d: jmn._egm_iter(jcfg, c, jax.random.PRNGKey(0), d, bs))(
                carry, jnp.asarray(data))
        with monkeypatch.context() as mp:
            queues = patch_port(mp)
            opt_d, opt_ge, _ = tbgm._egm_iter(tcfg, nets, opt_d, opt_ge, nchw(data),
                                              torch.Generator(), bs,
                                              disc_step=tmn._egm_disc_step,
                                              gen_step=tmn._egm_gen_step)
        assert not any(q.items for q in queues)
    jnets = carry[0]
    assert_nets_close_after_steps(bridge.nets_to_numpy(nets), jnets, 2, jcfg.lr)

    jz = jconv.mnist_encoder_apply(jnets["e"], jnp.asarray(data))
    with torch.no_grad():
        z_table = tconv.mnist_encoder_apply(nets["e"], nchw(data))
    np.testing.assert_allclose(z_table.numpy(), np.asarray(jz), rtol=1e-3, atol=1e-4)
    z_table = torch.as_tensor(np.array(jz))  # the same start for the steps
    g = nets["g"]
    jcarry = (jnets["g"], joptim.adam_init(jnets["g"]), jz, joptim.table_adam_init(jz))
    opt_g, z_opt = toptim.adam_init(g.parameters()), toptim.table_adam_init(z_table)
    for idx in (np.arange(bs), np.arange(bs, n)[::-1].copy(), np.arange(2, 2 + bs)):
        d1, d2 = (_gen_draws(trees["g"], bs, rng, False) for _ in range(2))
        # each step from JAX's weights (the Adam moments, the step count and
        # the table stay each package's own): an lr-sized difference at a
        # weight whose gradient is ~0 would otherwise grow through the steps
        with torch.no_grad():
            for t, a in zip(g.parameters(), bridge.tree_to_params(g, jcarry[0], "cpu")):
                t.copy_(a)
        with monkeypatch.context() as mp:
            patch_jax_draws(mp, normals=d1[0] + d2[0])
            mp.setattr(tmn, "_gen_draws", Queue([d1[2], d2[2]]))
            jcarry, jl = jax.jit(partial(jmn._train_batch_step, jcfg, lr_scale=0.75))(
                jcarry, jnp.asarray(idx), jax.random.PRNGKey(0), data_x=jnp.asarray(data))
            opt_g, z_opt, tl = tmn._train_batch_step(tcfg, g, opt_g, z_table, z_opt,
                                                     torch.as_tensor(idx), None, nchw(data),
                                                     0.75)
        for k in jl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), err_msg=k, **LOSS_TOL)
        assert_nets_close_after_steps(bridge.net_to_numpy(g), jcarry[0], 1, jcfg.lr_theta)
        np.testing.assert_allclose(z_table.numpy(), np.asarray(jcarry[2]), **STEP_TOL)
    assert z_opt.t == int(jcarry[3].t) == 3


def assert_adam_step_close(port_tree, jax_tree, jax_grads, lr):
    """Nets after one Adam step within STEP_TOL of JAX's, except where the
    gradient is within 100 times its tolerance of zero (``|g| <= 1e-3 x``
    the leaf's scale, see :func:`assert_grads_close`): there Adam's ``g /
    (|g| + eps)`` turns a rounding difference in g into one of up to lr.
    Such exceptions stay within 2 lr and are at most 0.1 % of a net's
    weights."""
    flat_j, flat_g = (dict(jax.tree_util.tree_leaves_with_path(t)) for t in (jax_tree, jax_grads))
    off = total = 0
    for path, got in jax.tree_util.tree_leaves_with_path(port_tree):
        want, grad = np.asarray(flat_j[path]), np.abs(np.asarray(flat_g[path]))
        bad = ~np.isclose(got, want, **STEP_TOL)
        name = jax.tree_util.keystr(path)
        assert not np.any(bad & (grad > 1e-3 * max(1.0, float(grad.max())))), name
        assert np.all(np.abs(got - want) <= 2 * lr), name
        off, total = off + int(bad.sum()), total + bad.size
    assert off <= 1e-3 * total, (off, total)


# ---------------------------------------------------------------------------
# the model classes at narrow widths
# ---------------------------------------------------------------------------


def _params(tmp_path, **kw):
    p = dict(z_dim=Z_DIM, dataset="t", output_dir=str(tmp_path), dz_units=[8], save_res=False,
             save_model=False)
    p.update(kw)
    return p


def _narrow_port(monkeypatch):
    monkeypatch.setattr(tmn, "GEN_FILTERS", SMALL["gen"])
    monkeypatch.setattr(tmn, "ENC_FILTERS", SMALL["enc"])
    monkeypatch.setattr(tmn, "DISC_FILTERS", SMALL["disc"])


def _bridged(tmp_path, monkeypatch, use_bnn=False, seed=0, **kw):
    """``(jax_model, port_model)`` holding the same narrow nets: JAX's
    constructor takes them from its patched init functions (which also
    spares it the compile of its own), the port's from the bridge."""
    trees = _small_trees(use_bnn, seed)
    j = lambda name: (lambda *a, **k: jax.tree.map(jnp.asarray, trees[name]))  # noqa: E731
    with monkeypatch.context() as mp:
        mp.setattr(jconv, "init_mnist_generator", j("g"))
        mp.setattr(jconv, "init_mnist_encoder", j("e"))
        mp.setattr(jnn, "init_critic", j("dz"))
        mp.setattr(jconv, "init_mnist_discriminator", j("dx"))
        jm = jmn.MNISTBGM(_params(tmp_path / "j", use_bnn=use_bnn, **kw), random_seed=seed)
    _narrow_port(monkeypatch)
    tm = tmn.MNISTBGM(_params(tmp_path / "t", use_bnn=use_bnn, **kw), random_seed=seed + 1,
                      device="cpu")
    tm._copy_nets(bridge.nets_from_numpy(trees), "the JAX trees")
    return jm, tm


def _jax_lp_draws(monkeypatch, g_tree, n, rng, use_bnn):
    """Patch JAX's draws with one generator pass and return the port's."""
    normals, signs, port = _gen_draws(g_tree, n, rng, use_bnn)
    patch_jax_draws(monkeypatch, normals=normals, signs=signs)
    return port


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_log_posterior_forms_match_jax(tmp_path, monkeypatch, use_bnn):
    """get_log_posterior over every pixel and in its gather form (with an
    obs_mask) against JAX's under the same draw, and the HMC target's dense
    mask against the gather form on duplicate-free index lists."""
    jm, tm = _bridged(tmp_path, monkeypatch, use_bnn)
    rng = np.random.default_rng(5)
    n = 4
    x, z = _images(n, 5), rng.normal(size=(n, Z_DIM)).astype(np.float32)
    ind = np.stack([rng.choice(784, 300, replace=False) for _ in range(n)])
    obs_mask = (rng.random((n, 300)) > 0.2).astype(np.float32)
    g_tree = bridge.net_to_numpy(tm.nets["g"])
    draws = {}
    for form, kw in (("full", {}), ("gather", dict(ind_x1=ind, obs_mask=obs_mask))):
        with monkeypatch.context() as mp:
            draws[form] = _jax_lp_draws(mp, g_tree, n, rng, use_bnn)
            want = np.asarray(jm.get_log_posterior(z, x, key=jax.random.PRNGKey(0), **kw))
            mp.setattr(tmn, "_gen_draws", Queue([draws[form]]))
            got = tm.get_log_posterior(z, x, **kw).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=form)

    mask = tm._prep_obs_dense_mask(x.reshape(n, -1), ind.tolist(), 784)
    dense = tmn._masked_log_prob(tm.cfg, tm.nets["g"], torch.as_tensor(z),
                                 torch.as_tensor(x.reshape(n, -1)), mask, draws["gather"])
    monkeypatch.setattr(tmn, "_gen_draws", Queue([draws["gather"]]))
    gather = tm.get_log_posterior(z, x, ind_x1=ind)
    np.testing.assert_allclose(dense.detach().numpy(), gather.detach().numpy(), rtol=1e-5,
                               atol=1e-4)


def test_egm_init_on_nhwc_images_matches_jax(tmp_path, monkeypatch):
    """MNISTBGM.egm_init, an entry point of its own, on NHWC images ``(n,
    28, 28, 1)`` as JAX's takes them: one iteration at gamma 10 (both
    gradient penalties) against JAX's iteration on the same images and
    draws; the losses, gradients and nets after it."""
    n, bs = 24, 6
    jm, tm = _bridged(tmp_path, monkeypatch, seed=6, gamma=10.0, g_d_freq=1)
    trees = _small_trees(False, seed=6)
    data = _images(n, 6)
    jax_draws, patch_port = _egm_draws(trees, False, 10.0, n, bs, np.random.default_rng(6))
    jnets, jl, j_grads = _jax_egm_iteration(monkeypatch, jm.cfg, trees, data, bs, jax_draws)
    queues = patch_port(monkeypatch)
    t_grads = []
    monkeypatch.setattr(toptim, "adam_update", _capture(t_grads, toptim.adam_update))
    tm.egm_init(data, egm_n_iter=0, batch_size=bs, egm_batches_per_eval=1, verbose=0)
    assert not any(q.items for q in queues)
    _assert_egm_iteration_close(tm.nets, tm.egm_losses, t_grads, jnets, jl, j_grads, jm.cfg.lr)


def test_entry_points_run_convolutions_in_f32(tmp_path, monkeypatch):
    """Each entry point of MNISTBGM runs its convolutions with cuDNN's TF32
    off, whatever the caller's setting (PyTorch's default is on), and gives
    the caller's setting back."""
    _narrow_port(monkeypatch)
    seen = []
    for name in ("conv2d", "conv_transpose2d"):
        def spy(*a, _fn=getattr(torch.nn.functional, name), **k):
            seen.append(torch.backends.cudnn.allow_tf32)
            return _fn(*a, **k)
        monkeypatch.setattr(torch.nn.functional, name, spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    m = tmn.MNISTBGM(_params(tmp_path), random_seed=0, device="cpu")
    data = _images(16)
    _, miss = thelpers.mnist_mask_indices(mode="upper_half")
    holed = data[:2].reshape(2, -1).copy()
    holed[:, miss] = np.nan
    z = np.zeros((2, Z_DIM), np.float32)
    calls = {
        "egm_init": lambda: m.egm_init(data, egm_n_iter=0, batch_size=8, verbose=0),
        "fit": lambda: m.fit(data, batch_size=8, epochs=0, egm_n_iter=0, verbose=1),
        "evaluate": lambda: m.evaluate(data),
        "generate": lambda: m.generate(nb_samples=2),
        "predict_on_posteriors": lambda: m.predict_on_posteriors(z[None]),
        "get_log_posterior": lambda: m.get_log_posterior(z, data[:2]),
        "tfp_mcmc_sampler": lambda: m.tfp_mcmc_sampler(data[:2].reshape(2, -1), n_mcmc=1,
                                                       burn_in=1),
        "predict": lambda: m.predict(holed.reshape(2, 28, 28, 1), n_mcmc=1, burn_in=1),
    }
    for name, call in calls.items():
        seen.clear()
        call()
        assert seen and not any(seen), name
        assert torch.backends.cudnn.allow_tf32 is True, name


# ---------------------------------------------------------------------------
# lifecycle, checkpoints and resume
# ---------------------------------------------------------------------------


def test_mnistbgm_lifecycle(tmp_path):
    """tests/test_variants.py::test_mnistbgm_lifecycle on the port, at the
    shipped widths on 32 images: fit with the EGM, generate, inpaint the
    upper half with diagnostics."""
    data = _images(32)
    m = tmn.MNISTBGM(dict(x_dim=784, z_dim=4, dataset="unit", output_dir=str(tmp_path),
                          use_bnn=False, dz_units=[8], save_res=False, save_model=False),
                     random_seed=5, device="cpu")
    assert [type(m.nets[k]).__name__ for k in tbgm.NET_NAMES] == [
        "MNISTGenerator", "MNISTEncoder", "Critic", "MNISTDiscriminator"]
    assert m.nets["e"].c1.w.shape == (32, 1, 3, 3) and m.nets["dx"].c1.w.shape == (64, 1, 5, 5)
    m.fit(data, batch_size=16, epochs=1, epochs_per_eval=1, use_egm_init=True, egm_n_iter=2,
          egm_batches_per_eval=2, verbose=0)
    assert len(m.history_loss) == 2 and m.data_z.shape == (32, 4)
    gen = m.generate(nb_samples=8)
    assert gen.shape == (8, 28, 28, 1) and np.all(gen >= 0) and np.all(gen <= 1)
    assert m.predict_on_posteriors(np.zeros((2, 3, 4), np.float32)).shape == (2, 3, 28, 28, 1)

    obs, miss = thelpers.mnist_mask_indices(mode="upper_half")
    test = np.array(data[:4]).reshape(4, -1)
    test[:, miss] = np.nan
    test = test.reshape(4, 28, 28, 1)
    imputed, intervals, diag = m.predict(test, alpha=0.2, n_mcmc=10, burn_in=20,
                                         return_diagnostics=True)
    assert imputed.shape == (4, 28, 28, 1) and not np.any(np.isnan(imputed))
    assert intervals.shape == (4, len(miss), 2)
    np.testing.assert_allclose(imputed.reshape(4, -1)[:, obs], data[:4].reshape(4, -1)[:, obs],
                               rtol=1e-5)
    assert diag["ess"].shape == (4, 28, 28, 1)
    assert np.all(np.isnan(diag["ess"].reshape(4, -1)[:, obs]))
    assert np.all(np.isfinite(diag["rhat"].reshape(4, -1)[:, miss]))


def _assert_last_files_equal(a, b, epoch):
    with np.load(os.path.join(a.checkpoint_path, f"ckpt-{epoch}.npz")) as fa, \
            np.load(os.path.join(b.checkpoint_path, f"ckpt-{epoch}.npz")) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        assert {"['gen']", "['host_gen']", "['opt_ge'].m['g']['fc']['w']", "['data_z']",
                "['opt_d'].v['dx']['c1']['b']", "['z_opt'].v"} <= set(fa.files)
        assert not any(k.startswith("['g_state']") for k in fa.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("case", ["shipped-widths", "narrow-flipout-egm"])
def test_resume_is_exact(tmp_path, monkeypatch, case):
    """tests/test_resume.py::test_mnist_resume_exact on the port, bit for bit:
    a fit over epochs 0..2 against one over 0..1 resumed by a new instance to
    2 (nets, Adam states, latent table and its moments, generators); also
    with the flipout generator, the EGM and the gradient penalty at narrow
    widths."""
    if case == "shipped-widths":
        p = dict(z_dim=3, dataset="resume", use_bnn=False, dz_units=[8], save_res=False,
                 save_model=True)
        kw = dict(epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0)
    else:
        _narrow_port(monkeypatch)
        p = dict(z_dim=3, dataset="resume", use_bnn=True, dz_units=[8], save_res=False,
                 save_model=True, gamma=10.0)
        kw = dict(epochs_per_eval=1, batch_size=16, egm_n_iter=2, egm_batches_per_eval=2,
                  verbose=0)
    data = _images(32)
    ma = tmn.MNISTBGM({**p, "output_dir": str(tmp_path / "a")}, timestamp="ts", random_seed=7,
                      device="cpu")
    ma.fit(data, epochs=2, **kw)
    pb = {**p, "output_dir": str(tmp_path / "b")}
    tmn.MNISTBGM(pb, timestamp="ts", random_seed=7, device="cpu").fit(data, epochs=1, **kw)
    mb = tmn.MNISTBGM(pb, timestamp="ts", random_seed=7, device="cpu")
    mb.fit(data, epochs=2, **kw)
    _assert_last_files_equal(ma, mb, 2)
    for k in tbgm.NET_NAMES:
        for x, y in zip(ma.nets[k].parameters(), mb.nets[k].parameters()):
            assert torch.equal(x, y)
    assert torch.equal(ma.data_z, mb.data_z)
    assert ma.history_loss[-len(mb.history_loss):] == mb.history_loss


def test_jax_checkpoint_nets_restored_in_init(tmp_path, monkeypatch, capsys):
    """A JAX MNISTBGM full-state checkpoint (written by its own bundle)
    on the port model's folder: __init__ restores its nets (kernels carried
    from HWIO), the log posterior matches JAX's, and fit reports that the
    full state is the JAX package's and trains on from the restored nets."""
    jm, _ = _bridged(tmp_path, monkeypatch)
    rng = np.random.default_rng(9)
    jm.data_z = jnp.asarray(rng.normal(size=(16, Z_DIM)), jnp.float32)
    jckpt.save_checkpoint(jm.checkpoint_path, 0,
                          jm._full_state_bundle(joptim.table_adam_init(jm.data_z), 0))
    tm = tmn.MNISTBGM(_params(tmp_path / "j"), timestamp=jm.timestamp, random_seed=3,
                      device="cpu")
    assert "Latest checkpoint restored!!" in capsys.readouterr().out
    assert_tree_close(bridge.nets_to_numpy(tm.nets), jm.nets, rtol=0, atol=0)
    x, z = _images(4, 9), rng.normal(size=(4, Z_DIM)).astype(np.float32)
    g_tree = bridge.net_to_numpy(tm.nets["g"])
    with monkeypatch.context() as mp:
        draws = _jax_lp_draws(mp, g_tree, 4, rng, False)
        want = np.asarray(jm.get_log_posterior(z, x, key=jax.random.PRNGKey(0)))
        mp.setattr(tmn, "_gen_draws", Queue([draws]))
        got = tm.get_log_posterior(z, x).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    tm.fit(_images(16), epochs=0, epochs_per_eval=1, batch_size=16, use_egm_init=False,
           verbose=0)
    assert "Full-state resume unavailable" in capsys.readouterr().out


def test_save_weights_fault_and_the_ports_file(tmp_path, monkeypatch):
    """Reference-side fault (a): JAX MNISTBGM.save_weights raises on the
    g_state it never sets.  The port's writes the nets and data_z under
    JAX's keys and no g_state; a new port model loads it, and JAX's
    checkpoint reader restores its nets."""
    jm, tm = _bridged(tmp_path, monkeypatch)
    with pytest.raises(AttributeError, match="g_state"):
        jm.save_weights(str(tmp_path / "jax.npz"))
    tm.fit(_images(16), epochs=0, epochs_per_eval=1, batch_size=8, use_egm_init=False, verbose=0)
    path = str(tmp_path / "port.npz")
    tm.save_weights(path)
    with np.load(path) as f:
        assert "['data_z']" in f.files and "['nets']['g']['u1']['w']" in f.files
        assert not any(k.startswith("['g_state']") for k in f.files)
    t2 = tmn.MNISTBGM(_params(tmp_path / "t2"), random_seed=11, device="cpu").load_weights(path)
    for k in tbgm.NET_NAMES:
        for x, y in zip(tm.nets[k].parameters(), t2.nets[k].parameters()):
            assert torch.equal(x, y)
    assert torch.equal(t2.data_z, tm.data_z)
    restored = jckpt.restore_checkpoint(path, {"nets": jm.nets})["nets"]
    assert_tree_close(bridge.nets_to_numpy(tm.nets), restored, rtol=0, atol=0)


def test_refusals(tmp_path, monkeypatch):
    _narrow_port(monkeypatch)
    tm = tmn.MNISTBGM(_params(tmp_path), random_seed=0, device="cpu")
    assert tm.cfg.kl_weight == 5e-5 and tm.cfg.z_dim == Z_DIM  # BGM's defaults under the params
    data = _images(10)
    with pytest.raises(ValueError, match="exceeds n=10; the MNISTBGM fit"):
        tm.fit(data, batch_size=16, epochs=0, use_egm_init=False, verbose=0)
    with pytest.raises(TypeError, match="Mesh"):
        tm.fit(data, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        tm.predict(data, mesh=object(), n_mcmc=1, burn_in=1)
    with pytest.raises(TypeError, match="Mesh"):
        tm.tfp_mcmc_sampler(data, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmn.MNISTBGM(_params(tmp_path), random_seed=0)


# ---------------------------------------------------------------------------
# masks and images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(mode="hole"), dict(mode="holes", hole_size=5), dict(mode="hole", center=None, seed=3),
    dict(mode="edge_stripe"), dict(mode="edge_stripe", orientation="vertical", stripe_width=5),
    dict(mode="upper_half"), dict(mode="lower_half"), dict(mode="left_half"),
    dict(mode="right_half"), dict(mode="hole", shape=(20, 24), center=(5, 7))],
    ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_mnist_mask_indices_equal_jaxs(kw):
    for got, want in zip(thelpers.mnist_mask_indices(**kw), jhelpers.mnist_mask_indices(**kw)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(mode="bogus"), dict(mode="edge_stripe", orientation="x")])
def test_mnist_mask_indices_raise_as_jaxs(kw):
    for fn in (thelpers.mnist_mask_indices, jhelpers.mnist_mask_indices):
        with pytest.raises(ValueError, match="Unknown"):
            fn(**kw)


def test_ellipse_images_equal_the_benchmarks():
    spec = importlib.util.spec_from_file_location(
        "_mnist_inpaint", os.path.join(REPO, "benchmarks", "mnist_inpaint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for n, seed in ((40, 0), (7, 3)):
        np.testing.assert_array_equal(timages.make_ellipse_images(n, seed),
                                      mod.make_ellipse_images(n, seed))


def test_load_mnist_images_follows_the_jax_drivers_order(tmp_path, monkeypatch, capsys):
    """``$BAYESGM_MNIST_NPZ`` (a missing file raises), then
    ``$BAYESGM_DATA/mnist.npz``, then the keras cache, then the ellipses."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("BAYESGM_DATA", raising=False)
    monkeypatch.setenv("BAYESGM_MNIST_NPZ", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="refusing"):
        timages.load_mnist_images()
    monkeypatch.delenv("BAYESGM_MNIST_NPZ")
    out = timages.load_mnist_images(n_fallback=6)
    np.testing.assert_array_equal(out, timages.make_ellipse_images(6, seed=0))
    assert "ellipse" in capsys.readouterr().out
    raw = np.random.RandomState(0).randint(0, 256, size=(5, 28, 28)).astype(np.uint8)
    (tmp_path / "d").mkdir()
    np.savez(tmp_path / "d" / "mnist.npz", x_train=raw)
    monkeypatch.setenv("BAYESGM_DATA", str(tmp_path / "d"))
    out = timages.load_mnist_images()
    assert out.shape == (5, 28, 28, 1) and out.dtype == np.float32
    np.testing.assert_array_equal(out[..., 0], (raw / 255.0 > 0.5).astype(np.float32))
