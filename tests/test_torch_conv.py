"""The port's ``ops/conv.py`` against the JAX package's ``ops/conv.py``: every
building block (TF-SAME convolutions at k 1, 3 and 5, strides 1 and 2, on
28, 14 and 7; JAX's transposed convolution on 7 -> 14 and 14 -> 28; channel
BatchNorm; the 2x upsampling; the flipout convolution and its KL) and the
three MNIST nets (encoder; generator, plain and flipout; critic with its
dropout off and with injected masks), on the same numpy inputs and bridged
weights: values, and gradients to the inputs and every parameter.  Also the
bridge's round trip of the nets and of Adam states, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import conv as jconv  # noqa: E402
from bayesgm_tpu.ops import optim as joptim  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.ops import conv as tconv  # noqa: E402
from bayesgm_torch.ops import optim as toptim  # noqa: E402

torch.set_num_threads(2)

# f32 sums of up to 5 * 5 * 8 products per output, in another order than XLA's
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SIGN = lambda rng, *s: (rng.integers(0, 2, size=s) * 2 - 1).astype(np.float32)  # noqa: E731


def cotangent(rng, *shape):
    """A random cotangent scaled by 1 / sqrt(its size), so the gradients it
    pulls back are O(1), as those of a mean loss are."""
    return (rng.normal(size=shape) / np.sqrt(np.prod(shape))).astype(np.float32)


def nhwc(t):
    """A port NCHW tensor as a JAX-layout NHWC numpy array."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


class Queue:
    """Stand-in for a ``jax.random`` or port draw function: returns its
    items in order, each checked against the shape asked for."""

    def __init__(self, items):
        self.items = list(items)

    def __call__(self, *args, **kwargs):
        item = self.items.pop(0)
        shape = kwargs.get("shape", next((a for a in args[1:] if isinstance(a, tuple)), None))
        if shape is not None and tuple(shape) != tuple(np.shape(item)):
            raise AssertionError(f"draw of shape {np.shape(item)} asked for as {tuple(shape)}")
        return item


def patch_jax_draws(mp, normals=(), signs=(), masks=(), uniforms=(), randints=()):
    """Queue JAX's draws: ``jax.random.normal``, ``rademacher``,
    ``bernoulli`` (dropout keep-masks), ``uniform`` and ``randint``."""
    j = jnp.asarray
    mp.setattr(jax.random, "normal", Queue(j(a) for a in normals))
    mp.setattr(jax.random, "rademacher", Queue(j(a) for a in signs))
    mp.setattr(jax.random, "bernoulli", Queue(j(a) for a in masks))
    mp.setattr(jax.random, "uniform", Queue(jnp.float32(a) for a in uniforms))
    mp.setattr(jax.random, "randint", Queue(j(a) for a in randints))


GEN_LAYERS = ("u1", "u2", "c3", "mean", "var")


def generator_flipout_draws(jtree, n, rng):
    """One flipout draw of a JAX generator tree's five layers over ``n``
    rows: ``(jax_normals, jax_signs, port_draws)`` (JAX's eps HWIO and
    signs ``(n, 1, 1, c)`` in its call order; the port's per layer ``(eps
    OIHW, r_in (n, cin), r_out (n, cout))``)."""
    normals, signs, port = [], [], []
    for name in GEN_LAYERS:
        kh, kw, cin, cout = jtree[name]["loc"].shape
        eps = rng.normal(size=(kh, kw, cin, cout)).astype(np.float32)
        r_in, r_out = SIGN(rng, n, cin), SIGN(rng, n, cout)
        normals.append(eps)
        signs += [r_in.reshape(n, 1, 1, cin), r_out.reshape(n, 1, 1, cout)]
        port.append((torch.as_tensor(tconv.kernel_from_hwio(eps, False)), torch.as_tensor(r_in),
                     torch.as_tensor(r_out)))
    return normals, signs, port


def dropout_masks(jtree, n, rng):
    """Keep-masks of the critic's three dropouts over ``n`` images: JAX's
    NHWC and the port's NCHW."""
    masks, size = [], 28
    for name in ("c1", "c2", "c3"):
        size = -(-size // 2)
        masks.append(rng.random((n, size, size, jtree[name]["w"].shape[3])) < 0.7)
    return masks, [nchw(m) for m in masks]


def assert_tree_close(port_tree, jax_tree, **tol):
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    assert len(flat_p) == len(flat_j)
    for path, leaf in flat_p:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_j[path]),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def vjp_both(j_fn, jax_args, t_fn, torch_args, ct):
    """Value and vector-Jacobian product with cotangent ``ct`` of a JAX
    function and its port: ``(j_out, j_grads, t_out)``, the port's
    gradients left in its tensors' ``.grad``.  The JAX function is jitted
    (one compile in place of one per operation; draws patched into
    ``jax.random`` are taken while it is traced)."""
    j_out, vjp = jax.vjp(jax.jit(j_fn), *jax_args)
    j_grads = vjp(jnp.asarray(ct))
    t_out = t_fn(*torch_args)
    t_out.backward(torch.as_tensor(ct) if t_out.dim() != 4 else nchw(ct))
    return np.asarray(j_out), j_grads, t_out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


CONV_CASES = [(k, s, size) for k in (1, 3, 5) for s in (1, 2) for size in (28, 14, 7)]
# transposed shapes beside the nets' 3x3 stride 2: a kernel smaller than its
# stride (JAX's window ends past conv_transpose2d's output), even and odd
# kernels, stride 1
TRANSPOSE_CASES = [(1, 2, 7), (2, 3, 5), (4, 2, 7), (5, 2, 7), (3, 1, 7)]


@pytest.mark.parametrize("k,stride,size,transpose",
                         [(*c, False) for c in CONV_CASES] + [(3, 2, 7, True), (3, 2, 14, True)]
                         + [(*c, True) for c in TRANSPOSE_CASES],
                         ids=[f"k{k}s{s}on{n}" for k, s, n in CONV_CASES] + ["T7to14", "T14to28"]
                         + [f"Tk{k}s{s}on{n}" for k, s, n in TRANSPOSE_CASES])
def test_conv_matches_jax(k, stride, size, transpose):
    """SAME convolution (both padding traps: k 3 and 5 at stride 2 on 28
    and 14 pad asymmetrically) and the transposed convolution (the nets'
    7 -> 14 and 14 -> 28, and other kernels and strides): values, and
    gradients to the input, the kernel (in JAX's layout) and the bias."""
    rng = np.random.default_rng(k * 100 + stride * 10 + size)
    cin, cout = 3, 5
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    layer = tconv.Conv(k, k, cin, cout, stride=stride, transpose=transpose)
    with torch.no_grad():
        layer.w.copy_(torch.as_tensor(tconv.kernel_from_hwio(w, transpose)))
        layer.b.copy_(torch.as_tensor(b))
    out_size = size * stride if transpose else -(-size // stride)
    ct = cotangent(rng, 2, out_size, out_size, cout)
    xt = nchw(x).requires_grad_(True)
    j_out, (gp, gx), t_out = vjp_both(
        lambda p, x_: jconv.conv_apply(p, x_, stride=stride, transpose=transpose),
        ({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)),
        lambda x_: tconv.conv_apply(layer, x_), (xt,), ct)
    assert j_out.shape == (2, out_size, out_size, cout)
    np.testing.assert_allclose(nhwc(t_out), j_out, **VALUE_TOL)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(tconv.kernel_to_hwio(layer.w.grad.numpy(), transpose),
                               np.asarray(gp["w"]), **GRAD_TOL)
    np.testing.assert_allclose(layer.b.grad.numpy(), np.asarray(gp["b"]), **GRAD_TOL)


@pytest.mark.parametrize("size,k,stride,pads", [
    (28, 3, 2, (0, 1)), (14, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (28, 5, 2, (1, 2)),
    (14, 5, 2, (1, 2)), (28, 3, 1, (1, 1)), (28, 1, 1, (0, 0))])
def test_same_pads_are_tensorflows(size, k, stride, pads):
    assert tconv.same_pads(size, k, stride) == pads


def test_channel_bn_and_upsample_match_jax():
    """Batch-statistic BatchNorm (eps 1e-3, biased variance over batch, H,
    W) and the 2x nearest upsampling: values and gradients."""
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, size=(4, 7, 7, 6)).astype(np.float32)
    gamma, beta = rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32)
    bn = tconv.ChannelBN(6)
    with torch.no_grad():
        bn.gamma.copy_(torch.as_tensor(gamma))
        bn.beta.copy_(torch.as_tensor(beta))
    ct = cotangent(rng, 4, 14, 14, 6)
    xt = nchw(x).requires_grad_(True)
    j_out, (gp, gx), t_out = vjp_both(
        lambda p, x_: jconv._upsample2(jconv.channel_bn_apply(p, x_)),
        ({"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}, jnp.asarray(x)),
        lambda x_: tconv.upsample2(tconv.channel_bn_apply(bn, x_)), (xt,), ct)
    np.testing.assert_allclose(nhwc(t_out), j_out, **VALUE_TOL)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(bn.gamma.grad.numpy(), np.asarray(gp["gamma"]), **GRAD_TOL)
    np.testing.assert_allclose(bn.beta.grad.numpy(), np.asarray(gp["beta"]), **GRAD_TOL)


@pytest.mark.parametrize("k,use_bias", [(3, False), (1, True)])
def test_flipout_conv_and_kl_match_jax(monkeypatch, k, use_bias):
    """The flipout convolution with the same eps (shaped like the kernel)
    and per-example, per-channel signs on both sides: values, gradients to
    the input, loc, rho and bias; and its KL with its gradients."""
    rng = np.random.default_rng(2 + k)
    n, cin, cout = 3, 4, 5
    jp = jax_tree(jconv.init_flipout_conv, k, kh=k, kw=k, cin=cin, cout=cout, use_bias=use_bias)
    layer = tconv.FlipoutConv(k, k, cin, cout, use_bias=use_bias)
    with torch.no_grad():
        layer.loc.copy_(torch.as_tensor(tconv.kernel_from_hwio(jp["loc"], False)))
        layer.rho.copy_(torch.as_tensor(tconv.kernel_from_hwio(jp["rho"], False)))
        if use_bias:
            layer.b.copy_(torch.as_tensor(jp["b"]))
    eps = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    r_in, r_out = SIGN(rng, n, cin), SIGN(rng, n, cout)
    x = rng.normal(size=(n, 14, 14, cin)).astype(np.float32)
    ct = cotangent(rng, n, 14, 14, cout)
    xt = nchw(x).requires_grad_(True)
    draws = (torch.as_tensor(tconv.kernel_from_hwio(eps, False)), torch.as_tensor(r_in),
             torch.as_tensor(r_out))
    with monkeypatch.context() as mp:
        patch_jax_draws(mp, normals=[eps], signs=[r_in.reshape(n, 1, 1, cin),
                                                  r_out.reshape(n, 1, 1, cout)])
        j_out, (gp, gx), t_out = vjp_both(
            lambda p, x_: jconv.flipout_conv_apply(p, x_, jax.random.PRNGKey(0)),
            (jp, jnp.asarray(x)), lambda x_: tconv.flipout_conv_apply(layer, x_, draws), (xt,), ct)
    np.testing.assert_allclose(nhwc(t_out), j_out, **VALUE_TOL)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), **GRAD_TOL)
    for name in ("loc", "rho") + (("b",) if use_bias else ()):
        got = getattr(layer, name).grad.numpy()
        got = tconv.kernel_to_hwio(got, False) if got.ndim == 4 else got
        np.testing.assert_allclose(got, np.asarray(gp[name]), err_msg=name, **GRAD_TOL)

    layer.zero_grad()
    kl = tconv.flipout_conv_kl(layer)
    kl.backward()
    j_kl, j_grad = jax.value_and_grad(jconv.flipout_conv_kl)(jp)
    np.testing.assert_allclose(float(kl), float(j_kl), rtol=1e-5)
    for name in ("loc", "rho"):
        np.testing.assert_allclose(tconv.kernel_to_hwio(getattr(layer, name).grad.numpy(), False),
                                   np.asarray(j_grad[name]), err_msg=name, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------


def jax_tree(init, seed, **kw):
    """A random tree shaped as the JAX ``init(key, **kw)`` returns (its
    structure from ``jax.eval_shape``, which traces without compiling),
    numpy float32: kernels Glorot-normal, flipout ``rho ~ -3 + N(0,
    0.5^2)``, BN ``gamma ~ 1 + N(0, 0.1^2)``, biases and ``beta ~ N(0,
    0.1^2)``."""
    shapes = jax.eval_shape(lambda k: init(k, **kw), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        noise = rng.normal(size=s.shape)
        if name in ("w", "loc"):
            receptive = int(np.prod(s.shape[:-2]))  # kh * kw for a kernel, 1 for a dense
            value = noise * np.sqrt(2.0 / (receptive * (s.shape[-2] + s.shape[-1])))
        else:
            value = {"rho": -3.0 + 0.5 * noise, "gamma": 1.0 + 0.1 * noise}.get(name, 0.1 * noise)
        return value.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _net_grads_close(net, j_grads, t_in, j_in_grad):
    assert_tree_close(bridge.params_to_tree(net, [p.grad for p in net.parameters()]), j_grads,
                      **GRAD_TOL)
    np.testing.assert_allclose(t_in, np.asarray(j_in_grad), **GRAD_TOL)


@pytest.mark.parametrize("flat", [False, True], ids=["nhwc", "flat"])
def test_encoder_matches_jax(flat):
    rng = np.random.default_rng(3)
    jp = jax_tree(jconv.init_mnist_encoder, 3, z_dim=3, filters=4)
    net = bridge.net_from_numpy(jp)
    assert type(net) is tconv.MNISTEncoder
    x = rng.random((5, 28, 28, 1)).astype(np.float32)
    x = x.reshape(5, 784) if flat else x
    ct = cotangent(rng, 5, 3)
    xt = torch.as_tensor(x).requires_grad_(True)
    j_out, (gp, gx), t_out = vjp_both(jconv.mnist_encoder_apply, (jp, jnp.asarray(x)),
                                      lambda x_: tconv.mnist_encoder_apply(net, x_), (xt,), ct)
    np.testing.assert_allclose(t_out.detach().numpy(), j_out, **VALUE_TOL)
    _net_grads_close(net, gp, xt.grad.numpy(), gx)


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "flipout"])
def test_generator_matches_jax(monkeypatch, use_bnn):
    """Mean logits and variance (plain: transposed convolutions; flipout:
    upsampling and flipout convolutions under injected draws), gradients
    to z and every parameter through a cotangent on both outputs, and the
    KL."""
    rng = np.random.default_rng(4)
    n = 4
    jp = jax_tree(jconv.init_mnist_generator, 4, z_dim=3, filters=4, use_bnn=use_bnn)
    net = bridge.net_from_numpy(jp)
    assert type(net) is tconv.MNISTGenerator and net.bayesian == use_bnn
    z = rng.normal(size=(n, 3)).astype(np.float32)
    ct_m, ct_v = (cotangent(rng, n, 28, 28, 1) for _ in range(2))
    normals, signs, draws = generator_flipout_draws(jp, n, rng) if use_bnn else ((), (), None)
    zt = torch.as_tensor(z).requires_grad_(True)
    with monkeypatch.context() as mp:
        patch_jax_draws(mp, normals=normals, signs=signs)
        (jm, jv), vjp = jax.vjp(
            jax.jit(lambda p, z_: jconv.mnist_generator_apply(p, z_, jax.random.PRNGKey(0))),
            jp, jnp.asarray(z))
        gp, gz = vjp((jnp.asarray(ct_m), jnp.asarray(ct_v)))
    tm, tv = tconv.mnist_generator_apply(net, zt, draws=draws)
    assert tm.shape == tv.shape == (n, 1, 28, 28)
    np.testing.assert_allclose(nhwc(tm), np.asarray(jm), **VALUE_TOL)
    np.testing.assert_allclose(nhwc(tv), np.asarray(jv), **VALUE_TOL)
    torch.autograd.backward([tm, tv], [nchw(ct_m), nchw(ct_v)])
    _net_grads_close(net, gp, zt.grad.numpy(), gz)
    np.testing.assert_allclose(float(tconv.mnist_generator_kl(net)),
                               float(jconv.mnist_generator_kl(jp)), rtol=1e-5)


@pytest.mark.parametrize("dropout", [False, True], ids=["dropout-off", "injected-masks"])
def test_discriminator_matches_jax(monkeypatch, dropout):
    rng = np.random.default_rng(5)
    n = 3
    jp = jax_tree(jconv.init_mnist_discriminator, 5, filters=4)
    net = bridge.net_from_numpy(jp)
    assert type(net) is tconv.MNISTDiscriminator
    x = rng.random((n, 28, 28, 1)).astype(np.float32)
    ct = cotangent(rng, n, 1)
    j_masks, t_masks = dropout_masks(jp, n, rng) if dropout else ((), None)
    key = jax.random.PRNGKey(0) if dropout else None
    xt = torch.as_tensor(x).requires_grad_(True)
    with monkeypatch.context() as mp:
        patch_jax_draws(mp, masks=j_masks)
        j_out, (gp, gx), t_out = vjp_both(
            lambda p, x_: jconv.mnist_discriminator_apply(p, x_, key), (jp, jnp.asarray(x)),
            lambda x_: tconv.mnist_discriminator_apply(net, x_, draws=t_masks), (xt,), ct)
    np.testing.assert_allclose(t_out.detach().numpy(), j_out, **VALUE_TOL)
    _net_grads_close(net, gp, xt.grad.numpy(), gx)
    with torch.no_grad():  # the masks change the logits
        plain = tconv.mnist_discriminator_apply(net, xt)
    assert torch.equal(plain, t_out) != dropout


def test_dropout_masks_are_drawn_when_given_a_generator():
    net = tconv.MNISTDiscriminator(filters=4, generator=torch.Generator().manual_seed(0))
    x = torch.rand((64, 1, 28, 28), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = tconv.mnist_discriminator_apply(net, x, torch.Generator().manual_seed(2))
        b = tconv.mnist_discriminator_apply(net, x, torch.Generator().manual_seed(2))
        c = tconv.mnist_discriminator_apply(net, x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    mask = tconv._dropout_mask((200000,), 0.7, torch.Generator().manual_seed(4), "cpu")
    assert abs(float(mask.float().mean()) - 0.7) < 0.005


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


JAX_NETS = {
    "encoder": (jconv.init_mnist_encoder, dict(z_dim=3, filters=4)),
    "generator": (jconv.init_mnist_generator, dict(z_dim=3, filters=4)),
    "flipout-generator": (jconv.init_mnist_generator, dict(z_dim=3, filters=4, use_bnn=True)),
    "discriminator": (jconv.init_mnist_discriminator, dict(filters=8)),
}


@pytest.mark.parametrize("kind", sorted(JAX_NETS))
def test_bridge_round_trip_is_bit_equal(kind):
    """JAX tree -> port net -> JAX tree, and port net -> JAX tree -> port
    net, bit for bit; a JAX Adam state over the net maps by name to the
    port's parameters and back."""
    init, kw = JAX_NETS[kind]
    tree = jax_tree(init, 7, **kw)
    net = bridge.net_from_numpy(tree)
    back = bridge.net_to_numpy(net)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    again = bridge.net_from_numpy(back)
    for p, q in zip(net.parameters(), again.parameters()):
        assert torch.equal(p, q)

    j_state = jax.jit(joptim.adam_init)(tree)
    rng = np.random.default_rng(8)
    j_state = j_state._replace(
        m=jax.tree.map(lambda a: np.asarray(rng.normal(size=a.shape), np.float32), j_state.m),
        v=jax.tree.map(lambda a: np.asarray(rng.random(a.shape), np.float32), j_state.v),
        t=np.asarray(3, np.int32))
    t_state = bridge.adam_from_jax(j_state, net, "cpu")
    assert [m.shape for m in t_state.m] == [p.shape for p in net.parameters()]
    round_trip = bridge.adam_to_jax(t_state, net)
    assert int(round_trip.t) == 3
    for got, want in ((round_trip.m, j_state.m), (round_trip.v, j_state.v)):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(want)):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_port_adam_step_on_a_conv_net_is_jaxs():
    """One Adam step of the port on the generator (parameters in the port's
    layout) equals JAX's on the same gradients in JAX's layout."""
    rng = np.random.default_rng(9)
    init, kw = JAX_NETS["generator"]
    tree = jax_tree(init, 9, **kw)
    net = bridge.net_from_numpy(tree)
    j_grads = jax.tree.map(lambda a: np.asarray(rng.normal(size=a.shape), np.float32), tree)
    t_grads = bridge.tree_to_params(net, j_grads, "cpu")
    params = list(net.parameters())
    state = toptim.adam_update(t_grads, toptim.adam_init(params), params, 0.01, b1=0.5, b2=0.9)
    j_tree, j_state = jax.jit(lambda g, p: joptim.adam_update(g, joptim.adam_init(p), p, 0.01,
                                                              b1=0.5, b2=0.9))(j_grads, tree)
    assert_tree_close(bridge.net_to_numpy(net), j_tree, rtol=1e-6, atol=1e-7)
    assert_tree_close(bridge.adam_to_jax(state, net).v, j_state.v, rtol=1e-6, atol=1e-9)
