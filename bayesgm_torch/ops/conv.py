"""Convolutional building blocks of the MNIST model family (port of
``bayesgm_tpu/ops/conv.py``): the encoder, the generator (plain, or with
flipout convolutions) and the image critic, as ``nn.Module``s with apply
functions.

Conventions kept from the JAX package, which computes in NHWC with HWIO
kernels; the port computes in NCHW, so each place where the two layouts
meet is explicit:

- **TF "SAME" padding.**  ``pad_total = max((out - 1) * s + k - in, 0)``
  with ``out = ceil(in / s)``, ``pad_total // 2`` before and the rest after.
  At stride 2 the total is odd on 28 and 14 (3x3: (0, 1); 5x5: (1, 2)),
  which ``conv2d(padding=k // 2)`` cannot express, so such inputs are padded
  with ``F.pad`` first.
- **JAX's transposed convolution does not flip its kernel.**
  ``lax.conv_transpose(padding="SAME")`` correlates the stride-dilated input,
  padded ``(pad_a, pad_b)``, with the kernel as stored.  ``conv_transpose2d``
  correlates the fully padded dilated input with the kernel flipped, so the
  port stores a transposed convolution's kernel flipped, as ``(cin, cout,
  kh, kw)``; the flip is made once, by :func:`kernel_from_hwio` when weights
  come from the JAX package (and undone by :func:`kernel_to_hwio`).  The
  apply crops ``conv_transpose2d``'s output to JAX's window.
- **Flattening.**  The dense layers after the convolutions read a (h, w, c)
  ordered flatten, and the generator's first dense output is a (7, 7, c)
  image: the port permutes around the flatten and the reshape, so dense
  weights are JAX's unchanged.
- **Channel BatchNorm always normalises with the batch's statistics**
  (biased variance over batch, H and W; eps ``BN_EPS``): no running
  statistics.
- Glorot-uniform conv and dense kernels, zero biases, LeakyReLU(0.2); the
  flipout convolutions' ``rho ~ -3 + 0.1 N(0, 1)``, their eps shaped like the
  kernel and shared by the batch, their signs per example and channel.

Randomness comes from an explicit ``torch.Generator`` or from ``draws``
(the same randomness drawn earlier), so a caller can hand one draw to many
calls.

Precision: the convolutions are f32 where they run inside a function
wrapped by :func:`f32_convolutions` (every entry point of ``MNISTBGM``),
as the port's matmuls are; PyTorch's own default lets cuDNN use TF32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bayesgm_torch.ops import rows as rows_mod
from bayesgm_torch.ops.distributions import softplus
from bayesgm_torch.ops.nn import _glorot_dense, _rademacher, leaky_relu

BN_EPS = 1e-3
DROPOUT = 0.3  # the critic's dropout rate while training
IMAGE_SHAPE = (1, 28, 28)  # (C, H, W)


def f32_convolutions(fn):
    """``fn`` with cuDNN's TF32 off while it runs, so its convolutions,
    forward and backward, are f32 (PyTorch's default turns TF32 on for
    cuDNN and off for matmuls); the caller's setting is restored after."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cudnn.allow_tf32 = before
    return wrapped


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _glorot(shape, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit)


class Conv(nn.Module):
    """A TF-SAME convolution, or with ``transpose`` JAX's transposed one
    (output ``stride`` times the input).  ``w`` is ``(cout, cin, kh, kw)``,
    or for ``transpose`` ``(cin, cout, kh, kw)`` flipped in space (see the
    module docstring); ``b`` is ``(cout,)`` where ``use_bias``."""

    def __init__(self, kh, kw, cin, cout, stride=1, transpose=False, use_bias=True,
                 generator=None):
        super().__init__()
        self.stride, self.transpose = int(stride), bool(transpose)
        shape = (cin, cout, kh, kw) if transpose else (cout, cin, kh, kw)
        self.w = _glorot(shape, kh * kw * cin, kh * kw * cout, generator)
        self.b = nn.Parameter(torch.zeros(cout)) if use_bias else None


class FlipoutConv(nn.Module):
    """A flipout convolution (TF-SAME): posterior ``N(loc, softplus(rho)^2)``
    over the kernel, ``loc`` and ``rho`` ``(cout, cin, kh, kw)``, ``b``
    ``(cout,)`` where ``use_bias``."""

    transpose = False  # its kernels are OIHW, as a plain Conv's (read by the bridge)

    def __init__(self, kh, kw, cin, cout, stride=1, use_bias=True, generator=None):
        super().__init__()
        self.stride = int(stride)
        shape = (cout, cin, kh, kw)
        self.loc = _glorot(shape, kh * kw * cin, kh * kw * cout, generator)
        self.rho = nn.Parameter(-3.0 + 0.1 * torch.randn(shape, generator=generator))
        self.b = nn.Parameter(torch.zeros(cout)) if use_bias else None


class ChannelBN(nn.Module):
    """Per-channel affine of batch-statistic BatchNorm: ``gamma``, ``beta``."""

    def __init__(self, c):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` ``(din, dout)`` (Glorot-uniform), ``b`` zero."""

    def __init__(self, din, dout, generator=None):
        super().__init__()
        self.w, self.b = _glorot_dense(din, dout, generator)


def kernel_to_hwio(a, transpose: bool):
    """The JAX package's HWIO kernel of a port kernel (numpy)."""
    a = np.asarray(a)
    return (a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1) if transpose
            else a.transpose(2, 3, 1, 0)).copy()


def kernel_from_hwio(a, transpose: bool):
    """The port's kernel of a JAX HWIO kernel (numpy; the inverse of
    :func:`kernel_to_hwio`): OIHW, or a transposed convolution's kernel as
    ``(cin, cout, kh, kw)`` flipped in space."""
    a = np.asarray(a)
    return (a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1] if transpose
            else a.transpose(3, 2, 0, 1)).copy()


def same_pads(size: int, k: int, stride: int):
    """``(before, after)`` padding of TF "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _transpose_crop(k: int, stride: int) -> int:
    """Where JAX's SAME transposed convolution's window starts in
    ``conv_transpose2d``'s full output: ``k - 1 - pad_a``, with JAX's
    ``pad_a`` (``lax._conv_transpose_padding``)."""
    pad_a = k - 1 if stride > k - 1 else -(-(k + stride - 2) // 2)
    return k - 1 - pad_a


def _conv_same(x, w, b, stride: int):
    """TF-SAME ``conv2d``: symmetric padding in the call, otherwise ``F.pad``
    first."""
    (top, bottom), (left, right) = (same_pads(x.shape[-2], w.shape[-2], stride),
                                    same_pads(x.shape[-1], w.shape[-1], stride))
    if top == bottom and left == right:
        return F.conv2d(x, w, b, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=stride)


def conv_apply(layer: Conv, x):
    """SAME convolution or JAX's transposed convolution, NCHW."""
    if not layer.transpose:
        return _conv_same(x, layer.w, layer.b, layer.stride)
    s, (kh, kw), (h, w) = layer.stride, layer.w.shape[-2:], x.shape[-2:]
    top, left = _transpose_crop(kh, s), _transpose_crop(kw, s)
    # JAX's window can end past the full output (k < s): extend it with bias
    extra = (max(0, top + s - kh), max(0, left + s - kw))
    out = F.conv_transpose2d(x, layer.w, layer.b, stride=s, output_padding=extra)
    return out[..., top:top + h * s, left:left + w * s]


def channel_bn_apply(bn: ChannelBN, x):
    """BatchNorm over (batch, H, W) per channel with the batch's mean and
    biased variance, on a contiguous copy of ``x`` (the statistics' order
    of summation follows the layout).  Inside a row split
    (:mod:`bayesgm_torch.ops.rows`) the batch is every rank's rows: they
    are gathered, normalised together and this rank's block is kept."""
    rows = rows_mod.current()
    xs = x.contiguous() if rows is None else rows.gather(x)
    out = F.batch_norm(xs, None, None, bn.gamma, bn.beta, training=True, momentum=0.0,
                       eps=BN_EPS)
    return out if rows is None else out.narrow(0, rows.lo, rows.local)


def dense_apply(layer: Dense, x):
    return x @ layer.w + layer.b


def upsample2(x):
    """Nearest-neighbour 2x upsampling as JAX writes it (broadcast, then
    reshape), so its backward is a plain sum over each 2 x 2 block."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


def flipout_conv_apply(layer: FlipoutConv, x, draws):
    """``conv(x, loc) + conv(x * r_in, softplus(rho) * eps) * r_out + b``;
    ``draws = (eps, r_in, r_out)``: eps shaped like ``loc``, the signs
    ``(n, cin)`` and ``(n, cout)``."""
    eps, r_in, r_out = draws
    mean_out = _conv_same(x, layer.loc, layer.b, layer.stride)
    pert = _conv_same(x * r_in[:, :, None, None], softplus(layer.rho) * eps, None, layer.stride)
    return mean_out + pert * r_out[:, :, None, None]


def flipout_conv_kl(layer: FlipoutConv, prior_scale: float = 1.0):
    """KL of the kernel's posterior against N(0, prior_scale^2)."""
    var_ratio = (softplus(layer.rho) / prior_scale) ** 2
    return 0.5 * torch.sum(var_ratio + (layer.loc / prior_scale) ** 2 - 1.0 - torch.log(var_ratio))


def flipout_draws(layers, n: int, generator):
    """One eps draw and one sign draw for flipout ``layers`` over ``n``
    rows (a fused draw: one normal and one sign call); returns ``[(eps,
    r_in, r_out), ...]`` per layer."""
    device = layers[0].loc.device
    shapes = [tuple(layer.loc.shape) for layer in layers]
    eps = torch.randn((sum(math.prod(s) for s in shapes),), generator=generator, device=device)
    signs = rows_mod.draw(lambda s: _rademacher(s, generator, device),
                          (n, sum(s[0] + s[1] for s in shapes)))
    out, eo, so = [], 0, 0
    for s in shapes:
        cout, cin = s[0], s[1]
        out.append((eps[eo:eo + math.prod(s)].reshape(s), signs[:, so:so + cin],
                    signs[:, so + cin:so + cin + cout]))
        eo += math.prod(s)
        so += cin + cout
    return out


def _dropout_mask(shape, keep: float, generator, device):
    """Keep-mask of dropout: True with probability ``keep``."""
    return torch.rand(shape, generator=generator, device=device) < keep


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------


class ConvNet(nn.Module):
    """Base of the three MNIST nets: each layer is a named submodule, so a
    parameter's name (``"c1.w"``, ``"bn1.gamma"``) is its JAX path."""

    @property
    def dims(self) -> list:
        return [tuple(p.shape) for p in self.parameters()]


def _images(x):
    """``(n, 1, 28, 28)`` from flat ``(n, 784)``, NHWC ``(n, 28, 28, 1)`` or
    NCHW images (one channel, so the three share their memory order)."""
    return x.reshape((-1,) + IMAGE_SHAPE)


def _flatten_hwc(h):
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class MNISTEncoder(ConvNet):
    """3x3 convolutions 1 -> f (stride 2), f -> 2f (stride 2), 2f -> 4f, each
    without bias and followed by channel BatchNorm and LeakyReLU; then dense
    7 * 7 * 4f -> 256 -> z_dim."""

    def __init__(self, z_dim=10, filters=32, generator=None):
        super().__init__()
        f = int(filters)
        self.c1 = Conv(3, 3, 1, f, stride=2, use_bias=False, generator=generator)
        self.bn1 = ChannelBN(f)
        self.c2 = Conv(3, 3, f, 2 * f, stride=2, use_bias=False, generator=generator)
        self.bn2 = ChannelBN(2 * f)
        self.c3 = Conv(3, 3, 2 * f, 4 * f, use_bias=False, generator=generator)
        self.bn3 = ChannelBN(4 * f)
        self.d1 = Dense(49 * 4 * f, 256, generator)
        self.d2 = Dense(256, int(z_dim), generator)


def mnist_encoder_apply(net: MNISTEncoder, x):
    """Images (any of :func:`_images`' layouts) -> ``(n, z_dim)``."""
    h = _images(x)
    for c, bn in ((net.c1, net.bn1), (net.c2, net.bn2), (net.c3, net.bn3)):
        h = leaky_relu(channel_bn_apply(bn, conv_apply(c, h)))
    return dense_apply(net.d2, leaky_relu(dense_apply(net.d1, _flatten_hwc(h))))


class MNISTGenerator(ConvNet):
    """Dense z_dim -> 7 * 7 * 4f reshaped to a (7, 7, 4f) image, then two 2x
    up-blocks 4f -> 2f -> f and a 3x3 convolution f -> f, each without bias
    and followed by channel BatchNorm and LeakyReLU; then 1x1 mean and
    variance heads with bias.  Plain: the up-blocks are JAX's transposed
    convolutions (stride 2).  ``use_bnn``: nearest-neighbour upsampling and
    flipout convolutions everywhere after the dense layer."""

    def __init__(self, z_dim=10, filters=32, use_bnn=False, generator=None):
        super().__init__()
        f, g = int(filters), generator
        self.bayesian = bool(use_bnn)
        self.fc = Dense(int(z_dim), 49 * 4 * f, g)
        if self.bayesian:
            self.u1 = FlipoutConv(3, 3, 4 * f, 2 * f, use_bias=False, generator=g)
            self.u2 = FlipoutConv(3, 3, 2 * f, f, use_bias=False, generator=g)
            self.c3 = FlipoutConv(3, 3, f, f, use_bias=False, generator=g)
            self.mean = FlipoutConv(1, 1, f, 1, generator=g)
            self.var = FlipoutConv(1, 1, f, 1, generator=g)
        else:
            self.u1 = Conv(3, 3, 4 * f, 2 * f, stride=2, transpose=True, use_bias=False, generator=g)
            self.u2 = Conv(3, 3, 2 * f, f, stride=2, transpose=True, use_bias=False, generator=g)
            self.c3 = Conv(3, 3, f, f, use_bias=False, generator=g)
            self.mean = Conv(1, 1, f, 1, generator=g)
            self.var = Conv(1, 1, f, 1, generator=g)
        self.bn1, self.bn2, self.bn3 = ChannelBN(2 * f), ChannelBN(f), ChannelBN(f)

    def flipout_layers(self) -> list:
        """The flipout layers in the order of the fused draw."""
        return [self.u1, self.u2, self.c3, self.mean, self.var] if self.bayesian else []


def mnist_generator_apply(net: MNISTGenerator, z, generator=None, draws=None, eps=1e-6):
    """``(n, z_dim)`` -> ``(mean_logits, var)``, both ``(n, 1, 28, 28)``.
    The flipout generator draws from ``generator`` unless given ``draws``
    (:func:`flipout_draws` for its :meth:`~MNISTGenerator.flipout_layers`)."""
    f4 = net.fc.w.shape[1] // 49
    h = leaky_relu(dense_apply(net.fc, z)).reshape(-1, 7, 7, f4).permute(0, 3, 1, 2)
    if net.bayesian:
        if draws is None:
            draws = flipout_draws(net.flipout_layers(), z.shape[0], generator)
        h = leaky_relu(channel_bn_apply(net.bn1, flipout_conv_apply(net.u1, upsample2(h), draws[0])))
        h = leaky_relu(channel_bn_apply(net.bn2, flipout_conv_apply(net.u2, upsample2(h), draws[1])))
        h = leaky_relu(channel_bn_apply(net.bn3, flipout_conv_apply(net.c3, h, draws[2])))
        x_mean = flipout_conv_apply(net.mean, h, draws[3])
        x_var_raw = flipout_conv_apply(net.var, h, draws[4])
    else:
        for c, bn in ((net.u1, net.bn1), (net.u2, net.bn2), (net.c3, net.bn3)):
            h = leaky_relu(channel_bn_apply(bn, conv_apply(c, h)))
        x_mean, x_var_raw = conv_apply(net.mean, h), conv_apply(net.var, h)
    return x_mean, softplus(x_var_raw) + eps


def mnist_generator_kl(net: MNISTGenerator):
    """Summed KL of the flipout layers (0 for the plain generator)."""
    return sum((flipout_conv_kl(layer) for layer in net.flipout_layers()), 0.0)


class MNISTDiscriminator(ConvNet):
    """Convolutions 5x5 1 -> f, 5x5 f -> 2f and 3x3 2f -> 4f (all stride 2,
    with bias), each followed by LeakyReLU and, while training, dropout;
    then dense 4 * 4 * 4f -> 128 -> 1."""

    def __init__(self, filters=64, generator=None):
        super().__init__()
        f, g = int(filters), generator
        self.c1 = Conv(5, 5, 1, f, stride=2, generator=g)
        self.c2 = Conv(5, 5, f, 2 * f, stride=2, generator=g)
        self.c3 = Conv(3, 3, 2 * f, 4 * f, stride=2, generator=g)
        self.d1 = Dense(16 * 4 * f, 128, g)
        self.logit = Dense(128, 1, g)


def mnist_discriminator_apply(net: MNISTDiscriminator, x, generator=None, draws=None,
                              dropout: float = DROPOUT):
    """Images -> ``(n, 1)`` logits.  Dropout is active when ``generator`` or
    ``draws`` (three keep-masks, one per convolution's output, NCHW) is
    given, as JAX's is when given a key; off otherwise."""
    keep = 1.0 - dropout
    masks = iter(draws) if draws is not None else None
    h = _images(x)
    for c in (net.c1, net.c2, net.c3):
        h = leaky_relu(conv_apply(c, h))
        if masks is not None or generator is not None:
            mask = next(masks) if masks is not None else _dropout_mask(h.shape, keep, generator,
                                                                       h.device)
            h = torch.where(mask, h / keep, 0.0)
    return dense_apply(net.logit, leaky_relu(dense_apply(net.d1, _flatten_hwc(h))))
