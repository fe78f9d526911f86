"""Flipout-BNN negative log-posterior with host-provided weight noise: K1,
and K2 (the same value plus its z-gradient).

Ports of ``bayesgm_tpu/ops/_pk_bnn_hosteps.py``:
``make_fused_causal_logp_bnn_hosteps`` (K1) and
``make_fused_causal_logp_and_grad_bnn_hosteps`` (K2).  The weight-noise
matrices ``P = sigma * eps`` are drawn once per evaluation by
:func:`~bayesgm_torch.ops._pk_util.flipout_step_perturbations` and shared by
all rows (the DenseFlipout convention); the per-row Rademacher signs are made
inside the kernel from Philox (see ``_pk_traced_common``).

This module holds each kernel's plain PyTorch version (:func:`logp_plain`,
:func:`logp_and_grad_plain`) and its wrapper
(:func:`make_fused_causal_logp_bnn_hosteps`,
:func:`make_fused_causal_logp_and_grad_bnn_hosteps`).  A wrapper launches
its CUDA kernel (``csrc/bnn_hosteps.cu``) for CUDA tensors and takes the
plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from bayesgm_torch.ops._pk_traced_common import (
    _leaky,
    _sign_source,
    philox_sign_words,
)
from bayesgm_torch.ops.distributions import softplus_var

_SOURCE = "bnn_hosteps.cu"


def _chain_plain(h, w, ps, signs, n_half):
    """One flipout chain: ``w = [gamma_eff, beta, (loc, b) x L]``, ``ps`` the
    ``(n_sets, in, out)`` perturbations; set 0 feeds rows ``< n_half``."""
    n_layers = (len(w) - 2) // 2
    h = h * w[0] + w[1]
    for i in range(n_layers):
        loc, b, P = w[2 + 2 * i], w[3 + 2 * i], ps[i]
        hs = h * signs(2 * i, loc.shape[0])
        if P.shape[0] == 2:
            pert = torch.cat([hs[:n_half] @ P[0], hs[n_half:] @ P[1]], dim=0)
        else:
            pert = hs @ P[0]
        h = h @ loc + b + pert * signs(2 * i + 1, loc.shape[1])
        if i < n_layers - 1:
            h = _leaky(h)
    return h


def _sigma_sq(fixed, raw):
    if fixed is not None:
        return torch.tensor(float(fixed), dtype=torch.float32, device=raw.device) ** 2
    return softplus_var(raw)


def logp_plain(cfg, z, x, y, v, seed, g_w, h_w, f_w, p_flat, n_half=None,
               sign_words=None):
    """Plain PyTorch version of K1: ``(n,)`` negative log-posterior.

    ``p_flat`` lists the perturbations of g's, then h's, then f's layers,
    each ``(n_sets, in, out)``; with ``n_sets == 2`` set 0 feeds rows
    ``< n_half`` (default ``n // 2``) and set 1 the rest.  ``sign_words``
    (a list of three ``(n, max_w)`` int64 tensors, one per chain) replaces
    the Philox words, so a test can feed another generator's words.
    """
    n = z.shape[0]
    if n_half is None:
        n_half = n // 2 if p_flat[0].shape[0] == 2 else n
    d0, d1, d2, _ = cfg.z_dims
    n_layers = [(len(w) - 2) // 2 for w in (g_w, h_w, f_w)]
    cuts = [0, n_layers[0], n_layers[0] + n_layers[1], sum(n_layers)]

    def chain(ch, h, w):
        max_w = max(max(w[2 + 2 * i].shape) for i in range(n_layers[ch]))
        if sign_words is not None:
            if 2 * n_layers[ch] > 32:
                raise ValueError("sign_words covers at most 16 layers per chain")
            signs = _sign_source(lambda group: sign_words[ch])
        else:
            signs = _sign_source(
                lambda group: philox_sign_words(seed, n, max_w, ch, group))
        return _chain_plain(h, w, p_flat[cuts[ch]:cuts[ch + 1]], signs, n_half)

    z0, z1, z2 = z[:, :d0], z[:, d0:d0 + d1], z[:, d0 + d1:d0 + d1 + d2]
    g_out = chain(0, z, g_w)
    s_v = _sigma_sq(cfg.sigma_v, g_out[:, cfg.v_dim])
    loss = torch.sum((v - g_out[:, :cfg.v_dim]) ** 2, dim=1) / (2.0 * s_v) \
        + cfg.v_dim * torch.log(s_v) / 2.0

    h_out = chain(1, torch.cat([z0, z2], dim=1), h_w)
    if cfg.binary_treatment:
        lx = h_out[:, 0]
        loss = loss + torch.clamp_min(lx, 0.0) - lx * x[:, 0] \
            + torch.log1p(torch.exp(-torch.abs(lx)))
    else:
        s_x = _sigma_sq(cfg.sigma_x, h_out[:, 1])
        loss = loss + torch.sum((x - h_out[:, 0:1]) ** 2, dim=1) / (2.0 * s_x) \
            + torch.log(s_x) / 2.0

    f_out = chain(2, torch.cat([z0, z1, x], dim=1), f_w)
    s_y = _sigma_sq(cfg.sigma_y, f_out[:, 1])
    loss = loss + torch.sum((y - f_out[:, 0:1]) ** 2, dim=1) / (2.0 * s_y) \
        + torch.log(s_y) / 2.0
    return loss + torch.sum(z * z, dim=1) / 2.0


def logp_and_grad_plain(cfg, z, x, y, v, seed, g_w, h_w, f_w, p_flat, sign_words=None):
    """Plain PyTorch version of K2: ``(neg_logp (n,), d neg_logp / dz (n, z_dim))``.

    The value is :func:`logp_plain` with one eps set; the gradient is
    ``torch.autograd.grad`` of its row sum with respect to ``z``, through the
    same ``P`` and the same sign words (Philox, or ``sign_words``) — so it is
    independent of the kernel's hand-written backward."""
    if p_flat[0].shape[0] != 1:
        raise ValueError("K2 takes one eps set (it is never paired)")
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        neg = logp_plain(cfg, zz, x, y, v, seed, g_w, h_w, f_w, p_flat, sign_words=sign_words)
        (grad,) = torch.autograd.grad(neg.sum(), zz)
    return neg.detach(), grad


def _lib():
    from bayesgm_torch.ops._build import load_library

    lib = load_library(_SOURCE).lib
    if not getattr(lib, "_bayesgm_argtypes", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bnn_hosteps_logp.argtypes = (
            [vp, vp, vp, vp, vp, vp]                      # z x y v seed out
            + [i32, i32, i32, i32, i32, i32, i32]         # n_rows n_half z_dim v_dim d0 d1 d2
            + [i32, i32, f32, f32, f32]                   # binary fixed_mask sigmas
            + [vp, vp, vp, vp])                           # n_layers dims ptrs stream
        lib.bnn_hosteps_logp.restype = i32
        lib.bnn_hosteps_logp_and_grad.argtypes = (
            [vp, vp, vp, vp, vp, vp, vp]                  # z x y v seed out grad
            + [i32, i32, i32, i32, i32, i32]              # n_rows z_dim v_dim d0 d1 d2
            + [i32, i32, f32, f32, f32]                   # binary fixed_mask sigmas
            + [vp, vp, vp, vp])                           # n_layers dims ptrs stream
        lib.bnn_hosteps_logp_and_grad.restype = i32
        lib.bnn_hosteps_sign_words.argtypes = [vp, vp, i32, i32, i32, i32, vp]
        lib.bnn_hosteps_sign_words.restype = i32
        lib.bnn_hosteps_error_string.argtypes = [i32]
        lib.bnn_hosteps_error_string.restype = ctypes.c_char_p
        lib._bayesgm_argtypes = True
    return lib


def _check(lib, code: int, what: str):
    if code != 0:
        msg = lib.bnn_hosteps_error_string(code).decode()
        raise RuntimeError(f"{what} failed: {msg} (code {code})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require_cuda_f32(name, t, device, shape=None):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 tensor on {device}, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def sign_words_cuda(seed, rows: int, cols: int, chain: int, group: int = 0):
    """The kernel's sign words for rows ``0..rows-1`` as ``(rows, cols)``
    int64 (uint32 values) — the CUDA twin of ``philox_sign_words``, for
    checking the two bit for bit."""
    if seed.device.type != "cuda" or seed.dtype != torch.int32 or seed.numel() != 2:
        raise ValueError("seed: expected a CUDA int32 tensor of 2 words")
    lib = _lib()
    out = torch.empty((rows, cols), dtype=torch.int32, device=seed.device)
    _check(lib, lib.bnn_hosteps_sign_words(seed.data_ptr(), out.data_ptr(), rows, cols,
                                           chain, group, _stream(seed.device)),
           "bnn_hosteps_sign_words launch")
    return out.to(torch.int64) & 0xFFFFFFFF


class _HostepsKernel:
    """What K1's and K2's wrappers share: the layer dims, the launch count
    and the checks of a launch's arguments."""

    def __init__(self, cfg, g_dims, h_dims, f_dims):
        self.cfg = cfg
        self.dims = (list(g_dims), list(h_dims), list(f_dims))
        self.launches = 0

    def _c_args(self, z, x, y, v, seed, g_w, h_w, f_w, p_flat, n_sets):
        """Check every tensor (device, dtype, shape, contiguity) and return
        the kernels' common C arguments after the row count:
        ``(z_dim, v_dim, d0, d1, d2, binary, fixed_mask, sigma_v, sigma_x,
        sigma_y, n_layers, dims, ptrs)``; the ctypes arrays are kept alive by
        the returned tuple."""
        cfg, dev = self.cfg, z.device
        n, z_dim = z.shape
        d0, d1, d2, _ = cfg.z_dims
        _require_cuda_f32("z", z, dev, (n, sum(cfg.z_dims)))
        _require_cuda_f32("x", x, dev, (n, 1))
        _require_cuda_f32("y", y, dev, (n, 1))
        _require_cuda_f32("v", v, dev, (n, cfg.v_dim))
        if seed.device != dev or seed.dtype != torch.int32 or seed.numel() != 2:
            raise ValueError("seed: expected an int32 tensor of 2 words on the data's device")
        ptrs, p_i = [], 0
        for name, w, dims in zip("ghf", (g_w, h_w, f_w), self.dims):
            n_layers = len(dims) - 1
            if len(w) != 2 + 2 * n_layers:
                raise ValueError(f"{name}_w: expected {2 + 2 * n_layers} tensors, got {len(w)}")
            _require_cuda_f32(f"{name}.gamma_eff", w[0], dev, (dims[0],))
            _require_cuda_f32(f"{name}.beta", w[1], dev, (dims[0],))
            ptrs += [w[0].data_ptr(), w[1].data_ptr()]
            for i in range(n_layers):
                P = p_flat[p_i]
                p_i += 1
                _require_cuda_f32(f"{name}.loc[{i}]", w[2 + 2 * i], dev, (dims[i], dims[i + 1]))
                _require_cuda_f32(f"{name}.b[{i}]", w[3 + 2 * i], dev, (dims[i + 1],))
                _require_cuda_f32(f"{name}.P[{i}]", P, dev, (n_sets, dims[i], dims[i + 1]))
                ptrs += [w[2 + 2 * i].data_ptr(), w[3 + 2 * i].data_ptr(), P.data_ptr()]
        if p_i != len(p_flat):
            raise ValueError(f"p_flat: expected {p_i} tensors, got {len(p_flat)}")

        n_layers = (ctypes.c_int * 3)(*[len(d) - 1 for d in self.dims])
        flat_dims = [d for dims in self.dims for d in dims]
        dims_arr = (ctypes.c_int * len(flat_dims))(*flat_dims)
        ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        sig = [cfg.sigma_v, cfg.sigma_x, cfg.sigma_y]
        fixed_mask = sum(1 << k for k, s in enumerate(sig) if s is not None)
        keep = (n_layers, dims_arr, ptr_arr)
        return keep, (z_dim, cfg.v_dim, d0, d1, d2, int(bool(cfg.binary_treatment)),
                      fixed_mask, *[0.0 if s is None else float(s) for s in sig],
                      *[ctypes.cast(a, ctypes.c_void_p) for a in keep])


class FusedCausalLogpBnnHosteps(_HostepsKernel):
    """K1's wrapper: ``fn(z, x, y, v, seed, g_w, h_w, f_w, p_flat) -> (n,)``.

    ``seed`` is an int32 tensor of 2 words on the data's device; ``g_w`` etc.
    are ``[gamma_eff, beta, (loc, b) x L]`` and ``p_flat`` the perturbations
    (set axis 1, or 2 when ``paired``: the first half of the rows takes set
    0, the second half set 1).  CUDA tensors go to the kernel; CPU tensors
    to :func:`logp_plain`.  ``launches`` counts kernel launches.
    """

    def __init__(self, cfg, g_dims, h_dims, f_dims, paired: bool = False):
        super().__init__(cfg, g_dims, h_dims, f_dims)
        self.paired = bool(paired)

    def __call__(self, z, x, y, v, seed, g_w, h_w, f_w, p_flat):
        if z.device.type == "cpu":
            return logp_plain(self.cfg, z, x, y, v, seed, g_w, h_w, f_w, p_flat)
        if z.device.type != "cuda":
            raise ValueError(f"unsupported device {z.device}")
        n = z.shape[0]
        if self.paired and n % 2:
            raise ValueError(f"paired launch needs an even row count, got {n}")
        _keep, args = self._c_args(z, x, y, v, seed, g_w, h_w, f_w, p_flat,
                                   2 if self.paired else 1)
        lib = _lib()
        out = torch.empty((n,), dtype=torch.float32, device=z.device)
        code = lib.bnn_hosteps_logp(
            z.data_ptr(), x.data_ptr(), y.data_ptr(), v.data_ptr(), seed.data_ptr(),
            out.data_ptr(), n, n // 2 if self.paired else n, *args, _stream(z.device))
        _check(lib, code, "bnn_hosteps_logp launch")
        self.launches += 1
        return out


class FusedCausalLogpAndGradBnnHosteps(_HostepsKernel):
    """K2's wrapper: ``fn(z, x, y, v, seed, g_w, h_w, f_w, p_flat) ->
    (neg_logp (n,), d neg_logp / dz (n, z_dim))`` with one eps set
    (``p_flat`` entries ``(1, in, out)``).  CUDA tensors go to the kernel;
    CPU tensors to :func:`logp_and_grad_plain`.  ``launches`` counts kernel
    launches."""

    def __call__(self, z, x, y, v, seed, g_w, h_w, f_w, p_flat):
        if z.device.type == "cpu":
            return logp_and_grad_plain(self.cfg, z, x, y, v, seed, g_w, h_w, f_w, p_flat)
        if z.device.type != "cuda":
            raise ValueError(f"unsupported device {z.device}")
        _keep, args = self._c_args(z, x, y, v, seed, g_w, h_w, f_w, p_flat, 1)
        lib = _lib()
        n, z_dim = z.shape
        out = torch.empty((n,), dtype=torch.float32, device=z.device)
        grad = torch.empty((n, z_dim), dtype=torch.float32, device=z.device)
        code = lib.bnn_hosteps_logp_and_grad(
            z.data_ptr(), x.data_ptr(), y.data_ptr(), v.data_ptr(), seed.data_ptr(),
            out.data_ptr(), grad.data_ptr(), n, *args, _stream(z.device))
        _check(lib, code, "bnn_hosteps_logp_and_grad launch")
        self.launches += 1
        return out, grad


def make_fused_causal_logp_bnn_hosteps(cfg, g_dims, h_dims, f_dims, paired: bool = False):
    """K1 for the nets of ``g_dims``/``h_dims``/``f_dims`` (``[in, ..., out]``).

    Returns ``fn(z, x, y, v, seed, g_w, h_w, f_w, p_flat) -> (n,)`` with the
    JAX kernel's argument order and layouts.  With ``paired=True`` the rows
    are a ``[proposed; current]`` stack of two equal halves and ``p_flat``
    carries two eps sets; each half takes its own set.
    """
    return FusedCausalLogpBnnHosteps(cfg, g_dims, h_dims, f_dims, paired)


def make_fused_causal_logp_and_grad_bnn_hosteps(cfg, g_dims, h_dims, f_dims):
    """K2 for the nets of ``g_dims``/``h_dims``/``f_dims``: the K1 value and
    its z-gradient through the same weight noise, one eps set, never paired.

    Returns ``fn(z, x, y, v, seed, g_w, h_w, f_w, p_flat) -> (neg_logp (n,),
    d neg_logp/dz (n, z_dim))`` with the JAX kernel's argument order.
    """
    return FusedCausalLogpAndGradBnnHosteps(cfg, g_dims, h_dims, f_dims)
