"""Plain-MLP (``use_bnn=False``) CausalBGM negative log-posterior: K4, and
K3 (the same value plus its z-gradient).

Ports of ``bayesgm_tpu/ops/_pk_plain.py``: ``make_fused_causal_logp`` (K4)
and ``make_fused_causal_logp_and_grad`` (K3).  The nets carry no noise, so
both are deterministic functions of the rows and the weights.

This module holds each kernel's plain PyTorch version (:func:`logp_plain`,
:func:`logp_and_grad_plain`) and its wrapper
(:func:`make_fused_causal_logp`, :func:`make_fused_causal_logp_and_grad`).
A wrapper launches its CUDA kernel (``csrc/plain.cu``) for CUDA tensors and
takes the plain version only for CPU tensors.  K3 has two forms, chosen by
the launcher from the row count (:func:`k3_cluster_max_rows`): a cluster of
8 thread blocks per 32-row tile for fit's small batches, one block per tile
for large ones; both give K4's value bit for bit.  K4 takes a tile of
:func:`k4_tile_rows` rows per block.
"""

from __future__ import annotations

import ctypes

import torch

from bayesgm_torch.ops._build import (
    check_launch,
    cuda_stream,
    load_library,
    require_cuda_f32,
)
from bayesgm_torch.ops._pk_traced_common import _leaky, neg_log_posterior_rows

_SOURCE = "plain.cu"


def _chain_plain(h, w):
    """One plain chain, ``w = [w1, b1, w2, b2, ...]``: LeakyReLU between the
    dense layers, a linear last layer."""
    n_layers = len(w) // 2
    for i in range(n_layers):
        h = h @ w[2 * i] + w[2 * i + 1]
        if i < n_layers - 1:
            h = _leaky(h)
    return h


def logp_plain(cfg, z, x, y, v, g_flat, h_flat, f_flat):
    """Plain PyTorch version of K4: ``(n,)`` negative log-posterior, with
    ``g_flat`` etc. the ``[w1, b1, ...]`` of each net."""
    flats = (g_flat, h_flat, f_flat)
    return neg_log_posterior_rows(cfg, z, x, y, v, lambda ch, h: _chain_plain(h, flats[ch]))


def logp_and_grad_plain(cfg, z, x, y, v, g_flat, h_flat, f_flat):
    """Plain PyTorch version of K3: ``(neg_logp (n,), d neg_logp / dz (n,
    z_dim))``; the gradient is ``torch.autograd.grad`` of :func:`logp_plain`'s
    row sum, independent of the kernel's hand-written backward."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        neg = logp_plain(cfg, zz, x, y, v, g_flat, h_flat, f_flat)
        (grad,) = torch.autograd.grad(neg.sum(), zz)
    return neg.detach(), grad


def _lib():
    lib = load_library(_SOURCE).lib
    if not getattr(lib, "_bayesgm_argtypes", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        common = ([i32, i32, i32, i32, i32, i32]   # n_rows z_dim v_dim d0 d1 d2
                  + [i32, i32, f32, f32, f32]      # binary fixed_mask sigmas
                  + [vp, vp, vp, vp])              # n_layers dims ptrs stream
        lib.plain_logp.argtypes = [vp, vp, vp, vp, vp] + common        # z x y v out
        lib.plain_logp.restype = i32
        lib.plain_logp_and_grad.argtypes = [vp, vp, vp, vp, vp, vp] + common  # ... grad
        lib.plain_logp_and_grad.restype = i32
        lib.plain_grad_cluster_max_rows.argtypes = []
        lib.plain_grad_cluster_max_rows.restype = i32
        lib.plain_logp_tile_rows.argtypes = []
        lib.plain_logp_tile_rows.restype = i32
        lib.plain_error_string.argtypes = [i32]
        lib.plain_error_string.restype = ctypes.c_char_p
        lib._bayesgm_argtypes = True
    return lib


def k3_cluster_max_rows() -> int:
    """The row count up to which K3 takes its cluster form (8 CTAs per
    32-row tile); past it, one block per tile.  Builds the library."""
    return int(_lib().plain_grad_cluster_max_rows())


def k4_tile_rows() -> int:
    """K4's row tile (one block of 4 x that many threads each).  Builds the
    library."""
    return int(_lib().plain_logp_tile_rows())


class _PlainKernel:
    """What K4's and K3's wrappers share: the layer dims, the launch count
    and the checks of a launch's arguments."""

    def __init__(self, cfg, g_dims, h_dims, f_dims):
        self.cfg = cfg
        self.dims = (list(g_dims), list(h_dims), list(f_dims))
        self.launches = 0

    def _c_args(self, z, x, y, v, g_flat, h_flat, f_flat):
        """Check every tensor (device, dtype, shape, contiguity) and return
        ``(keep, args)``: the ctypes arrays the arguments point into (kept
        alive by the caller) and the C arguments after the outputs."""
        cfg, dev = self.cfg, z.device
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        n = z.shape[0]
        d0, d1, d2, _ = cfg.z_dims
        z_dim = sum(cfg.z_dims)
        require_cuda_f32("z", z, dev, (n, z_dim))
        require_cuda_f32("x", x, dev, (n, 1))
        require_cuda_f32("y", y, dev, (n, 1))
        require_cuda_f32("v", v, dev, (n, cfg.v_dim))
        ptrs = []
        for name, w, dims in zip("ghf", (g_flat, h_flat, f_flat), self.dims):
            n_layers = len(dims) - 1
            if len(w) != 2 * n_layers:
                raise ValueError(f"{name}_flat: expected {2 * n_layers} tensors, got {len(w)}")
            for i in range(n_layers):
                require_cuda_f32(f"{name}.w[{i}]", w[2 * i], dev, (dims[i], dims[i + 1]))
                require_cuda_f32(f"{name}.b[{i}]", w[2 * i + 1], dev, (dims[i + 1],))
                ptrs += [w[2 * i].data_ptr(), w[2 * i + 1].data_ptr()]
        n_layers = (ctypes.c_int * 3)(*[len(d) - 1 for d in self.dims])
        flat_dims = [d for dims in self.dims for d in dims]
        dims_arr = (ctypes.c_int * len(flat_dims))(*flat_dims)
        ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        sig = [cfg.sigma_v, cfg.sigma_x, cfg.sigma_y]
        fixed_mask = sum(1 << k for k, s in enumerate(sig) if s is not None)
        keep = (n_layers, dims_arr, ptr_arr)
        return keep, (n, z_dim, cfg.v_dim, d0, d1, d2, int(bool(cfg.binary_treatment)),
                      fixed_mask, *[0.0 if s is None else float(s) for s in sig],
                      *[ctypes.cast(a, ctypes.c_void_p) for a in keep], cuda_stream(dev))


class FusedCausalLogp(_PlainKernel):
    """K4's wrapper: ``fn(z, x, y, v, g_flat, h_flat, f_flat) -> (n,)``.
    CUDA tensors go to the kernel, CPU tensors to :func:`logp_plain`;
    ``launches`` counts kernel launches."""

    def __call__(self, z, x, y, v, g_flat, h_flat, f_flat):
        if z.device.type == "cpu":
            return logp_plain(self.cfg, z, x, y, v, g_flat, h_flat, f_flat)
        if z.shape[0] == 0:  # a rank of a mesh with no rows: nothing to launch
            return torch.empty((0,), dtype=torch.float32, device=z.device)
        _keep, args = self._c_args(z, x, y, v, g_flat, h_flat, f_flat)
        lib = _lib()
        out = torch.empty((z.shape[0],), dtype=torch.float32, device=z.device)
        code = lib.plain_logp(z.data_ptr(), x.data_ptr(), y.data_ptr(), v.data_ptr(),
                              out.data_ptr(), *args)
        check_launch(code, "plain_logp launch", lib.plain_error_string)
        self.launches += 1
        return out


class FusedCausalLogpAndGrad(_PlainKernel):
    """K3's wrapper: ``fn(z, x, y, v, g_flat, h_flat, f_flat) -> (neg_logp
    (n,), d neg_logp / dz (n, z_dim))``.  CUDA tensors go to the kernel, CPU
    tensors to :func:`logp_and_grad_plain`; ``launches`` counts kernel
    launches."""

    def __call__(self, z, x, y, v, g_flat, h_flat, f_flat):
        if z.device.type == "cpu":
            return logp_and_grad_plain(self.cfg, z, x, y, v, g_flat, h_flat, f_flat)
        if z.shape[0] == 0:  # a rank of a mesh with no rows: nothing to launch
            return (torch.empty((0,), dtype=torch.float32, device=z.device),
                    torch.empty(z.shape, dtype=torch.float32, device=z.device))
        _keep, args = self._c_args(z, x, y, v, g_flat, h_flat, f_flat)
        lib = _lib()
        out = torch.empty((z.shape[0],), dtype=torch.float32, device=z.device)
        grad = torch.empty(z.shape, dtype=torch.float32, device=z.device)
        code = lib.plain_logp_and_grad(z.data_ptr(), x.data_ptr(), y.data_ptr(), v.data_ptr(),
                                       out.data_ptr(), grad.data_ptr(), *args)
        check_launch(code, "plain_logp_and_grad launch", lib.plain_error_string)
        self.launches += 1
        return out, grad


def make_fused_causal_logp(cfg, g_dims, h_dims, f_dims):
    """K4 for the plain nets of ``g_dims``/``h_dims``/``f_dims``
    (``[in, ..., out]``).  Returns ``fn(z, x, y, v, g_flat, h_flat, f_flat) ->
    (n,)`` with the JAX kernel's argument order and layouts."""
    return FusedCausalLogp(cfg, g_dims, h_dims, f_dims)


def make_fused_causal_logp_and_grad(cfg, g_dims, h_dims, f_dims):
    """K3 for the plain nets of ``g_dims``/``h_dims``/``f_dims``: K4's value
    and its z-gradient.  Returns ``fn(z, x, y, v, g_flat, h_flat, f_flat) ->
    (neg_logp (n,), d neg_logp/dz (n, z_dim))``."""
    return FusedCausalLogpAndGrad(cfg, g_dims, h_dims, f_dims)
