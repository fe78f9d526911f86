"""Flipout-BNN negative log-posterior with all noise drawn in the kernel: K6,
K7 (K6 plus its z-gradient) and K5 (``n_steps`` MH steps in one launch).

Ports of ``bayesgm_tpu/ops/_pk_bnn_inkernel.py``:
``make_fused_causal_logp_bnn`` (K6), ``make_fused_causal_logp_and_grad_bnn``
(K7) and ``make_fused_mh_steps_bnn`` (K5).  Unlike K1 and K2, the weight
noise eps is drawn per logical row block of ``block_rows`` rows and per
evaluation, as the TPU kernel draws it per grid program: the rows of a block
share one eps, so ``block_rows`` is part of the result.  Each builder takes
``block_rows=None`` and then sizes the block as the JAX builder does.  The
draws (signs, eps, proposals, accept uniforms) come from Philox counter
domains laid out in ``_pk_traced_common``.

This module holds each kernel's plain PyTorch version (:func:`logp_plain`,
:func:`logp_and_grad_plain`, :func:`mh_steps_plain`), each taking a
``draws=`` object that replaces the Philox draws (so a test can feed another
generator's words), and the wrappers.  A wrapper launches its CUDA kernel
(``csrc/bnn_inkernel.cu``) for CUDA tensors and takes the plain version only
for CPU tensors.  The weights come in the flat layout of
:func:`~bayesgm_torch.ops._pk_util.flatten_flipout_params`:
``[gamma_eff, beta, (loc, sigma, b) x L]`` per chain.

Besides each wrapper's own ``launches``, :data:`LAUNCHES` counts the launches
of each entry point over every wrapper of this module, so a caller that
holds no wrapper can still see whether a path launched K5, K6 or K7.  K6 is
one evaluation of K5's device code.  K7 has two forms, chosen by the launcher
from the row count (:func:`k7_cluster_max_rows`): a cluster of 8 thread
blocks per 32-row tile for small batches, K5's register-tiled evaluation
with a register-tiled backward for large ones; both give K6's value bit for
bit.  K8, the probe's variants of K6's own device code (``base`` is K6), has
its entry point in the same library and its wrapper in
``bayesgm_torch/benchmarks/mxu_probe.py``.
"""

from __future__ import annotations

import ctypes
import re

import torch

from bayesgm_torch.ops._build import (
    CSRC,
    check_launch,
    cuda_stream,
    load_library,
    require_cuda_f32,
)
from bayesgm_torch.ops._pk_traced_common import (
    PhiloxDraws,
    _kernel_normal,
    _kernel_uniform,
    _leaky,
    _sign_source,
    neg_log_posterior_rows,
)
from bayesgm_torch.ops._pk_util import bnn_block_rows, pick_block_rows

_SOURCE = "bnn_inkernel.cu"

# Launches per entry point (``bnn_inkernel_<name>``), over every wrapper.
LAUNCHES = {"logp": 0, "logp_and_grad": 0, "mh_steps": 0}


def _n_layers(flat) -> int:
    return (len(flat) - 2) // 3


def _chain_plain(h, flat, signs, eps, block_rows, pre_acts=None, rnd=None):
    """One flipout chain on ``(n, in)`` rows with per-block weight noise:
    ``eps(i, rows, cols)`` gives layer ``i``'s ``(n_blocks, rows, cols)``
    draws, and each block's rows go through their own ``P = sigma * eps`` in
    one batched product.  Hidden pre-activations are appended to the list
    ``pre_acts`` when one is given.

    The probe's variants (``bayesgm_torch.benchmarks.mxu_probe``) switch
    parts out: ``eps`` may return one ``(rows, cols)`` stand-in shared by all
    blocks, or be None (no perturbation product); ``signs=None`` applies no
    signs; ``rnd`` rounds each product's operands (bf16)."""
    n = h.shape[0]
    n_blocks = -(-n // block_rows)
    n_pad = n_blocks * block_rows
    n_layers = _n_layers(flat)
    rnd = (lambda t: t) if rnd is None else rnd
    h = h * flat[0] + flat[1]
    for i in range(n_layers):
        loc, sig, b = flat[2 + 3 * i], flat[3 + 3 * i], flat[4 + 3 * i]
        out = rnd(h) @ rnd(loc) + b
        if eps is not None:
            P = rnd(sig * eps(i, *loc.shape)).expand(n_blocks, -1, -1)
            hs = rnd(h if signs is None else h * signs(2 * i, loc.shape[0]))
            if n_pad != n:
                hs = torch.cat([hs, hs.new_zeros((n_pad - n, hs.shape[1]))])
            pert = torch.bmm(hs.reshape(n_blocks, block_rows, -1), P).reshape(n_pad, -1)[:n]
            out = out + (pert if signs is None else pert * signs(2 * i + 1, loc.shape[1]))
        h = out
        if i < n_layers - 1:
            if pre_acts is not None:
                pre_acts.append(h.detach())
            h = _leaky(h)
    return h


def logp_plain(cfg, z, x, y, v, seed, g_flat, h_flat, f_flat, block_rows, ev=0, draws=None,
               pre_acts=None):
    """Plain PyTorch version of K6: ``(n,)`` negative log-posterior.

    Rows ``[k * block_rows, (k + 1) * block_rows)`` share block ``k``'s eps;
    ``ev`` is the evaluation index of the draws (K5's ``2 * step + side``).
    ``draws`` (default: :class:`PhiloxDraws` of ``seed``) supplies the sign
    words and the eps words.  ``pre_acts``, a list, receives every hidden
    layer's ``(n, width)`` pre-activation (see :func:`kink_rows`)."""
    draws = PhiloxDraws(seed) if draws is None else draws
    n = z.shape[0]
    n_blocks = -(-n // block_rows)
    flats = (g_flat, h_flat, f_flat)

    def chain(ch, h):
        flat = flats[ch]
        max_w = max(max(flat[2 + 3 * i].shape) for i in range(_n_layers(flat)))
        signs = _sign_source(lambda group: draws.sign_words(n, max_w, ch, ev, group))

        def eps(i, rows, cols):
            u1, u2 = draws.eps_words(n_blocks, rows, (cols + 1) // 2, ch, i, ev)
            return _kernel_normal(u1, u2, cols)

        return _chain_plain(h, flat, signs, eps, block_rows, pre_acts)

    return neg_log_posterior_rows(cfg, z, x, y, v, chain)


def kink_rows(cfg, z, x, y, v, seed, g_flat, h_flat, f_flat, block_rows, tol=1e-5):
    """``(n,)`` bool: rows with a hidden pre-activation within ``tol`` of 0 in
    :func:`logp_plain`.  There LeakyReLU's slope jumps from 0.2 to 1, so a
    kernel and its plain version, which round differently, may take
    different slopes and their z-gradients differ by far more than f32
    rounding: such a row is the one place a gradient comparison may fail."""
    pre = []
    logp_plain(cfg, z, x, y, v, seed, g_flat, h_flat, f_flat, block_rows, pre_acts=pre)
    return torch.cat([p.abs() for p in pre], dim=1).min(dim=1).values < tol


def logp_and_grad_plain(cfg, z, x, y, v, seed, g_flat, h_flat, f_flat, block_rows,
                        draws=None):
    """Plain PyTorch version of K7: ``(neg_logp (n,), d neg_logp / dz (n,
    z_dim))``, the gradient by ``torch.autograd.grad`` of :func:`logp_plain`'s
    row sum through the same draws, independent of the kernel's backward."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        neg = logp_plain(cfg, zz, x, y, v, seed, g_flat, h_flat, f_flat, block_rows,
                         draws=draws)
        (grad,) = torch.autograd.grad(neg.sum(), zz)
    return neg.detach(), grad


def mh_steps_plain(cfg, z, x, y, v, seed, q_sd, g_flat, h_flat, f_flat, n_steps,
                   block_rows, draws=None):
    """Plain PyTorch version of K5: ``n_steps`` random-walk MH steps.

    Step ``i`` proposes ``z + q_sd * N(0, I)`` (proposal draws of step
    ``i``), evaluates the proposed state (``ev = 2i``) and the current one
    (``ev = 2i + 1``) afresh, and accepts a row when ``log(max(u, 1e-30)) <
    logp_prop - logp_cur``.  Returns ``(z, logp, counts)``: the last step's
    log-posterior of the state kept (0 when ``n_steps == 0``) and the rows
    accepted at each step, float32 ``(n_steps,)``."""
    draws = PhiloxDraws(seed) if draws is None else draws
    n, z_dim = z.shape
    q = q_sd.reshape(()).to(torch.float32)
    logp = torch.zeros((n,), dtype=torch.float32, device=z.device)
    counts = torch.zeros((n_steps,), dtype=torch.float32, device=z.device)
    args = (g_flat, h_flat, f_flat, block_rows)
    for i in range(n_steps):
        u1, u2 = draws.proposal_words(n, (z_dim + 1) // 2, i)
        proposed = z + q * _kernel_normal(u1, u2, z_dim)
        logp_prop = -logp_plain(cfg, proposed, x, y, v, seed, *args, ev=2 * i, draws=draws)
        logp_cur = -logp_plain(cfg, z, x, y, v, seed, *args, ev=2 * i + 1, draws=draws)
        u = torch.clamp_min(_kernel_uniform(draws.accept_words(n, i)), 1e-30)
        accept = torch.log(u) < logp_prop - logp_cur
        z = torch.where(accept[:, None], proposed, z)
        logp = torch.where(accept, logp_prop, logp_cur)
        counts[i] = accept.sum()
    return z, logp, counts


def _lib():
    lib = load_library(_SOURCE).lib
    if not getattr(lib, "_bayesgm_argtypes", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        common = ([i32, i32, i32, i32, i32, i32]          # n_rows z_dim v_dim d0 d1 d2
                  + [i32, i32, f32, f32, f32, i32])       # binary fixed_mask sigmas block_rows
        tail = [vp, vp, vp, vp]                           # n_layers dims ptrs stream
        lib.bnn_inkernel_logp.argtypes = [vp] * 6 + common + tail          # z x y v seed out
        lib.bnn_inkernel_logp_and_grad.argtypes = [vp] * 7 + common + tail  # ... out grad
        lib.bnn_inkernel_mh_steps.argtypes = ([vp] * 9 + common + [i32]    # ... n_steps
                                              + tail)  # z x y v seed q_sd z_out logp counts
        lib.bnn_inkernel_probe.argtypes = [i32] + [vp] * 6 + common + tail  # variant, as logp
        lib.bnn_inkernel_sign_words.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
        lib.bnn_inkernel_eps.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, vp]
        lib.bnn_inkernel_proposal.argtypes = [vp, vp, i32, i32, i32, vp]
        lib.bnn_inkernel_accept.argtypes = [vp, vp, i32, i32, vp]
        lib.bnn_inkernel_grad_cluster_max_rows.argtypes = []
        for fn in ("logp", "logp_and_grad", "mh_steps", "probe", "sign_words", "eps",
                   "proposal", "accept", "grad_cluster_max_rows"):
            getattr(lib, f"bnn_inkernel_{fn}").restype = i32
        lib.bnn_inkernel_error_string.argtypes = [i32]
        lib.bnn_inkernel_error_string.restype = ctypes.c_char_p
        lib._bayesgm_argtypes = True
    return lib


def k7_cluster_max_rows() -> int:
    """The row count up to which K7 takes its cluster form (8 thread blocks
    per 32-row tile); past it, K5's 64-row tiles.  Read from the kernel's
    source (``kK7ClusterMaxRows``), so it needs no build; the library's
    ``bnn_inkernel_grad_cluster_max_rows()`` returns the same number."""
    m = re.search(r"constexpr int kK7ClusterMaxRows = (\d+);", (CSRC / _SOURCE).read_text())
    if m is None:
        raise RuntimeError(f"kK7ClusterMaxRows not found in {CSRC / _SOURCE}")
    return int(m.group(1))


def _require_seed(seed):
    if seed.device.type != "cuda" or seed.dtype != torch.int32 or seed.numel() != 2:
        raise ValueError("seed: expected a CUDA int32 tensor of 2 words")


def _launch_draw(fn, seed, out, *args):
    lib = _lib()
    code = getattr(lib, f"bnn_inkernel_{fn}")(seed.data_ptr(), out.data_ptr(), *args,
                                               cuda_stream(seed.device))
    check_launch(code, f"bnn_inkernel_{fn} launch", lib.bnn_inkernel_error_string)
    return out


class DrawsCuda:
    """The kernels' own draws, computed on the card by their device code, with
    :class:`PhiloxDraws`' methods' arguments (normals and uniforms rather
    than words), for checking the two against each other."""

    def __init__(self, seed):
        _require_seed(seed)
        self.seed = seed

    def sign_words(self, rows, cols, chain, ev, group=0):
        out = torch.empty((rows, cols), dtype=torch.int32, device=self.seed.device)
        _launch_draw("sign_words", self.seed, out, rows, cols, chain, group, ev)
        return out.to(torch.int64) & 0xFFFFFFFF

    def eps(self, n_blocks, rows, cols, chain, layer, ev):
        out = torch.empty((n_blocks, rows, cols), dtype=torch.float32, device=self.seed.device)
        return _launch_draw("eps", self.seed, out, n_blocks, rows, cols, chain, layer, ev)

    def proposal(self, rows, z_dim, step):
        out = torch.empty((rows, z_dim), dtype=torch.float32, device=self.seed.device)
        return _launch_draw("proposal", self.seed, out, rows, z_dim, step)

    def accept(self, rows, step):
        out = torch.empty((rows,), dtype=torch.float32, device=self.seed.device)
        return _launch_draw("accept", self.seed, out, rows, step)


class _InkernelKernel:
    """What K5's, K6's and K7's wrappers share: the layer dims, the row block,
    the launch count and the checks of a launch's arguments.  ``entry`` names
    the subclass's entry point in :data:`LAUNCHES`."""

    entry = ""

    def __init__(self, cfg, g_dims, h_dims, f_dims, block_rows):
        self.cfg = cfg
        self.dims = (list(g_dims), list(h_dims), list(f_dims))
        self.block_rows = int(block_rows)
        if self.block_rows < 1:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self.launches = 0

    def _count_launch(self):
        self.launches += 1
        LAUNCHES[self.entry] += 1

    def _c_args(self, z, x, y, v, seed, g_flat, h_flat, f_flat):
        """Check every tensor (device, dtype, shape, contiguity) and return the
        kernels' common C arguments after the row count (the launcher refuses
        a ``block_rows`` that is not a multiple of its 32-row tile):
        ``(z_dim, v_dim, d0, d1, d2, binary, fixed_mask, sigma_v, sigma_x,
        sigma_y, block_rows, n_layers, dims, ptrs)``; the ctypes arrays are
        kept alive by the returned tuple."""
        cfg, dev = self.cfg, z.device
        n, z_dim = z.shape
        d0, d1, d2, _ = cfg.z_dims
        require_cuda_f32("z", z, dev, (n, sum(cfg.z_dims)))
        require_cuda_f32("x", x, dev, (n, 1))
        require_cuda_f32("y", y, dev, (n, 1))
        require_cuda_f32("v", v, dev, (n, cfg.v_dim))
        if seed.device != dev or seed.dtype != torch.int32 or seed.numel() != 2:
            raise ValueError("seed: expected an int32 tensor of 2 words on the data's device")
        ptrs = []
        for name, flat, dims in zip("ghf", (g_flat, h_flat, f_flat), self.dims):
            n_layers = len(dims) - 1
            if len(flat) != 2 + 3 * n_layers:
                raise ValueError(f"{name}_flat: expected {2 + 3 * n_layers} tensors, "
                                 f"got {len(flat)}")
            require_cuda_f32(f"{name}.gamma_eff", flat[0], dev, (dims[0],))
            require_cuda_f32(f"{name}.beta", flat[1], dev, (dims[0],))
            ptrs += [flat[0].data_ptr(), flat[1].data_ptr()]
            for i in range(n_layers):
                for j, what in enumerate(("loc", "sigma")):
                    require_cuda_f32(f"{name}.{what}[{i}]", flat[2 + 3 * i + j], dev,
                                     (dims[i], dims[i + 1]))
                require_cuda_f32(f"{name}.b[{i}]", flat[4 + 3 * i], dev, (dims[i + 1],))
                ptrs += [t.data_ptr() for t in flat[2 + 3 * i:5 + 3 * i]]

        n_layers = (ctypes.c_int * 3)(*[len(d) - 1 for d in self.dims])
        flat_dims = [d for dims in self.dims for d in dims]
        dims_arr = (ctypes.c_int * len(flat_dims))(*flat_dims)
        ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        sig = [cfg.sigma_v, cfg.sigma_x, cfg.sigma_y]
        fixed_mask = sum(1 << k for k, s in enumerate(sig) if s is not None)
        keep = (n_layers, dims_arr, ptr_arr)
        return keep, (z_dim, cfg.v_dim, d0, d1, d2, int(bool(cfg.binary_treatment)),
                      fixed_mask, *[0.0 if s is None else float(s) for s in sig],
                      self.block_rows, *[ctypes.cast(a, ctypes.c_void_p) for a in keep])


def _on_cpu(z) -> bool:
    if z.device.type == "cpu":
        return True
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    return False


class FusedCausalLogpBnn(_InkernelKernel):
    """K6's wrapper: ``fn(z, x, y, v, seed, g_flat, h_flat, f_flat) -> (n,)``.

    ``seed`` is an int32 tensor of 2 words on the data's device.  CUDA
    tensors go to the kernel; CPU tensors to :func:`logp_plain`.
    ``launches`` counts kernel launches."""

    entry = "logp"

    def __call__(self, z, x, y, v, seed, g_flat, h_flat, f_flat):
        if _on_cpu(z):
            return logp_plain(self.cfg, z, x, y, v, seed, g_flat, h_flat, f_flat,
                              self.block_rows)
        _keep, args = self._c_args(z, x, y, v, seed, g_flat, h_flat, f_flat)
        lib = _lib()
        out = torch.empty((z.shape[0],), dtype=torch.float32, device=z.device)
        code = lib.bnn_inkernel_logp(z.data_ptr(), x.data_ptr(), y.data_ptr(), v.data_ptr(),
                                     seed.data_ptr(), out.data_ptr(), z.shape[0], *args,
                                     cuda_stream(z.device))
        check_launch(code, "bnn_inkernel_logp launch", lib.bnn_inkernel_error_string)
        self._count_launch()
        return out


class FusedCausalLogpAndGradBnn(_InkernelKernel):
    """K7's wrapper: ``fn(z, x, y, v, seed, g_flat, h_flat, f_flat) ->
    (neg_logp (n,), d neg_logp / dz (n, z_dim))``.  CUDA tensors go to the
    kernel; CPU tensors to :func:`logp_and_grad_plain`.  ``launches`` counts
    kernel launches."""

    entry = "logp_and_grad"

    def __call__(self, z, x, y, v, seed, g_flat, h_flat, f_flat):
        if _on_cpu(z):
            return logp_and_grad_plain(self.cfg, z, x, y, v, seed, g_flat, h_flat, f_flat,
                                       self.block_rows)
        _keep, args = self._c_args(z, x, y, v, seed, g_flat, h_flat, f_flat)
        lib = _lib()
        n, z_dim = z.shape
        out = torch.empty((n,), dtype=torch.float32, device=z.device)
        grad = torch.empty((n, z_dim), dtype=torch.float32, device=z.device)
        code = lib.bnn_inkernel_logp_and_grad(
            z.data_ptr(), x.data_ptr(), y.data_ptr(), v.data_ptr(), seed.data_ptr(),
            out.data_ptr(), grad.data_ptr(), n, *args, cuda_stream(z.device))
        check_launch(code, "bnn_inkernel_logp_and_grad launch", lib.bnn_inkernel_error_string)
        self._count_launch()
        return out, grad


class FusedMhStepsBnn(_InkernelKernel):
    """K5's wrapper: ``fn(z, x, y, v, seed, q_sd, g_flat, h_flat, f_flat) ->
    (z (n, z_dim), logp (n,), counts (n_steps,))``.

    ``q_sd`` is a one-element float32 tensor on the data's device (read there
    by the kernel, so adaptation never waits on the host).  CUDA tensors go
    to the kernel; CPU tensors to :func:`mh_steps_plain`.  ``launches``
    counts kernel launches."""

    entry = "mh_steps"

    def __init__(self, cfg, g_dims, h_dims, f_dims, n_steps, block_rows):
        super().__init__(cfg, g_dims, h_dims, f_dims, block_rows)
        self.n_steps = int(n_steps)
        if self.n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")

    def __call__(self, z, x, y, v, seed, q_sd, g_flat, h_flat, f_flat):
        if _on_cpu(z):
            return mh_steps_plain(self.cfg, z, x, y, v, seed, q_sd, g_flat, h_flat, f_flat,
                                  self.n_steps, self.block_rows)
        if q_sd.device != z.device or q_sd.dtype != torch.float32 or q_sd.numel() != 1:
            raise ValueError("q_sd: expected a one-element float32 tensor on the data's device")
        _keep, args = self._c_args(z, x, y, v, seed, g_flat, h_flat, f_flat)
        lib = _lib()
        n, z_dim = z.shape
        z_out = torch.empty((n, z_dim), dtype=torch.float32, device=z.device)
        logp = torch.empty((n,), dtype=torch.float32, device=z.device)
        counts = torch.empty((self.n_steps,), dtype=torch.float32, device=z.device)
        code = lib.bnn_inkernel_mh_steps(
            z.data_ptr(), x.data_ptr(), y.data_ptr(), v.data_ptr(), seed.data_ptr(),
            q_sd.data_ptr(), z_out.data_ptr(), logp.data_ptr(), counts.data_ptr(), n,
            *args[:-3], self.n_steps, *args[-3:], cuda_stream(z.device))
        check_launch(code, "bnn_inkernel_mh_steps launch", lib.bnn_inkernel_error_string)
        self._count_launch()
        return z_out, logp, counts


def make_fused_causal_logp_bnn(cfg, g_dims, h_dims, f_dims, block_rows=None):
    """K6 for the nets of ``g_dims``/``h_dims``/``f_dims`` (``[in, ..., out]``).

    Returns ``fn(z, x, y, v, seed, g_flat, h_flat, f_flat) -> (n,)`` with the
    JAX kernel's argument order.  ``block_rows=None`` sizes the row block as
    the JAX builder does (:func:`~bayesgm_torch.ops._pk_util.bnn_block_rows`:
    512 at the flagship width, 2048 for narrow nets)."""
    if block_rows is None:
        block_rows = bnn_block_rows(cfg, g_dims, h_dims, f_dims)
    return FusedCausalLogpBnn(cfg, g_dims, h_dims, f_dims, block_rows)


def make_fused_causal_logp_and_grad_bnn(cfg, g_dims, h_dims, f_dims, block_rows=None):
    """K7: the K6 value and its z-gradient through the same draws.

    Returns ``fn(z, x, y, v, seed, g_flat, h_flat, f_flat) -> (neg_logp (n,),
    d neg_logp/dz (n, z_dim))``.  ``block_rows=None`` sizes the row block as
    the JAX builder does, on a 3 MiB budget with its tape of three arrays per
    layer (256 at the flagship width)."""
    if block_rows is None:
        max_width = max(*g_dims, *h_dims, *f_dims)
        n_deep = max(len(g_dims), len(h_dims), len(f_dims))
        row_bytes = 4 * (sum(cfg.z_dims) + 2 + 2 * (cfg.v_dim + 1) + 3 * max_width * n_deep)
        block_rows = pick_block_rows(row_bytes, budget_bytes=3 * 2**20)
    return FusedCausalLogpAndGradBnn(cfg, g_dims, h_dims, f_dims, block_rows)


def make_fused_mh_steps_bnn(cfg, g_dims, h_dims, f_dims, n_steps, block_rows=None):
    """K5: ``n_steps`` consecutive random-walk MH steps in one launch, q_sd
    frozen for the window.

    Returns ``fn(z, x, y, v, seed, q_sd, g_flat, h_flat, f_flat) -> (z_out
    (n, z_dim), logp_out (n,), accept_counts (n_steps,))``, where
    ``accept_counts[i]`` counts the rows accepted at step ``i``.
    ``block_rows=None`` sizes the row block as the JAX builder does (512 at
    the flagship width)."""
    if block_rows is None:
        max_width = max(*g_dims, *h_dims, *f_dims)
        z_dim = sum(cfg.z_dims)
        row_bytes = 4 * (2 * z_dim + 2 + 2 * (cfg.v_dim + 1) + 4 * max_width)
        block_rows = pick_block_rows(row_bytes)
    return FusedMhStepsBnn(cfg, g_dims, h_dims, f_dims, n_steps, block_rows)
