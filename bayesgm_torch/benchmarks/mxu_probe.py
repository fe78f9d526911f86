"""K8: where does the in-kernel-eps flipout evaluation's time go?  (Port of
``benchmarks/mxu_probe.py``.)

K8 is K6's own device code (``ops/_pk_bnn_inkernel.py``,
``csrc/bnn_inkernel.cu``: one evaluation of K5's register-tiled evaluation)
with one part switched out per variant, the variant a template argument of
that code.  Per layer, with ``P`` the weight of the perturbation product
``((h * r_in) @ P) * r_out``:

  prod       K6 itself (``make_fused_causal_logp_bnn``), the harness check
  base       K6's code through K8's entry point (equals prod bit for bit)
  nopert     ``h @ loc + b``: no perturbation product, no signs, no noise
  noeps      P = sigma * 0.01, signs kept
  epsref     P = sigma * loc (eps read from an input), signs kept
  nosigns    P = sigma * eps, no signs
  xorsign    base, each sign applied by flipping the float's sign bit
  noprng     P = sigma * 0.01, no signs
  blockdiag  base's function as one block-diagonal product per layer
  bf16       base with h, h * r_in, loc and P rounded to bf16; f32 sums

Every variant that draws uses K6's Philox counters, so base, xorsign and
blockdiag see prod's noise.  As the JAX probe, K8 computes a continuous
treatment with learned variances only: a binary or fixed-sigma ``cfg``
raises.  :func:`probe_plain` is each variant's plain PyTorch version and
:func:`make_probe_kernel` the counted wrapper (CUDA tensors to the kernel,
CPU tensors to the plain version); :data:`LAUNCHES` counts each variant's
kernel launches over every wrapper.

The probe times each variant at the flagship paired-predict shape (2n =
40000 rows, v_dim 200, z_dims [1, 1, 1, 7], g [10, 64 x 5, 201], h and f
[., 64, 32, 8, 2], block_rows 512) by the JAX probe's two-length marginal
method: evaluations chained so that each waits for the one before (z moves
by 1e-24 times the previous value), the time of a short chain taken from
that of a long one, CUDA events around both.  One JSON line per variant,
with its bound (the larger of bytes over 3.35 TB/s and operations over the
67 TFLOP/s f32 peak; bf16's products at the 989 TFLOP/s bf16 tensor-core
rate) and the card's name and power limit:

    python -m bayesgm_torch.benchmarks.mxu_probe [--n 20000] [--variants ...]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from types import SimpleNamespace

import torch

from bayesgm_torch.ops._build import check_launch, cuda_stream
from bayesgm_torch.ops._pk_bnn_inkernel import (
    _InkernelKernel,
    _chain_plain,
    _lib,
    _n_layers,
    _on_cpu,
    logp_plain,
    make_fused_causal_logp_bnn,
)
from bayesgm_torch.ops._pk_traced_common import (
    PhiloxDraws,
    _kernel_normal,
    _sign_source,
    neg_log_posterior_rows,
)
from bayesgm_torch.utils.device import card_info, resolve_device

VARIANTS = ("prod", "base", "nopert", "noeps", "epsref", "nosigns", "xorsign", "noprng",
            "blockdiag", "bf16")
KERNEL_VARIANTS = VARIANTS[1:]  # the order of csrc/bnn_inkernel.cu's enum Variant
LAUNCHES = {v: 0 for v in KERNEL_VARIANTS}

_NO_SIGNS = ("nopert", "nosigns", "noprng")
# What P's eps is: drawn, a constant 0.01, loc, or no perturbation at all.
_NOISE = {"prod": "eps", "base": "eps", "nopert": None, "noeps": "const", "epsref": "loc",
          "nosigns": "eps", "xorsign": "eps", "noprng": "const", "blockdiag": "eps",
          "bf16": "eps"}

Z_DIMS = (1, 1, 1, 7)
BLOCK_ROWS = 512  # the JAX probe's, and K6's at the flagship width
# The card's peaks, for the bounds of K1-K8 here and in chip_smoke.py.
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12  # H100 SXM, at the 700 W limit
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores
# Operations per in-kernel normal: half a pair's share of a Philox call (10
# rounds x 4 integer multiplies / 2 pairs), the pair's log, sqrt, sin, cos
# and two products, and the sigma * eps product: (20 + 6) / 2 + 1.
OPS_PER_NORMAL = 14


def _check(variant, cfg):
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; expected one of {VARIANTS}")
    if cfg.binary_treatment or any(s is not None for s in (cfg.sigma_v, cfg.sigma_x,
                                                           cfg.sigma_y)):
        raise ValueError("the probe computes a continuous treatment with learned variances "
                         "only (binary_treatment False, no fixed sigma)")


def _round_bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def probe_plain(variant, cfg, z, x, y, v, seed, g_flat, h_flat, f_flat, block_rows,
                draws=None):
    """Plain PyTorch version of K8's ``variant``: ``(n,)`` negative
    log-posterior.  ``draws`` (default: :class:`PhiloxDraws` of ``seed``)
    supplies the sign words and the eps words, as for K6's
    :func:`~bayesgm_torch.ops._pk_bnn_inkernel.logp_plain` (which prod,
    base, xorsign and blockdiag compute)."""
    _check(variant, cfg)
    draws = PhiloxDraws(seed) if draws is None else draws
    n = z.shape[0]
    n_blocks = -(-n // block_rows)
    flats = (g_flat, h_flat, f_flat)
    noise = _NOISE[variant]

    def chain(ch, h):
        flat = flats[ch]
        max_w = max(max(flat[2 + 3 * i].shape) for i in range(_n_layers(flat)))
        signs = None if variant in _NO_SIGNS else _sign_source(
            lambda group: draws.sign_words(n, max_w, ch, 0, group))

        def eps(i, rows, cols):
            if noise == "eps":
                u1, u2 = draws.eps_words(n_blocks, rows, (cols + 1) // 2, ch, i, 0)
                return _kernel_normal(u1, u2, cols)
            if noise == "loc":
                return flat[2 + 3 * i]
            return torch.full((rows, cols), 0.01, dtype=torch.float32, device=h.device)

        return _chain_plain(h, flat, signs, None if noise is None else eps, block_rows,
                            rnd=_round_bf16 if variant == "bf16" else None)

    return neg_log_posterior_rows(cfg, z, x, y, v, chain)


class ProbeKernel(_InkernelKernel):
    """K8's wrapper for one variant: ``fn(z, x, y, v, seed, g_flat, h_flat,
    f_flat) -> (n,)``.  CUDA tensors go to the kernel; CPU tensors to
    :func:`probe_plain`.  ``launches`` counts kernel launches, and so does
    ``LAUNCHES[variant]``."""

    def __init__(self, variant, cfg, g_dims, h_dims, f_dims, block_rows):
        super().__init__(cfg, g_dims, h_dims, f_dims, block_rows)
        self.variant = variant

    def _count_launch(self):
        self.launches += 1
        LAUNCHES[self.variant] += 1

    def __call__(self, z, x, y, v, seed, g_flat, h_flat, f_flat):
        if _on_cpu(z):
            return probe_plain(self.variant, self.cfg, z, x, y, v, seed, g_flat, h_flat,
                               f_flat, self.block_rows)
        _keep, args = self._c_args(z, x, y, v, seed, g_flat, h_flat, f_flat)
        lib = _lib()
        out = torch.empty((z.shape[0],), dtype=torch.float32, device=z.device)
        code = lib.bnn_inkernel_probe(KERNEL_VARIANTS.index(self.variant), z.data_ptr(),
                                      x.data_ptr(), y.data_ptr(), v.data_ptr(),
                                      seed.data_ptr(), out.data_ptr(), z.shape[0], *args,
                                      cuda_stream(z.device))
        check_launch(code, "bnn_inkernel_probe launch", lib.bnn_inkernel_error_string)
        self._count_launch()
        return out


def make_probe_kernel(variant, cfg, g_dims, h_dims, f_dims, block_rows=BLOCK_ROWS):
    """K8's ``variant`` for the nets of ``g_dims``/``h_dims``/``f_dims``:
    ``fn(z, x, y, v, seed, g_flat, h_flat, f_flat) -> (n,)``, the JAX
    probe's argument order.  ``"prod"`` is K6's own wrapper."""
    _check(variant, cfg)
    if variant == "prod":
        return make_fused_causal_logp_bnn(cfg, g_dims, h_dims, f_dims, block_rows=block_rows)
    return ProbeKernel(variant, cfg, g_dims, h_dims, f_dims, block_rows)


def _build_nets(generator, dims_list):
    """Flat flipout params ``[gamma_eff, beta, (loc, sigma, b) x L]`` per
    chain with the JAX probe's magnitudes: gamma_eff 1, beta 0, loc ~ N(0,
    1) / sqrt(fan_in), sigma 0.0067 (about softplus(-5)), b 0; on the
    generator's device."""
    dev = generator.device
    flats = []
    for dims in dims_list:
        flat = [torch.ones(dims[0], device=dev), torch.zeros(dims[0], device=dev)]
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            loc = torch.randn((fan_in, fan_out), generator=generator, device=dev) / fan_in**0.5
            flat += [loc, torch.full((fan_in, fan_out), 0.0067, device=dev),
                     torch.zeros(fan_out, device=dev)]
        flats.append(flat)
    return flats


def probe_inputs(n, v_dim, device):
    """``(cfg, dims, (z, x, y, v), flats)`` of the probe: the flagship widths
    at ``v_dim``, 2n standard-normal rows (the paired predict's stack) and
    the nets of :func:`_build_nets`, all made on ``device`` from seed 0."""
    cfg = SimpleNamespace(z_dims=Z_DIMS, v_dim=v_dim, sigma_v=None, sigma_x=None,
                          sigma_y=None, binary_treatment=False)
    z_dim = sum(Z_DIMS)
    dims = ([z_dim, 64, 64, 64, 64, 64, v_dim + 1], [2, 64, 32, 8, 2], [3, 64, 32, 8, 2])
    gen = torch.Generator(device).manual_seed(0)
    rows = 2 * n
    data = tuple(torch.randn((rows, d), generator=gen, device=device)
                 for d in (z_dim, 1, 1, v_dim))
    return cfg, dims, data, _build_nets(gen, dims)


def bound(variant, dims, n_rows, block_rows, v_dim, flats):
    """``(bound_ms, bound_by)`` of one evaluation of ``variant``: the larger
    of the bytes (z, x, y, v read, the value written, the weights the
    variant reads) over 3.35 TB/s and the operations over the card's peak:
    two products (one for nopert) of every layer's MACs per row at 67
    TFLOP/s (bf16: 989), plus 14 operations per normal the variant draws,
    once per logical block."""
    macs = sum(a * b for d in dims for a, b in zip(d[:-1], d[1:]))
    flops = (2 if variant == "nopert" else 4) * macs * n_rows
    normals = -(-n_rows // block_rows) * macs if _NOISE[variant] == "eps" else 0
    t_ops = (flops / (BF16_FLOP_PER_S if variant == "bf16" else F32_FLOP_PER_S)
             + OPS_PER_NORMAL * normals / F32_FLOP_PER_S)
    weights = sum(t.numel() for f in flats for j, t in enumerate(f)
                  if not (variant == "nopert" and j >= 2 and (j - 2) % 3 == 1))  # no sigma
    t_bytes = 4 * (n_rows * (sum(Z_DIMS) + 2 + v_dim + 1) + weights) / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def _chain(fn, data, seeds, flats, steps):
    """``steps`` evaluations, each on z moved by 1e-24 times the one before
    (so they run in order): ``(ms, host ms to enqueue them)``, ms from CUDA
    events on the card and from the host clock on the CPU."""
    z, x, y, v = data
    cuda = z.device.type == "cuda"
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for t in range(steps):
        out = fn(z, x, y, v, seeds[t], *flats)
        z = torch.add(z, out[:, None], alpha=1e-24)
    host_ms = 1e3 * (time.perf_counter() - t0)
    if not cuda:
        return host_ms, host_ms
    end.record()
    end.synchronize()
    return start.elapsed_time(end), host_ms


def run_probe(variants=VARIANTS, n=20000, v_dim=200, short=50, long=250, device="cuda"):
    """Time each variant; yields one result dict per variant as it is done.

    Per variant: 3 evaluations (the first builds the kernels), ``short`` to
    warm up, then 3 times a ``short`` and a ``long`` chain; ``ms_per_eval``
    is the median of (t_long - t_short) / (long - short).  The wrapper makes
    3 + 4 short + 3 long launches."""
    dev = resolve_device(device)
    cfg, dims, data, flats = probe_inputs(n, v_dim, dev)
    steps = torch.arange(max(long, 3), dtype=torch.int32)
    seeds = torch.stack([steps, torch.full_like(steps, 17)], dim=1).to(dev)  # [t, 17]
    card = card_info() if dev.type == "cuda" else "cpu"
    base_ms = None
    for variant in variants:
        fn = make_probe_kernel(variant, cfg, *dims, block_rows=BLOCK_ROWS)
        t0 = time.perf_counter()
        _chain(fn, data, seeds, flats, 3)
        first_s = time.perf_counter() - t0
        _chain(fn, data, seeds, flats, short)
        reps, host = [], []
        for _ in range(3):
            t_s, _ = _chain(fn, data, seeds, flats, short)
            t_l, h_l = _chain(fn, data, seeds, flats, long)
            reps.append((t_l - t_s) / (long - short))
            host.append(h_l / long)
        ms = statistics.median(reps)
        if variant == "base":
            base_ms = ms
        b_ms, b_by = bound(variant, dims, 2 * n, BLOCK_ROWS, v_dim, flats)
        yield {"variant": variant, "ms_per_eval": ms, "reps_ms": reps,
               "host_ms_per_eval": statistics.median(host),
               "speedup_vs_base": None if base_ms is None else base_ms / ms,
               "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
               "launches": fn.launches, "first_call_s": first_s, "rows": 2 * n,
               "block_rows": BLOCK_ROWS,
               "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "card": card}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20000, help="subjects; the probe evaluates 2n rows")
    ap.add_argument("--v_dim", type=int, default=200)
    ap.add_argument("--short", type=int, default=50)
    ap.add_argument("--long", type=int, default=250)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.long <= args.short:
        ap.error("--long must exceed --short")
    for line in run_probe(args.variants, args.n, args.v_dim, args.short, args.long,
                          args.device):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")


if __name__ == "__main__":
    main()
