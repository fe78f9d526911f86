"""Roofline accounting for the fused log-posterior kernels (port of
``bayesgm_tpu/utils/roofline.py``).

1. Speed-of-light anchors measured on the device in the same process as the
   work they judge (a card's sustained rates depend on its power limit and
   clocks, so datasheet figures alone do not say what this card reaches):
   - :func:`measure_matmul_peak`: sustained FLOP/s of a chain of large
     square ``torch.matmul``s, f32 with TF32 off (or bf16);
   - :func:`measure_hbm_bandwidth`: sustained bytes/s of an elementwise
     triad (read two f32 arrays, write one: 12 bytes per element).
   Each call is timed with CUDA events on a card (``time.perf_counter`` on
   the CPU, which a caller asks for by name, at tiny sizes in the tests);
   the rate is over the median call after a warm-up.
2. :func:`bnn_eval_cost`: the matmul FLOPs and device-memory bytes per row
   of one fused flipout log-posterior evaluation, from the port's g/h/f
   nets (``dims``): two ``(in x out)`` products per layer (the mean and the
   sign-modulated perturbation), each ``2 in out`` FLOPs.  The noise draws
   and the likelihood reductions are elementwise work that no FLOP count
   here includes.
3. :func:`roofline_report`: achieved FLOP/s, the share of the measured
   matmul peak, and the arithmetic intensity against the ridge, with the
   keys of the JAX package's report.
"""

from __future__ import annotations

import statistics
import time

import torch

from bayesgm_torch.utils.device import resolve_device


def _median_call_s(fn, reps: int, device: torch.device) -> float:
    """Median seconds of ``fn()`` over ``reps`` calls after one warm-up
    call: CUDA events on a card, the host clock (each call synchronous) on
    the CPU."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
    return statistics.median(times)


def measure_matmul_peak(dtype="float32", size: int = 4096, reps: int = 20,
                        device="cuda") -> float:
    """Sustained matmul FLOP/s on ``device``: ``x = x @ b`` chained
    ``reps`` times on ``(size, size)`` operands of ``dtype`` (``"float32"``
    with TF32 off, or ``"bfloat16"``, whose products accumulate in f32 and
    round to bf16 as JAX's ``preferred_element_type`` path does), each call
    timed; ``2 size^3`` over the median call."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=dev).to(dt)
    # scaled so the chain stays finite: each product keeps the entries' scale
    b = (torch.randn((size, size), generator=gen, device=dev) / size**0.5).to(dt)
    state = {"x": a}

    def step():
        state["x"] = torch.matmul(state["x"], b)

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        call_s = _median_call_s(step, reps, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return 2.0 * size**3 / call_s


def measure_hbm_bandwidth(n_floats: int = 2**26, reps: int = 10, device="cuda") -> float:
    """Sustained device-memory bytes/s on ``device``: the f32 triad
    ``y = 0.999 x + b`` over ``n_floats`` elements (read x and b, write y:
    12 bytes each), the two buffers swapped between calls so each call
    reads what the last one wrote; 12 ``n_floats`` over the median call."""
    dev = resolve_device(device)
    bufs = [torch.ones(n_floats, device=dev), torch.empty(n_floats, device=dev)]
    b = torch.full((n_floats,), 2.0, device=dev)

    def step():
        torch.add(b, bufs[0], alpha=0.999, out=bufs[1])
        bufs.reverse()

    return 12.0 * n_floats / _median_call_s(step, reps, dev)


def bnn_eval_cost(nets, v_dim: int, block_rows: int = 512):
    """``(flops_per_row, bytes_per_row)`` of one fused flipout log-posterior
    evaluation of one row, from ``nets["g"]``, ``["h"]`` and ``["f"]`` (any
    port net with ``dims``: ``FlipoutMLP``, ``MLP``).

    FLOPs: per layer two ``(in x out)`` products, ``2 in out`` each.  Bytes:
    the row's v, x, y and z read and its value written once, plus the
    weights (loc, sigma and bias of every layer) read once per block of
    ``block_rows`` rows."""
    dims_total = 0
    weight_floats = 0
    z_in = 0
    for name in ("g", "h", "f"):
        dims = list(nets[name].dims)
        if name == "g":
            z_in = dims[0]
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            dims_total += d_in * d_out
            weight_floats += 2 * d_in * d_out + d_out
    flops_per_row = 2 * 2 * dims_total
    row_bytes = 4 * (v_dim + 2 + z_in + 1)
    weight_bytes_per_row = 4.0 * weight_floats / max(1, block_rows)
    return float(flops_per_row), float(row_bytes + weight_bytes_per_row)


def roofline_report(evals_per_sec, flops_per_row, bytes_per_row, matmul_peak, hbm_bw) -> dict:
    """Achieved matmul FLOP/s at ``evals_per_sec`` row evaluations per
    second, its share of the measured peak, and the arithmetic intensity
    against the ridge (peak FLOP/s over bytes/s)."""
    achieved = evals_per_sec * flops_per_row
    intensity = flops_per_row / bytes_per_row
    ridge = matmul_peak / hbm_bw
    return {
        "achieved_matmul_flops_per_sec": round(achieved, 0),
        "pct_peak_mxu": round(100.0 * achieved / matmul_peak, 2),
        "measured_matmul_peak_flops": round(matmul_peak, 0),
        "measured_hbm_gb_per_sec": round(hbm_bw / 1e9, 1),
        "arithmetic_intensity_flops_per_byte": round(intensity, 1),
        "ridge_flops_per_byte": round(ridge, 1),
        "bound": ("compute" if intensity >= ridge else "memory")
                 + "-side of ridge (matmul flops only; in-kernel PRNG + NLL "
                   "reductions are uncounted VPU work, the actual limiter)",
    }
