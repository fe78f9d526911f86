#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises and exits
non-zero:

1. device   - require CUDA; print the card's name and power limit
              (nvidia-smi) and the torch / CUDA versions;
2. build    - build K1 and K2 (bayesgm_torch/csrc/bnn_hosteps.cu), K3 and
              K4 (bayesgm_torch/csrc/plain.cu) and K5, K6, K7 and K8
              (bayesgm_torch/csrc/bnn_inkernel.cu) with nvcc, one process
              per source, started together;
3. philox   - the kernel's sign words equal the plain Philox words exactly;
4. K1       - kernel vs its plain PyTorch version at the flagship width,
              unpaired (N=20000), plus binary treatment and fixed sigmas at
              a small N;
5. K1 paired- the same at N=40000 (the per-step [proposed; current] stack);
6. K2       - values and z-gradients vs the plain version (autograd) at the
              flagship width, N=32 (a fit batch: the cluster form) and
              N=20000 (one block per 32-row tile), plus binary treatment and
              fixed sigmas at a small N; K2's value equals K1's bit for bit
              and a second launch gives the same bits;
7. timing   - K1 and K2 vs their plain versions, median of CUDA-event times,
              and their device time per launch (CUDA events around one
              launch queued behind a spin kernel, so without the wrapper's
              host time), each with its share of the bound;
8. fit      - bayesgm_torch.CausalBGM(...).fit on Sim_Hirano_Imbens (n=20000,
              v_dim=200, lr_decay cosine): EGM warm start of 200 iterations,
              then 2 passes of 625 batches; checks the losses, the latent
              table, K2's launch count, that mse_x, mse_y and g's own
              objective loss_v (on all rows) fell below the untrained
              model's, and that mse_v stayed within 1 % of it (the 10-dim
              latent explains little of v's 200 columns in so short a fit:
              from 200 EGM iterations it moved by at most 0.2 % in the runs
              measured);
9. predict  - .predict on the fitted model with burn_in=200, n_mcmc=200;
              checks the ADRF, its intervals, the acceptance rate and K1's
              launch count.

The plain-MLP model (use_bnn=False, the widths of the repo's training
benchmark: the same n, v_dim, z_dims and units, random weights from seed
123):

10. K4      - kernel vs its plain version at N=10000 (a predict batch) and
              N=20000, plus binary treatment and fixed sigmas at N=999; a
              second launch gives the same bits; prints K4's row tile;
11. K3      - values and z-gradients vs the plain version (autograd) in both
              of K3's forms: the cluster form at N=32 (a fit batch) and at
              its last row count (the switch, 512), one block per tile at
              the switch + 1 and N=20000, plus binary treatment and fixed
              sigmas at N=32 and N=999; in every case K3's value equals
              K4's bit for bit and a second launch gives the same bits;
12. timing  - K4 (N=10000, 20000) and K3 (N=32, 20000) vs their plain
              versions, with their device time per launch (as phase 7) and
              its share of the bound (K4's targets: 0.05 and 0.10 ms);
13. fit     - the plain model's fit, as phase 8 (EGM 200, 2 passes of 625
              batches): K3 launches == 1250, none of K4;
14. predict - MH on the fitted plain model, burn_in=200, n_mcmc=200, two
              batches of 10000: K4 launches == 2 x (1 + 400), none of K3;
15. MALA    - sampler="mala", burn_in=100, n_mcmc=100: on the plain model K3
              launches == 2 x (1 + 200) (the value is cached), none of K4; on
              the BNN model of phase 8 (one batch of 20000) K2 launches ==
              2 x 200 (both sides evaluated afresh each step).

The in-kernel-eps family (K5-K7) at the flagship width, on the BNN model:

16. draws   - the kernels' sign words, eps, proposal normals and accept
              uniforms for two (step, side) pairs vs the plain Philox draws
              (words and uniforms bit for bit, normals within 1e-6), and
              the two pairs' draws differ;
17. K6      - kernel vs its plain version at N=20000, plus binary treatment
              and fixed sigmas at N=999 (not a multiple of block_rows); a
              second launch gives the same bits;
18. K7      - values and z-gradients vs the plain version (autograd) in both
              of K7's forms: the cluster form at N=32 (a fit batch) and at
              its last row count (the switch, 768), K5's tiles at the switch
              + 1 and N=20000 (a row's gradient may differ only at a
              LeakyReLU kink, at most 0.1 % of the rows); K7's value equals
              K6's bit for bit and a second launch gives the same bits;
19. K5      - a 5-step window and the model's own 50-step window (the
              wrapper predict launches) at N=20000 vs the plain version on
              the same seed: counts per step within 0.1 % of N, at least
              99.9 % of the rows in the same final z, logp of those rows
              within rtol 1e-4 / atol 1e-3; then K5 (50 steps), K6 and K7 vs
              their plain versions, median of CUDA-event times, and the
              device time per launch (as phase 7) of K5, of K6 at N=20000
              (target 0.40 ms) and 2N=40000 and of K7 at N=32 (target 0.12
              ms) and N=20000 (target 0.75 ms), each with its share of the
              bound;
20. window  - predict with params['mh_window_kernel'] on the model fitted
              in phase 8 (burn_in=200, n_mcmc=200): K5 launches == 4, paired
              K1 == 200, unpaired K1 == 1, and over every in-kernel-eps
              wrapper 4 launches of K5's entry point and none of K6's or
              K7's; then, from one init at q_sd=1.0,
              the burn-in acceptance of the window path (sum(counts) /
              (N x 200)) against the per-step paired path's, within four
              standard errors from the per-step rates' spread about their
              50-step window means.

K8, the probe (bayesgm_torch/benchmarks/mxu_probe.py), with its own nets
(gamma_eff 1, beta 0, loc ~ N(0, 1) / sqrt(fan_in), sigma 0.0067, b 0) at
the flagship paired shape, 2N = 40000 rows, block_rows 512:

21. probe   - run_probe over its ten variants (prod = K6, then K8's nine,
              each K6's own code with one part switched out)
              with the two-length timing at 10 vs 50 evaluations: each
              variant's launches == 3 + 4 x 10 + 3 x 50, none of K7's or
              K5's entry points; then each variant's kernel vs its plain
              version within rtol 1e-4 / atol 1e-3 (bf16 too), base == prod
              and xorsign == base bit for bit, blockdiag vs base within the
              same limits, and the plain versions' times; then the same
              comparisons with each weight sigma ~ U(0.05, 0.15), where
              every variant's value must lie over ten limits from nopert's,
              and bf16's from base's (at sigma 0.0067 too).

Launch counts are set to 0 just before each driven path and read just
after; the launches of the comparisons do not count.  The last lines are a
JSON object with the kernels' numbers (each with its bound: the larger of
its bytes over 3.35 TB/s and its operations over the 67 TFLOP/s f32 peak,
the in-kernel-eps kernels' weight noise counted once per logical block), the
card line, and {"ok": true, "device": {...}}.  Imports nothing of JAX nor of
the JAX package.
"""

import json
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

RTOL, ATOL = 1e-4, 1e-3  # f32 summation order over 64-wide dots and the 200-column sum
# K2's z-gradient: f32 dots 64 and 201 wide, through 6 layers forward and 6
# back per chain, each summed in another order than autograd's cuBLAS calls
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-3
N, V_DIM, Z_DIMS = 20000, 200, (1, 1, 1, 7)
BURN_IN, N_MCMC = 200, 200
MALA_BURN_IN, MALA_N_MCMC = 100, 100
PROBE_SHORT, PROBE_LONG = 10, 50  # the probe's two chain lengths (its defaults: 50, 250)
# The probe's nets again with each weight sigma ~ U(0.05, 0.15) in place of
# 0.0067: there the perturbation product (with P = sigma * 0.01 in noeps and
# noprng) moves every variant's value from nopert's by over SEPARATION limits
PROBE_SIGMA, SEPARATION = (0.05, 0.15), 10.0
FIT_BATCH, FIT_EPOCHS, EGM_N_ITER = 32, 1, 200
PLAIN_BS = 10000  # predict's subject batch for plain nets (bs=None)
SPIN_CYCLES = 5_000_000  # ~2.5 ms of spin ahead of a timed call: longer than any wrapper's host time


def flagship_params(output_dir, use_bnn=True):
    return dict(v_dim=V_DIM, z_dims=list(Z_DIMS), binary_treatment=False,
                dataset="chip_smoke", output_dir=output_dir, use_bnn=use_bnn,
                save_res=False, save_model=False, lr_decay="cosine")


def bound(n_bytes, flops):
    """``(bound_ms, bound_by)``: the least time the card could take, at the
    peaks the probe's bounds use."""
    from bayesgm_torch.benchmarks import mxu_probe as mp

    t_bytes, t_ops = n_bytes / mp.HBM_BYTES_PER_S, flops / mp.F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def chain_macs(dims):
    """Multiply-adds per row of the three chains' dense layers."""
    return sum(a * b for d in dims for a, b in zip(d[:-1], d[1:]))


def row_bytes(n, with_grad):
    """Bytes of n rows read (z, x, y, v) and written (the value, and the
    z-gradient with_grad)."""
    z_dim = sum(Z_DIMS)
    return 4 * n * (z_dim + 2 + V_DIM + 1 + (z_dim if with_grad else 0))


def compare(name, got, want, rtol=RTOL, atol=ATOL):
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite kernel output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
    print(f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(rtol={rtol}, atol={atol}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return max_abs


def compare_grad_at_kinks(name, got, want, kinks):
    """z-gradients of a kernel against its plain version, row by row: a row
    may fall outside (GRAD_RTOL, GRAD_ATOL) only where ``kinks`` marks a
    hidden pre-activation within 1e-5 of 0 (LeakyReLU's slope there depends
    on the last bit), and at most 0.1 % of the rows may.  Returns the
    maximum absolute error over all rows."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape or non-finite kernel output")
    err = (got - want).abs()
    off = (err > GRAD_ATOL + GRAD_RTOL * want.abs()).any(dim=1)
    n_off, n_kink = int(off.sum()), int((off & kinks).sum())
    inside = float(err[~off].max()) if bool((~off).any()) else 0.0
    ok = n_off == n_kink and n_off <= 1e-3 * got.shape[0]
    print(f"{name}: max_abs_err={float(err.max()):.3e} ({inside:.3e} over the rows within "
          f"rtol={GRAD_RTOL}, atol={GRAD_ATOL}); rows outside: {n_off}, of them at a LeakyReLU "
          f"kink (|pre-activation| < 1e-5 in the plain version): {n_kink}; rows with such a "
          f"kink: {int(kinks.sum())} of {got.shape[0]} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return float(err.max())


def time_ms(fn, n_warm=3, n_iter=25):
    """Median of per-launch CUDA-event times, after warm-up."""
    import torch

    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_iter):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n_warm=3, n_iter=20):
    """Device time per call of ``fn``: the median of CUDA-event times around
    one call queued behind a spin kernel (``torch.cuda._sleep``), so that the
    card runs the start event, the call's kernels and the end event back to
    back, without the wrapper's host time between them.  (torch.profiler's
    records of short sessions came back incomplete: a 0.10 ms kernel read
    0.06 ms, a 35 ms one not at all.)"""
    import torch

    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_iter):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np

    from bayesgm_torch import CausalBGM, Sim_Hirano_Imbens_sampler
    from bayesgm_torch.benchmarks import mxu_probe as mp
    from bayesgm_torch.models.causalbgm import MH_WINDOW, _apply, _loss_v
    from bayesgm_torch.ops._build import load_library
    from bayesgm_torch.ops._pk_bnn_hosteps import (
        logp_and_grad_plain,
        logp_plain,
        make_fused_causal_logp_and_grad_bnn_hosteps,
        make_fused_causal_logp_bnn_hosteps,
        sign_words_cuda,
    )
    from bayesgm_torch.ops._pk_plain import logp_and_grad_plain as plain_logp_and_grad
    from bayesgm_torch.ops._pk_plain import logp_plain as plain_logp
    from bayesgm_torch.ops._pk_plain import (
        k3_cluster_max_rows,
        k4_tile_rows,
        make_fused_causal_logp,
        make_fused_causal_logp_and_grad,
    )
    from bayesgm_torch.ops import _pk_bnn_inkernel as ik
    from bayesgm_torch.ops import mcmc
    from bayesgm_torch.ops._pk_traced_common import (
        PhiloxDraws,
        _kernel_normal,
        _kernel_uniform,
        philox_sign_words,
    )
    from bayesgm_torch.ops._pk_util import (
        flatten_flipout_params,
        flatten_mlp_params,
        flipout_step_perturbations,
        split_flipout_flat,
    )
    from bayesgm_torch.utils.device import card_info

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {card}", flush=True)

    # 2. build, one nvcc per source, all started together
    with ThreadPoolExecutor() as pool:
        libs = list(pool.map(load_library, ("bnn_hosteps.cu", "plain.cu", "bnn_inkernel.cu")))
    for lib in libs:
        ptxas = [l.strip() for l in lib.build_log.splitlines() if "registers" in l or "spill" in l]
        print(f"[2 build] {lib.path.name} in {lib.build_s:.1f} s; " + " | ".join(ptxas), flush=True)

    # Flagship model (port init, seed 123) and data.
    ds = Sim_Hirano_Imbens_sampler(batch_size=32, N=N, v_dim=V_DIM, seed=0)
    data_np = ds.load_all()
    with tempfile.TemporaryDirectory() as out_dir:
        model = CausalBGM(flagship_params(out_dir), random_seed=123, device="cuda")
    cfg = model.cfg
    dims = [model.nets[k].dims for k in "ghf"]
    ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(model.nets[k])) for k in "ghf"))
    sigs = sum(sigs, [])
    x, y, v = (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in data_np)
    gen = torch.Generator(device=dev).manual_seed(7)
    z = torch.randn((N, sum(Z_DIMS)), generator=gen, device=dev)
    seed = torch.randint(0, 2**31 - 1, (2,), generator=gen, device=dev, dtype=torch.int32)

    # 3. philox
    for chain, d in enumerate(dims):
        got = sign_words_cuda(seed, 2 * N, max(d), chain)
        want = philox_sign_words(seed, 2 * N, max(d), chain)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"philox words differ on chain {chain}: "
                                 f"{int((got != want).sum())} of {got.numel()}")
    print(f"[3 philox] kernel words == plain words at ({2 * N}, max_w) for chains g/h/f", flush=True)

    # 4. K1 unpaired at the flagship width, then the variants at small N
    fused = make_fused_causal_logp_bnn_hosteps(cfg, *dims)
    ps = flipout_step_perturbations(sigs, gen)
    args1 = (z, x, y, v, seed, *ws, ps)
    err1 = compare(f"[4 K1 unpaired N={N}]", fused(*args1), logp_plain(cfg, *args1))
    n_small = 999  # not a multiple of the 32-row tile: exercises the masked tail
    xb = (x[:n_small] > x[:n_small].median()).to(torch.float32)
    for label, var_cfg, xs in (
            ("binary_treatment", cfg._replace(binary_treatment=True), xb),
            ("fixed sigma_v", cfg._replace(sigma_v=0.5), x[:n_small]),
            ("fixed sigma_v/x/y", cfg._replace(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3),
             x[:n_small])):
        k_var = make_fused_causal_logp_bnn_hosteps(var_cfg, *dims)
        a = (z[:n_small].contiguous(), xs.contiguous(), y[:n_small].contiguous(),
             v[:n_small].contiguous(), seed, *ws, ps)
        compare(f"[4 K1 {label} N={n_small}]", k_var(*a), logp_plain(var_cfg, *a))

    # 5. K1 paired at 2N
    fused2 = make_fused_causal_logp_bnn_hosteps(cfg, *dims, paired=True)
    ps2 = flipout_step_perturbations(sigs, gen, n_sets=2)
    z2 = torch.cat([z + 0.1 * torch.randn(z.shape, generator=gen, device=dev), z])
    d2 = tuple(torch.cat([a, a]) for a in (x, y, v))
    args2 = (z2, *d2, seed, *ws, ps2)
    err2 = compare(f"[5 K1 paired N={2 * N}]", fused2(*args2), logp_plain(cfg, *args2))

    # 6. K2: values and z-gradients at the fit batch and at N, then the variants
    fused_g = make_fused_causal_logp_and_grad_bnn_hosteps(cfg, *dims)
    k2_errs, k2_args = [], {}
    for n_k2 in (FIT_BATCH, N):
        a = (z[:n_k2].contiguous(), x[:n_k2].contiguous(), y[:n_k2].contiguous(),
             v[:n_k2].contiguous(), seed, *ws, ps)
        k2_args[n_k2] = a
        (neg_k, grad_k), (neg_p, grad_p) = fused_g(*a), logp_and_grad_plain(cfg, *a)
        k2_errs.append(compare(f"[6 K2 value N={n_k2}]", neg_k, neg_p))
        k2_errs.append(compare(f"[6 K2 grad N={n_k2}]", grad_k, grad_p, GRAD_RTOL, GRAD_ATOL))
        if not torch.equal(neg_k, fused(*a)):
            raise AssertionError(f"[6 K2 N={n_k2}]: K2's value differs from K1's")
        neg_k2, grad_k2 = fused_g(*a)
        if not (torch.equal(neg_k2, neg_k) and torch.equal(grad_k2, grad_k)):
            raise AssertionError(f"[6 K2 N={n_k2}]: two launches differ")
    print("[6 K2] value == K1's value bit for bit; two launches give the same bits", flush=True)
    for label, var_cfg, xs in (
            ("binary_treatment", cfg._replace(binary_treatment=True), xb),
            ("fixed sigma_v", cfg._replace(sigma_v=0.5), x[:n_small]),
            ("fixed sigma_v/x/y", cfg._replace(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3),
             x[:n_small])):
        k_var = make_fused_causal_logp_and_grad_bnn_hosteps(var_cfg, *dims)
        a = (z[:n_small].contiguous(), xs.contiguous(), y[:n_small].contiguous(),
             v[:n_small].contiguous(), seed, *ws, ps)
        (neg_k, grad_k), (neg_p, grad_p) = k_var(*a), logp_and_grad_plain(var_cfg, *a)
        compare(f"[6 K2 {label} value N={n_small}]", neg_k, neg_p)
        compare(f"[6 K2 {label} grad N={n_small}]", grad_k, grad_p, GRAD_RTOL, GRAD_ATOL)

    # 7. timing, and each time's share of the bound (K1 unpaired at N, paired
    # at 2N; K2 at the fit batch and at N)
    bnn_macs = chain_macs(dims)
    bnn_w = sum(t.numel() for w in ws for t in w)
    bnn_p = sum(p.numel() for p in ps)  # one eps set of P
    b_k1u = bound(row_bytes(N, False) + 4 * (bnn_w + bnn_p), N * 4 * bnn_macs)
    b_k1 = bound(row_bytes(2 * N, False) + 4 * (bnn_w + 2 * bnn_p), 2 * N * 4 * bnn_macs)
    b_g = {n_k2: bound(row_bytes(n_k2, True) + 4 * (bnn_w + bnn_p), n_k2 * 8 * bnn_macs)
           for n_k2 in k2_args}
    t_k1 = time_ms(lambda: fused(*args1))
    t_p1 = time_ms(lambda: logp_plain(cfg, *args1))
    t_k2 = time_ms(lambda: fused2(*args2))
    t_p2 = time_ms(lambda: logp_plain(cfg, *args2))
    t_g = {n_k2: (time_ms(lambda: fused_g(*a)), time_ms(lambda: logp_and_grad_plain(cfg, *a)))
           for n_k2, a in k2_args.items()}
    d_k1, d_k2 = device_ms(lambda: fused(*args1)), device_ms(lambda: fused2(*args2))
    d_g = {n_k2: device_ms(lambda: fused_g(*a)) for n_k2, a in k2_args.items()}
    rows = [("K1 unpaired N=20000", t_k1, t_p1, d_k1, b_k1u),
            ("K1 paired N=40000", t_k2, t_p2, d_k2, b_k1)]
    rows += [(f"K2 N={n_k2}", tk, tp, d_g[n_k2], b_g[n_k2]) for n_k2, (tk, tp) in t_g.items()]
    for label, tk, tp, td, (b_ms, b_by) in rows:
        note = "" if tk <= tp else "  (kernel SLOWER than the plain version)"
        print(f"[7 timing] {label}: kernel {tk:.4f} ms (device {td:.4f} ms), plain {tp:.4f} ms, "
              f"plain/kernel {tp / tk:.2f}x; bound {b_ms:.6f} ms ({b_by}), device time at "
              f"{100 * b_ms / td:.2f} % of it{note}", flush=True)

    # 8. fit at the flagship width, from the untrained model of phases 4-7
    def drive_fit(tag, fit_model, grad_name, check_mse_v):
        """Fit ``fit_model`` (EGM 200, 2 passes), time its spans, check it
        and return the kernels' launch counts of the fit."""
        mcfg = fit_model.cfg
        eval_gen = torch.Generator(device=dev).manual_seed(11)
        mse_x0, mse_y0, mse_v0 = (float(t) for t in
                                  fit_model.evaluate(data_np, generator=eval_gen)[1:])

        def full_loss_v(z=None):
            """g's training objective (-log p(V|Z) mean + KL term) on all N
            rows, at z = e(V) when no table is given, under a seeded draw."""
            g = torch.Generator(device=dev).manual_seed(13)
            with torch.no_grad():
                if z is None:
                    z = _apply(mcfg, fit_model.nets["e"], v, g)
                return float(_loss_v(mcfg, fit_model.nets["g"], z, v, g)[0])

        loss_v0 = full_loss_v()
        spans = {"egm": 0.0, "evaluate": 0.0}

        def timed(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                spans[name] += time.perf_counter() - t
                return out
            return run

        fit_model.egm_init = timed("egm", fit_model.egm_init)
        fit_model.evaluate = timed("evaluate", fit_model.evaluate)
        for k in fit_model.kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_model.fit(data_np, epochs=FIT_EPOCHS, epochs_per_eval=1, batch_size=FIT_BATCH,
                      use_egm_init=True, egm_n_iter=EGM_N_ITER, egm_batches_per_eval=100,
                      verbose=0)
        torch.cuda.synchronize()
        fit_wall = time.perf_counter() - t0
        fit_launches = {name: k.launches for name, k in fit_model.kernels.items()}
        n_steps = (FIT_EPOCHS + 1) * (N // FIT_BATCH)
        train_s = fit_wall - spans["egm"] - spans["evaluate"]
        mse_x1, mse_y1, mse_v1 = (float(t) for t in fit_model.evaluate(
            data_np, fit_model.data_z, generator=eval_gen)[1:])
        loss_v1 = full_loss_v(fit_model.data_z)
        print(f"[{tag}] n={N}: wall {fit_wall:.3f} s; EGM {spans['egm']:.3f} s "
              f"({1e3 * spans['egm'] / (EGM_N_ITER + 1):.3f} ms/iteration of "
              f"{mcfg.g_d_freq} critic + 1 generator steps); training "
              f"{train_s:.3f} s ({1e3 * train_s / n_steps:.3f} ms/step over {n_steps} steps); "
              f"evaluations {spans['evaluate']:.3f} s; launches {fit_launches}", flush=True)
        print(f"[{tag}] mse_x {mse_x0:.4f} -> {mse_x1:.4f}, mse_y {mse_y0:.4f} -> {mse_y1:.4f}, "
              f"mse_v {mse_v0:.6f} -> {mse_v1:.6f}, g's loss_v {loss_v0:.4f} -> {loss_v1:.4f} "
              f"(untrained e(V) -> fitted table); last EGM losses {fit_model.egm_losses}; "
              f"last step losses {fit_model.fit_losses}", flush=True)
        losses = list(fit_model.egm_losses.values()) + list(fit_model.fit_losses.values())
        others = sum(n for name, n in fit_launches.items() if name != grad_name)
        checks = {
            "losses finite": bool(np.all(np.isfinite(losses))),
            "data_z (20000, 10) and finite": (tuple(fit_model.data_z.shape) == (N, sum(Z_DIMS))
                                              and bool(torch.isfinite(fit_model.data_z).all())),
            f"{grad_name} launches == {n_steps}": fit_launches[grad_name] == n_steps,
            "no other kernel launch in fit": others == 0,
            "mse_x fell": mse_x1 < mse_x0,
            "mse_y fell": mse_y1 < mse_y0,
            "g's loss_v fell": loss_v1 < loss_v0,
            "best and SWA snapshots made": (fit_model.best_nets is not None
                                            and fit_model.swa_nets is not None),
        }
        if check_mse_v:
            checks["mse_v within 1 % of the untrained model's"] = mse_v1 < 1.01 * mse_v0
        for name, ok in checks.items():
            print(f"[{tag}] {name}: {'ok' if ok else 'FAIL'}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"[{tag}] fit checks failed")
        del fit_model.egm_init, fit_model.evaluate
        return fit_launches

    def drive_predict(tag, pred_model, want, sampler="mh", burn_in=BURN_IN, n_mcmc=N_MCMC):
        """Predict on ``pred_model``, check the ADRF and the launch counts
        ``want`` ({kernel name: launches}) and return all the counts: the
        model's kernels by name, and the in-kernel-eps entry points over
        every wrapper as ``bnn_inkernel_<entry>``."""
        for k in pred_model.kernels.values():
            k.launches = 0
        for entry in ik.LAUNCHES:
            ik.LAUNCHES[entry] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adrf, ci, diag = pred_model.predict(data_np, x_values=np.linspace(0, 3, 20),
                                            alpha=0.01, burn_in=burn_in, n_mcmc=n_mcmc,
                                            q_sd=1.0, sampler=sampler, return_diagnostics=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in pred_model.kernels.items()}
        launches.update({f"bnn_inkernel_{entry}": n for entry, n in ik.LAUNCHES.items()})
        rate = diag["accept_rate"]
        print(f"[{tag}] n={N}: wall {wall:.3f} s for {burn_in + n_mcmc} {sampler.upper()} steps "
              f"({1e3 * wall / (burn_in + n_mcmc):.3f} ms/step incl. collector and set-up); "
              f"accept {rate:.4f}; launches {launches}", flush=True)
        print(f"[{tag}] ADRF {np.array2string(adrf, precision=4)}", flush=True)
        checks = {
            "adrf shape (20,)": adrf.shape == (20,),
            "adrf finite": bool(np.all(np.isfinite(adrf))),
            "intervals finite and ordered": bool(np.all(np.isfinite(ci))
                                                 and np.all(ci[:, 0] <= ci[:, 1])),
            "acceptance in (0, 1)": 0.0 < rate < 1.0,
        }
        for name, n in launches.items():
            checks[f"{name} launches == {want.get(name, 0)}"] = n == want.get(name, 0)
        for name, ok in checks.items():
            print(f"[{tag}] {name}: {'ok' if ok else 'FAIL'}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"[{tag}] predict checks failed")
        return launches

    fit_model = model
    fit_launches = drive_fit("8 fit", fit_model, "bnn_hosteps_grad", check_mse_v=True)

    # 9. predict on the fitted model: one batch of N rows, K1 once for the
    # initial state and one paired launch per step
    n_launch = 1 + BURN_IN + N_MCMC
    drive_predict("9 predict", fit_model, {"bnn_hosteps": 1, "bnn_hosteps_paired": n_launch - 1})

    # The plain-MLP model (use_bnn=False) at the same widths.
    with tempfile.TemporaryDirectory() as out_dir:
        plain_model = CausalBGM(flagship_params(out_dir, use_bnn=False), random_seed=123,
                                device="cuda")
    pcfg = plain_model.cfg
    pdims = [plain_model.nets[k].dims for k in "ghf"]
    flats = [flatten_mlp_params(plain_model.nets[k]) for k in "ghf"]
    k4 = make_fused_causal_logp(pcfg, *pdims)
    k3 = make_fused_causal_logp_and_grad(pcfg, *pdims)
    variants = (("binary_treatment", pcfg._replace(binary_treatment=True), xb),
                ("fixed sigma_v", pcfg._replace(sigma_v=0.5), x[:n_small]),
                ("fixed sigma_v/x/y", pcfg._replace(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3),
                 x[:n_small]))

    def rows(n_rows, xs=None):
        return (z[:n_rows].contiguous(), (x[:n_rows] if xs is None else xs).contiguous(),
                y[:n_rows].contiguous(), v[:n_rows].contiguous(), *flats)

    # 10. K4 at a predict batch and at N, then the variants
    k4_errs, k4_args = [], {n_k: rows(n_k) for n_k in (PLAIN_BS, N)}
    for n_k, a in k4_args.items():
        out4 = k4(*a)
        k4_errs.append(compare(f"[10 K4 N={n_k}]", out4, plain_logp(pcfg, *a)))
        if not torch.equal(k4(*a), out4):
            raise AssertionError(f"[10 K4 N={n_k}]: two launches differ")
    print(f"[10 K4] a tile of {k4_tile_rows()} rows per block; two launches give the same bits",
          flush=True)
    for label, var_cfg, xs in variants:
        a = rows(n_small, xs)
        k4_errs.append(compare(f"[10 K4 {label} N={n_small}]",
                               make_fused_causal_logp(var_cfg, *pdims)(*a),
                               plain_logp(var_cfg, *a)))

    # 11. K3 in both forms: the cluster form up to the switch, one block per
    # tile past it; the variants in each
    switch = k3_cluster_max_rows()
    k3_errs, k3_args = [], {n_k: rows(n_k) for n_k in (FIT_BATCH, N)}
    k3_cases = [(f"N={n_k}", pcfg, rows(n_k)) for n_k in (FIT_BATCH, switch, switch + 1, N)]
    k3_cases += [(f"{name} N={n_v}", c, rows(n_v, xs[:n_v]))
                 for n_v in (FIT_BATCH, n_small) for name, c, xs in variants]
    for label, var_cfg, a in k3_cases:
        k3_var = make_fused_causal_logp_and_grad(var_cfg, *pdims)
        neg_k, grad_k = k3_var(*a)
        neg_p, grad_p = plain_logp_and_grad(var_cfg, *a)
        form = "cluster" if a[0].shape[0] <= switch else "one block per tile"
        k3_errs.append(compare(f"[11 K3 value {label} ({form})]", neg_k, neg_p))
        k3_errs.append(compare(f"[11 K3 grad {label} ({form})]", grad_k, grad_p, GRAD_RTOL,
                               GRAD_ATOL))
        if not torch.equal(neg_k, make_fused_causal_logp(var_cfg, *pdims)(*a)):
            raise AssertionError(f"[11 K3 {label}]: K3's value differs from K4's")
        neg_2, grad_2 = k3_var(*a)
        if not (torch.equal(neg_2, neg_k) and torch.equal(grad_2, grad_k)):
            raise AssertionError(f"[11 K3 {label}]: two launches differ")
    print(f"[11 K3] value == K4's value bit for bit in both forms (the cluster form up to "
          f"{switch} rows); two launches give the same bits", flush=True)

    # 12. timing, device time and each time's share of the bound
    plain_macs = chain_macs(pdims)
    plain_w = sum(t.numel() for f in flats for t in f)
    b_k4 = {n_k: bound(row_bytes(n_k, False) + 4 * plain_w, n_k * 2 * plain_macs)
            for n_k in k4_args}
    b_k3 = {n_k: bound(row_bytes(n_k, True) + 4 * plain_w, n_k * 4 * plain_macs)
            for n_k in k3_args}
    t_k4 = {n_k: (time_ms(lambda: k4(*a)), time_ms(lambda: plain_logp(pcfg, *a)))
            for n_k, a in k4_args.items()}
    t_k3 = {n_k: (time_ms(lambda: k3(*a)), time_ms(lambda: plain_logp_and_grad(pcfg, *a)))
            for n_k, a in k3_args.items()}
    d_k4 = {n_k: device_ms(lambda: k4(*a)) for n_k, a in k4_args.items()}
    d_k3 = {n_k: device_ms(lambda: k3(*a)) for n_k, a in k3_args.items()}
    for label, (tk, tp), td, (b_ms, b_by) in (
            [(f"K4 N={n_k}", t, d_k4[n_k], b_k4[n_k]) for n_k, t in t_k4.items()]
            + [(f"K3 N={n_k}", t, d_k3[n_k], b_k3[n_k]) for n_k, t in t_k3.items()]):
        note = "" if tk <= tp else "  (kernel SLOWER than the plain version)"
        print(f"[12 timing] {label}: kernel {tk:.4f} ms (device {td:.4f} ms), plain {tp:.4f} ms, "
              f"plain/kernel {tp / tk:.2f}x; bound {b_ms:.6f} ms ({b_by}), device time at "
              f"{100 * b_ms / td:.2f} % of it{note}", flush=True)

    # 13. fit of the plain model; 14. MH predict on it, two batches of PLAIN_BS,
    # K4 once for each batch's initial state and once per step
    plain_fit_launches = drive_fit("13 fit plain", plain_model, "plain_grad", check_mse_v=False)
    n_batches = -(-N // PLAIN_BS)
    plain_mh = drive_predict("14 predict plain", plain_model,
                             {"plain": n_batches * (1 + BURN_IN + N_MCMC)})

    # 15. MALA: plain nets cache the value (K3 once per batch, then once per
    # step); BNN nets evaluate both sides afresh each step (K2 twice per step)
    mala_steps = MALA_BURN_IN + MALA_N_MCMC
    mala_kw = dict(sampler="mala", burn_in=MALA_BURN_IN, n_mcmc=MALA_N_MCMC)
    drive_predict("15 MALA plain", plain_model, {"plain_grad": n_batches * (1 + mala_steps)},
                  **mala_kw)
    drive_predict("15 MALA BNN", fit_model, {"bnn_hosteps_grad": 2 * mala_steps}, **mala_kw)

    # 16. draws of the in-kernel-eps family: the kernels' against the plain
    # Philox draws for two (step, side) pairs, and the pairs differ
    d_cuda, d_plain = ik.DrawsCuda(seed), PhiloxDraws(seed)
    draw_sets = {}
    for step, side in ((0, 0), (1, 1)):
        ev = 2 * step + side
        got = (d_cuda.sign_words(N, max(dims[0]), 0, ev), d_cuda.eps(3, 64, 201, 0, 5, ev),
               d_cuda.proposal(N, sum(Z_DIMS), step), d_cuda.accept(N, step))
        want = (d_plain.sign_words(N, max(dims[0]), 0, ev),
                _kernel_normal(*d_plain.eps_words(3, 64, 101, 0, 5, ev), 201),
                _kernel_normal(*d_plain.proposal_words(N, (sum(Z_DIMS) + 1) // 2, step),
                               sum(Z_DIMS)),
                _kernel_uniform(d_plain.accept_words(N, step)))
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])):
            raise AssertionError(f"[16 draws] step {step} side {side}: words or uniforms differ")
        errs = [float((g - w).abs().max()) for g, w in zip(got[1:3], want[1:3])]
        print(f"[16 draws] step {step} side {side}: sign words and accept uniforms equal; "
              f"max |eps - plain| {errs[0]:.3e}, max |proposal - plain| {errs[1]:.3e} "
              f"(limit 1e-6 + 1e-6 |x|)", flush=True)
        for name, g, w in zip(("eps", "proposal"), got[1:3], want[1:3]):
            if not torch.allclose(g, w, rtol=1e-6, atol=1e-6):
                raise AssertionError(f"[16 draws] {name} at step {step} side {side} disagrees")
        draw_sets[(step, side)] = got
    differ = [not torch.equal(a, b) for a, b in zip(*draw_sets.values())]
    print(f"[16 draws] (0, 0) vs (1, 1) differ: signs {differ[0]}, eps {differ[1]}, "
          f"proposals {differ[2]}, uniforms {differ[3]}", flush=True)
    if not all(differ):
        raise AssertionError("[16 draws] two (step, side) pairs drew the same values")

    # 17. K6 at N on the fitted model, then the variants at a small N
    iflats = [flatten_flipout_params(fit_model.nets[k]) for k in "ghf"]
    k6 = ik.make_fused_causal_logp_bnn(cfg, *dims)
    a6 = (z, x, y, v, seed, *iflats)
    out6 = k6(*a6)
    err6 = [compare(f"[17 K6 N={N} block_rows={k6.block_rows}]", out6,
                    ik.logp_plain(cfg, *a6, k6.block_rows))]
    if not torch.equal(k6(*a6), out6):
        raise AssertionError("[17 K6]: two launches differ")
    print("[17 K6] two launches give the same bits", flush=True)
    for label, var_cfg, xs in (
            ("binary_treatment", cfg._replace(binary_treatment=True), xb),
            ("fixed sigma_v/x/y", cfg._replace(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3),
             x[:n_small])):
        a = (z[:n_small].contiguous(), xs.contiguous(), y[:n_small].contiguous(),
             v[:n_small].contiguous(), seed, *iflats)
        err6.append(compare(f"[17 K6 {label} N={n_small}]",
                            ik.make_fused_causal_logp_bnn(var_cfg, *dims)(*a),
                            ik.logp_plain(var_cfg, *a, k6.block_rows)))

    # 18. K7 in both forms (the cluster form up to the switch, K5's tiles
    # past it): values and z-gradients; its value is K6's at K7's row block
    k7 = ik.make_fused_causal_logp_and_grad_bnn(cfg, *dims)
    k6_at_k7 = ik.make_fused_causal_logp_bnn(cfg, *dims, block_rows=k7.block_rows)
    k7_switch = ik.k7_cluster_max_rows()
    if ik._lib().bnn_inkernel_grad_cluster_max_rows() != k7_switch:
        raise AssertionError("[18 K7] the library's switch differs from its source's")
    err7, k7_args = [], {}
    for n_k in (FIT_BATCH, k7_switch, k7_switch + 1, N):
        form = "cluster" if n_k <= k7_switch else "tiles"
        a = (z[:n_k].contiguous(), x[:n_k].contiguous(), y[:n_k].contiguous(),
             v[:n_k].contiguous(), seed, *iflats)
        k7_args[n_k] = a
        (neg_k, grad_k), (neg_p, grad_p) = k7(*a), ik.logp_and_grad_plain(cfg, *a, k7.block_rows)
        err7.append(compare(f"[18 K7 {form} value N={n_k} block_rows={k7.block_rows}]", neg_k,
                            neg_p))
        err7.append(compare_grad_at_kinks(f"[18 K7 {form} grad N={n_k}]", grad_k, grad_p,
                                          ik.kink_rows(cfg, *a, k7.block_rows)))
        if not torch.equal(neg_k, k6_at_k7(*a)):
            raise AssertionError(f"[18 K7 N={n_k}]: K7's value differs from K6's")
        neg_2, grad_2 = k7(*a)
        if not (torch.equal(neg_2, neg_k) and torch.equal(grad_2, grad_k)):
            raise AssertionError(f"[18 K7 N={n_k}]: two launches differ")
    print(f"[18 K7] value == K6's value bit for bit and two launches give the same bits in "
          f"both forms (cluster up to {k7_switch} rows)", flush=True)

    # 19. K5: a 5-step window and the model's own 50-step window against the
    # plain version, then the timings
    q_sd = torch.tensor(1.0, device=dev)
    a5 = (z, x, y, v, seed, q_sd, *iflats)
    err5, same_share = [], {}
    k5 = fit_model.kernels["bnn_mh_window"]
    for k5_check in (ik.make_fused_mh_steps_bnn(cfg, *dims, n_steps=5), k5):
        n_st, tag = k5_check.n_steps, f"[19 K5 N={N} {k5_check.n_steps} steps]"
        (z_k, lp_k, c_k), (z_p, lp_p, c_p) = k5_check(*a5), ik.mh_steps_plain(
            cfg, *a5, n_st, k5_check.block_rows)
        torch.cuda.synchronize()
        same = (z_k - z_p).abs().max(dim=1).values <= 1e-5
        same_share[n_st] = float(same.float().mean())
        count_gap = float((c_k - c_p).abs().max())
        err5.append(compare(f"{tag} logp of the rows in the same state", lp_k[same], lp_p[same]))
        print(f"{tag} block_rows={k5_check.block_rows}: counts kernel {c_k.int().tolist()} "
              f"plain {c_p.int().tolist()} (max gap {count_gap:.0f}, limit {1e-3 * N:.0f}); "
              f"rows in the same final z (within 1e-5): {100 * same_share[n_st]:.3f} % "
              f"(limit 99.9 %)", flush=True)
        if count_gap > 1e-3 * N or same_share[n_st] < 0.999:
            raise AssertionError(f"{tag} the window disagrees with its plain version")
    t_k5 = (time_ms(lambda: k5(*a5), n_warm=1, n_iter=5),  # the check warmed the plain one
            time_ms(lambda: ik.mh_steps_plain(cfg, *a5, MH_WINDOW, k5.block_rows), 0, 3))
    d_k5 = device_ms(lambda: k5(*a5), n_warm=1, n_iter=5)
    t_k6 = (time_ms(lambda: k6(*a6)), time_ms(lambda: ik.logp_plain(cfg, *a6, k6.block_rows)))
    t_k7 = {n_k: (time_ms(lambda: k7(*k7_args[n_k])),
                  time_ms(lambda: ik.logp_and_grad_plain(cfg, *k7_args[n_k], k7.block_rows)))
            for n_k in (FIT_BATCH, N)}
    for label, (tk, tp) in ([(f"K5 {MH_WINDOW}-step window N={N}", t_k5), (f"K6 N={N}", t_k6)]
                            + [(f"K7 N={n_k}", t) for n_k, t in t_k7.items()]):
        note = "" if tk <= tp else "  (kernel SLOWER than the plain version)"
        print(f"[19 timing] {label}: kernel {tk:.4f} ms, plain {tp:.4f} ms, "
              f"plain/kernel {tp / tk:.2f}x{note}", flush=True)
    print(f"[19 timing] K5: device {d_k5:.4f} ms per {MH_WINDOW}-step launch (CUDA events "
          f"{t_k5[0]:.4f} ms), {d_k5 / MH_WINDOW:.4f} ms of device time per MH step", flush=True)
    # K5-K7: each logical block's eps is needed once per evaluation.
    iflat_w = sum(t.numel() for f in iflats for t in f)
    eps_ops = lambda n_rows, block: -(-n_rows // block) * bnn_macs * mp.OPS_PER_NORMAL
    b_k6 = {n_k: bound(row_bytes(n_k, False) + 4 * iflat_w,
                       n_k * 4 * bnn_macs + eps_ops(n_k, k6.block_rows)) for n_k in (N, 2 * N)}
    b_k7 = {n_k: bound(row_bytes(n_k, True) + 4 * iflat_w,
                       n_k * 8 * bnn_macs + eps_ops(n_k, k7.block_rows)) for n_k in (FIT_BATCH, N)}
    a6x2 = (*(torch.cat([t, t]) for t in (z, x, y, v)), seed, *iflats)
    d_k6 = {N: device_ms(lambda: k6(*a6)), 2 * N: device_ms(lambda: k6(*a6x2))}
    d_k7 = {n_k: device_ms(lambda: k7(*k7_args[n_k])) for n_k in (FIT_BATCH, N)}
    for label, td, (b_ms, b_by) in ([(f"K6 N={n_k}", d_k6[n_k], b_k6[n_k]) for n_k in d_k6]
                                    + [(f"K7 N={n_k} ({'cluster' if n_k <= k7_switch else 'tiles'})",
                                        d_k7[n_k], b_k7[n_k]) for n_k in d_k7]):
        print(f"[19 timing] {label}: device {td:.4f} ms; bound {b_ms:.6f} ms ({b_by}), "
              f"device time at {100 * b_ms / td:.2f} % of it", flush=True)

    # 20. predict with the MH window on the fitted BNN model, then the
    # window's burn-in acceptance against the per-step path's
    fit_model.params["mh_window_kernel"] = True
    window_launches = drive_predict(
        "20 window predict", fit_model,
        {"bnn_hosteps": 1, "bnn_hosteps_paired": N_MCMC, "bnn_mh_window": BURN_IN // MH_WINDOW,
         "bnn_inkernel_mh_steps": BURN_IN // MH_WINDOW})
    fit_model.params["mh_window_kernel"] = False
    lp, plp, make_params, make_multi_step = fit_model._make_param_log_prob()
    mh_params = make_params(fit_model.nets, data_np, True)
    init = torch.randn((N, sum(Z_DIMS)), generator=torch.Generator(device=dev).manual_seed(21),
                       device=dev)
    window_fn, counts = make_multi_step(MH_WINDOW), []

    def recording_window(p, state, q, g):
        out = window_fn(p, state, q, g)
        counts.append(out[2])
        return out

    last = [init]

    def step_rate(p, state, g):
        rate = (state != last[0]).any(dim=1).to(torch.float32).mean()
        last[0] = state
        return rate

    mh_kw = dict(q_sd=1.0, adaptive=False, recompute_current=True, paired_log_prob_fn=plp,
                 params=mh_params)
    with torch.no_grad():
        mcmc.adaptive_mh(lp, init, torch.Generator(device=dev).manual_seed(22), burn_in=BURN_IN,
                         n_keep=0, multi_step_fn=recording_window, **mh_kw)
        per_step = mcmc.adaptive_mh(lp, init, torch.Generator(device=dev).manual_seed(23),
                                    burn_in=0, n_keep=BURN_IN, collect=step_rate, **mh_kw)
    rates = {"window": torch.cat(counts) / N, "per step": per_step.samples}

    def std_err(r):
        """Standard error of the mean of per-step rates, from their spread
        about the means of their 50-step windows."""
        r = r.reshape(-1, MH_WINDOW)
        resid = r - r.mean(dim=1, keepdim=True)
        return float(resid.pow(2).sum() / (r.numel() - r.shape[0])) ** 0.5 / r.numel() ** 0.5

    acc = {k: float(r.mean()) for k, r in rates.items()}
    tol = 4.0 * (std_err(rates["window"]) ** 2 + std_err(rates["per step"]) ** 2) ** 0.5
    for k, r in rates.items():
        per_window = r.reshape(-1, MH_WINDOW).mean(dim=1).cpu().numpy()
        print(f"[20 window] {k} burn-in acceptance {acc[k]:.5f}; per-window rates "
              f"{np.array2string(per_window, precision=5)}", flush=True)
    gap = abs(acc["window"] - acc["per step"])
    print(f"[20 window] |window - per step| = {gap:.5f}, limit {tol:.5f} (4 standard errors) "
          f"{'ok' if gap <= tol else 'FAIL'}", flush=True)
    if gap > tol:
        raise AssertionError("[20 window] the window's burn-in acceptance differs from the "
                             "per-step path's")

    # 21. the probe: run_probe at the flagship paired shape with every count
    # at 0, then each variant's kernel against its plain version on the
    # probe's own inputs (the same seed)
    for counts in (mp.LAUNCHES, ik.LAUNCHES):
        for key in counts:
            counts[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe = {r["variant"]: r for r in mp.run_probe(n=N, v_dim=V_DIM, short=PROBE_SHORT,
                                                  long=PROBE_LONG)}
    probe_wall = time.perf_counter() - t0
    probe_launches = dict(mp.LAUNCHES, prod=ik.LAUNCHES["logp"])
    probe_entries = dict(ik.LAUNCHES)
    want_launches = 3 + 4 * PROBE_SHORT + 3 * PROBE_LONG
    for v, r in probe.items():
        vs_base = probe["base"]["ms_per_eval"] / r["ms_per_eval"]
        print(f"[21 probe] {v}: {r['ms_per_eval']:.4f} ms per evaluation (reps "
              f"{', '.join(f'{t:.4f}' for t in r['reps_ms'])}; host "
              f"{r['host_ms_per_eval']:.4f} ms to enqueue one); base/this {vs_base:.3f}; "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['share_of_bound']:.2f} % of it; launches {probe_launches[v]}", flush=True)
    print(f"[21 probe] run_probe wall {probe_wall:.3f} s; {probe['base']['card']}", flush=True)
    checks = {f"{v} launches == {want_launches}": probe_launches[v] == want_launches
              for v in mp.VARIANTS}
    checks["no K7 or K5 launch"] = probe_entries["logp_and_grad"] == probe_entries["mh_steps"] == 0
    for name, ok in checks.items():
        print(f"[21 probe] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[21 probe] launch counts")
    pcfg, pdims, pdata, pflats = mp.probe_inputs(N, V_DIM, dev)
    pseed = torch.tensor([3, 17], dtype=torch.int32, device=dev)
    sgen = torch.Generator(device=dev).manual_seed(31)
    lo, hi = PROBE_SIGMA
    wide_flats = [[t if j < 2 or (j - 2) % 3 != 1  # [gamma, beta, (loc, sigma, b) x L]
                   else lo + (hi - lo) * torch.rand(t.shape, generator=sgen, device=dev)
                   for j, t in enumerate(f)] for f in pflats]

    def probe_outputs(label, p_flats):
        """Each variant's kernel against its plain version on the probe's
        rows with the nets ``p_flats``: ``(args, outputs, max_abs_errs)``."""
        p_args = (*pdata, pseed, *p_flats)
        outs, errs = {}, {}
        for v in mp.VARIANTS:
            outs[v] = mp.make_probe_kernel(v, pcfg, *pdims)(*p_args)
            errs[v] = compare(f"[21 K8 {v} N={2 * N} {label}]", outs[v],
                              mp.probe_plain(v, pcfg, *p_args, mp.BLOCK_ROWS))
        return p_args, outs, errs

    def separation(got, ref):
        """max |got - ref| in units of the (RTOL, ATOL) limit about ref."""
        return float(((got - ref).abs() / (ATOL + RTOL * ref.abs())).max())

    pargs, p_out, p_err = probe_outputs("sigma 0.0067", pflats)
    p_plain_ms = {v: time_ms(lambda: mp.probe_plain(v, pcfg, *pargs, mp.BLOCK_ROWS), 0, 3)
                  for v in mp.VARIANTS}
    for a, b in (("base", "prod"), ("xorsign", "base")):
        if not torch.equal(p_out[a], p_out[b]):
            raise AssertionError(f"[21 K8] {a} differs from {b}")
    print("[21 K8] base == prod and xorsign == base bit for bit", flush=True)
    compare("[21 K8 blockdiag vs base]", p_out["blockdiag"], p_out["base"])
    _, w_out, _ = probe_outputs(f"sigma ~ U{PROBE_SIGMA}", wide_flats)
    # A kernel that skipped bf16's rounding, or a variant's perturbation
    # product, would land on base's or nopert's value: each is far from it.
    seps = {"bf16 vs base, sigma 0.0067": separation(p_out["bf16"], p_out["base"]),
            f"bf16 vs base, sigma ~ U{PROBE_SIGMA}": separation(w_out["bf16"], w_out["base"])}
    seps.update({f"{v} vs nopert, sigma ~ U{PROBE_SIGMA}": separation(w_out[v], w_out["nopert"])
                 for v in mp.VARIANTS if v != "nopert"})
    for name, sep in seps.items():
        print(f"[21 K8 separation] {name}: max gap {sep:.3e} limits (needs > {SEPARATION}) "
              f"{'ok' if sep > SEPARATION else 'FAIL'}", flush=True)
    if min(seps.values()) <= SEPARATION:
        raise AssertionError("[21 K8] a variant's value is within reach of base's or nopert's")
    for v in mp.VARIANTS:
        print(f"[21 timing] {v}: plain {p_plain_ms[v]:.4f} ms", flush=True)

    # Bounds at the main path's shapes: K1 paired at 2N, K2 and K3 at the fit
    # batch, K4 at a predict batch.
    b_k2 = b_g[FIT_BATCH]
    b_k5 = bound(row_bytes(N, True) + 4 * (iflat_w + MH_WINDOW),  # z, logp out; counts
                 2 * MH_WINDOW * (N * 4 * bnn_macs + eps_ops(N, k5.block_rows))
                 + MH_WINDOW * N * (sum(Z_DIMS) + 1) * mp.OPS_PER_NORMAL)  # proposals, uniforms
    print(json.dumps({"kernels": [{
        "name": "bnn_hosteps",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/bnn_hosteps.cu",
        "replaces": "bayesgm_tpu/ops/_pk_bnn_hosteps.py:107",
        "launches": n_launch,
        "max_abs_err": max(err1, err2),
        "ms": t_k2,
        "plain_ms": t_p2,
        "bound_ms": b_k1[0],
        "bound_by": b_k1[1],
        "library_ms": None,
        "device_ms": d_k2,
        "ms_unpaired": t_k1,
        "device_ms_unpaired": d_k1,
        "plain_ms_unpaired": t_p1,
        "bound_ms_unpaired": b_k1u[0],
    }, {
        "name": "bnn_hosteps_grad",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/bnn_hosteps.cu",
        "replaces": "bayesgm_tpu/ops/_pk_bnn_hosteps.py:216",
        "launches": fit_launches["bnn_hosteps_grad"],
        "max_abs_err": max(k2_errs),
        "ms": t_g[FIT_BATCH][0],
        "plain_ms": t_g[FIT_BATCH][1],
        "bound_ms": b_k2[0],
        "bound_by": b_k2[1],
        "library_ms": None,
        "device_ms": d_g[FIT_BATCH],
        f"ms_n{N}": t_g[N][0],
        f"device_ms_n{N}": d_g[N],
        f"plain_ms_n{N}": t_g[N][1],
        f"bound_ms_n{N}": b_g[N][0],
    }, {
        "name": "plain_grad",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/plain.cu",
        "replaces": "bayesgm_tpu/ops/_pk_plain.py:163",
        "launches": plain_fit_launches["plain_grad"],
        "max_abs_err": max(k3_errs),
        "ms": t_k3[FIT_BATCH][0],
        "plain_ms": t_k3[FIT_BATCH][1],
        "bound_ms": b_k3[FIT_BATCH][0],
        "bound_by": b_k3[FIT_BATCH][1],
        "library_ms": None,
        "device_ms": d_k3[FIT_BATCH],
        "cluster_max_rows": switch,
        f"ms_n{N}": t_k3[N][0],
        f"device_ms_n{N}": d_k3[N],
        f"plain_ms_n{N}": t_k3[N][1],
        f"bound_ms_n{N}": b_k3[N][0],
    }, {
        "name": "plain",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/plain.cu",
        "replaces": "bayesgm_tpu/ops/_pk_plain.py:30",
        "launches": plain_mh["plain"],
        "max_abs_err": max(k4_errs),
        "ms": t_k4[PLAIN_BS][0],
        "plain_ms": t_k4[PLAIN_BS][1],
        "bound_ms": b_k4[PLAIN_BS][0],
        "bound_by": b_k4[PLAIN_BS][1],
        "library_ms": None,
        "device_ms": d_k4[PLAIN_BS],
        f"ms_n{N}": t_k4[N][0],
        f"device_ms_n{N}": d_k4[N],
        f"plain_ms_n{N}": t_k4[N][1],
        f"bound_ms_n{N}": b_k4[N][0],
    }, {
        "name": "bnn_mh_window",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/bnn_inkernel.cu",
        "replaces": "bayesgm_tpu/ops/_pk_bnn_inkernel.py:206",
        "launches": window_launches["bnn_mh_window"],
        "max_abs_err": max(err5),
        "ms": t_k5[0],
        "plain_ms": t_k5[1],
        "bound_ms": b_k5[0],
        "bound_by": b_k5[1],
        "library_ms": None,
        "device_ms": d_k5,
        "ms_per_step": t_k5[0] / MH_WINDOW,
        "device_ms_per_step": d_k5 / MH_WINDOW,
        "rows_same_state": same_share[MH_WINDOW],
        "rows_same_state_5_steps": same_share[5],
    }, {
        "name": "bnn_inkernel_logp",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/bnn_inkernel.cu",
        "replaces": "bayesgm_tpu/ops/_pk_bnn_inkernel.py:123",
        "launches": probe_launches["prod"],  # the probe's prod; K5 runs its device code
        "launches_window_predict": window_launches["bnn_inkernel_logp"],
        "max_abs_err": max(err6),
        "ms": t_k6[0],
        "plain_ms": t_k6[1],
        "bound_ms": b_k6[N][0],
        "bound_by": b_k6[N][1],
        "library_ms": None,
        "device_ms": d_k6[N],
        f"device_ms_n{2 * N}": d_k6[2 * N],
        f"bound_ms_n{2 * N}": b_k6[2 * N][0],
    }, {
        "name": "bnn_inkernel_grad",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/bnn_inkernel.cu",
        "replaces": "bayesgm_tpu/ops/_pk_bnn_inkernel.py:365",
        "launches": window_launches["bnn_inkernel_logp_and_grad"],  # no package caller
        "max_abs_err": max(err7),
        "ms": t_k7[N][0],
        "plain_ms": t_k7[N][1],
        "bound_ms": b_k7[N][0],
        "bound_by": b_k7[N][1],
        "library_ms": None,
        "device_ms": d_k7[N],
        "cluster_max_rows": k7_switch,
        f"ms_n{FIT_BATCH}": t_k7[FIT_BATCH][0],
        f"device_ms_n{FIT_BATCH}": d_k7[FIT_BATCH],
        f"plain_ms_n{FIT_BATCH}": t_k7[FIT_BATCH][1],
        f"bound_ms_n{FIT_BATCH}": b_k7[FIT_BATCH][0],
    }, {
        "name": "bnn_inkernel_probe",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/bnn_inkernel.cu",
        "replaces": "benchmarks/mxu_probe.py:61",
        "launches": sum(probe_launches[v] for v in mp.KERNEL_VARIANTS),
        "max_abs_err": max(p_err[v] for v in mp.KERNEL_VARIANTS),
        "ms": probe["base"]["ms_per_eval"],
        "plain_ms": p_plain_ms["base"],
        "bound_ms": probe["base"]["bound_ms"],
        "bound_by": probe["base"]["bound_by"],
        "library_ms": None,
        "variants": {v: {
            "launches": probe_launches[v],
            "max_abs_err": p_err[v],
            "ms": probe[v]["ms_per_eval"],
            "plain_ms": p_plain_ms[v],
            "bound_ms": probe[v]["bound_ms"],
            "bound_by": probe[v]["bound_by"],
            "library_ms": None,
            "speedup_vs_base": probe["base"]["ms_per_eval"] / probe[v]["ms_per_eval"],
        } for v in mp.VARIANTS},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
