#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises and exits
non-zero:

1. device   - require CUDA; print the card's name and power limit
              (nvidia-smi) and the torch / CUDA versions;
2. build    - build K1 and K2 (bayesgm_torch/csrc/bnn_hosteps.cu) and K3 and
              K4 (bayesgm_torch/csrc/plain.cu) with nvcc, one process per
              source, started together;
3. philox   - the kernel's sign words equal the plain Philox words exactly;
4. K1       - kernel vs its plain PyTorch version at the flagship width,
              unpaired (N=20000), plus binary treatment and fixed sigmas at
              a small N;
5. K1 paired- the same at N=40000 (the per-step [proposed; current] stack);
6. K2       - values and z-gradients vs the plain version (autograd) at the
              flagship width, N=32 (a fit batch) and N=20000, plus binary
              treatment and fixed sigmas at a small N;
7. timing   - K1 and K2 vs their plain versions, median of CUDA-event times;
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
              N=20000, plus binary treatment and fixed sigmas at N=999;
11. K3      - values and z-gradients vs the plain version (autograd) at N=32
              and N=20000, plus the variants at N=999; K3's value equals
              K4's bit for bit;
12. timing  - K4 (N=10000, 20000) and K3 (N=32, 20000) vs their plain
              versions;
13. fit     - the plain model's fit, as phase 8 (EGM 200, 2 passes of 625
              batches): K3 launches == 1250, none of K4;
14. predict - MH on the fitted plain model, burn_in=200, n_mcmc=200, two
              batches of 10000: K4 launches == 2 x (1 + 400), none of K3;
15. MALA    - sampler="mala", burn_in=100, n_mcmc=100: on the plain model K3
              launches == 2 x (1 + 200) (the value is cached), none of K4; on
              the BNN model of phase 8 (one batch of 20000) K2 launches ==
              2 x 200 (both sides evaluated afresh each step).

Launch counts are set to 0 just before each driven path and read just
after; the launches of the comparisons do not count.  The last lines are a
JSON object with the kernels' numbers (each with its bound: the larger of
its bytes over 3.35 TB/s and its flops over the 67 TFLOP/s f32 peak), the
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
FIT_BATCH, FIT_EPOCHS, EGM_N_ITER = 32, 1, 200
PLAIN_BS = 10000  # predict's subject batch for plain nets (bs=None)
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12  # H100 SXM, at the 700 W limit


def flagship_params(output_dir, use_bnn=True):
    return dict(v_dim=V_DIM, z_dims=list(Z_DIMS), binary_treatment=False,
                dataset="chip_smoke", output_dir=output_dir, use_bnn=use_bnn,
                save_res=False, save_model=False, lr_decay="cosine")


def bound(n_bytes, flops):
    """``(bound_ms, bound_by)``: the least time the card could take."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np

    from bayesgm_torch import CausalBGM, Sim_Hirano_Imbens_sampler
    from bayesgm_torch.models.causalbgm import _apply, _loss_v
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
        make_fused_causal_logp,
        make_fused_causal_logp_and_grad,
    )
    from bayesgm_torch.ops._pk_traced_common import philox_sign_words
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
        libs = list(pool.map(load_library, ("bnn_hosteps.cu", "plain.cu")))
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
    print("[6 K2] value == K1's value bit for bit", flush=True)
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

    # 7. timing
    t_k1 = time_ms(lambda: fused(*args1))
    t_p1 = time_ms(lambda: logp_plain(cfg, *args1))
    t_k2 = time_ms(lambda: fused2(*args2))
    t_p2 = time_ms(lambda: logp_plain(cfg, *args2))
    t_g = {n_k2: (time_ms(lambda: fused_g(*a)), time_ms(lambda: logp_and_grad_plain(cfg, *a)))
           for n_k2, a in k2_args.items()}
    rows = [("K1 unpaired N=20000", t_k1, t_p1), ("K1 paired N=40000", t_k2, t_p2)]
    rows += [(f"K2 N={n_k2}", tk, tp) for n_k2, (tk, tp) in t_g.items()]
    for label, tk, tp in rows:
        note = "" if tk <= tp else "  (kernel SLOWER than the plain version)"
        print(f"[7 timing] {label}: kernel {tk:.4f} ms, plain {tp:.4f} ms, "
              f"plain/kernel {tp / tk:.2f}x{note}", flush=True)

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
        ``want`` ({kernel name: launches}) and return all the counts."""
        for k in pred_model.kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adrf, ci, diag = pred_model.predict(data_np, x_values=np.linspace(0, 3, 20),
                                            alpha=0.01, burn_in=burn_in, n_mcmc=n_mcmc,
                                            q_sd=1.0, sampler=sampler, return_diagnostics=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in pred_model.kernels.items()}
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
        k4_errs.append(compare(f"[10 K4 N={n_k}]", k4(*a), plain_logp(pcfg, *a)))
    for label, var_cfg, xs in variants:
        a = rows(n_small, xs)
        k4_errs.append(compare(f"[10 K4 {label} N={n_small}]",
                               make_fused_causal_logp(var_cfg, *pdims)(*a),
                               plain_logp(var_cfg, *a)))

    # 11. K3: values and z-gradients at the fit batch and at N, then the variants
    k3_errs, k3_args = [], {n_k: rows(n_k) for n_k in (FIT_BATCH, N)}
    k3_cases = [(f"N={n_k}", pcfg, a) for n_k, a in k3_args.items()]
    k3_cases += [(f"{name} N={n_small}", c, rows(n_small, xs)) for name, c, xs in variants]
    for label, var_cfg, a in k3_cases:
        (neg_k, grad_k) = make_fused_causal_logp_and_grad(var_cfg, *pdims)(*a)
        neg_p, grad_p = plain_logp_and_grad(var_cfg, *a)
        k3_errs.append(compare(f"[11 K3 value {label}]", neg_k, neg_p))
        k3_errs.append(compare(f"[11 K3 grad {label}]", grad_k, grad_p, GRAD_RTOL, GRAD_ATOL))
        if not torch.equal(neg_k, make_fused_causal_logp(var_cfg, *pdims)(*a)):
            raise AssertionError(f"[11 K3 {label}]: K3's value differs from K4's")
    print("[11 K3] value == K4's value bit for bit", flush=True)

    # 12. timing
    t_k4 = {n_k: (time_ms(lambda: k4(*a)), time_ms(lambda: plain_logp(pcfg, *a)))
            for n_k, a in k4_args.items()}
    t_k3 = {n_k: (time_ms(lambda: k3(*a)), time_ms(lambda: plain_logp_and_grad(pcfg, *a)))
            for n_k, a in k3_args.items()}
    for label, (tk, tp) in ([(f"K4 N={n_k}", t) for n_k, t in t_k4.items()]
                            + [(f"K3 N={n_k}", t) for n_k, t in t_k3.items()]):
        note = "" if tk <= tp else "  (kernel SLOWER than the plain version)"
        print(f"[12 timing] {label}: kernel {tk:.4f} ms, plain {tp:.4f} ms, "
              f"plain/kernel {tp / tk:.2f}x{note}", flush=True)

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

    # Bounds at the main path's shapes: K1 paired at 2N, K2 and K3 at the fit
    # batch, K4 at a predict batch.
    bnn_macs, plain_macs = chain_macs(dims), chain_macs(pdims)
    bnn_w = sum(t.numel() for w in ws for t in w)
    bnn_p = sum(p.numel() for p in ps)  # one eps set of P
    plain_w = sum(t.numel() for f in flats for t in f)
    b_k1 = bound(row_bytes(2 * N, False) + 4 * (bnn_w + 2 * bnn_p), 2 * N * 4 * bnn_macs)
    b_k2 = bound(row_bytes(FIT_BATCH, True) + 4 * (bnn_w + bnn_p), FIT_BATCH * 8 * bnn_macs)
    b_k3 = bound(row_bytes(FIT_BATCH, True) + 4 * plain_w, FIT_BATCH * 4 * plain_macs)
    b_k4 = bound(row_bytes(PLAIN_BS, False) + 4 * plain_w, PLAIN_BS * 2 * plain_macs)
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
        "ms_unpaired": t_k1,
        "plain_ms_unpaired": t_p1,
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
        f"ms_n{N}": t_g[N][0],
        f"plain_ms_n{N}": t_g[N][1],
    }, {
        "name": "plain_grad",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/plain.cu",
        "replaces": "bayesgm_tpu/ops/_pk_plain.py:163",
        "launches": plain_fit_launches["plain_grad"],
        "max_abs_err": max(k3_errs),
        "ms": t_k3[FIT_BATCH][0],
        "plain_ms": t_k3[FIT_BATCH][1],
        "bound_ms": b_k3[0],
        "bound_by": b_k3[1],
        "library_ms": None,
        f"ms_n{N}": t_k3[N][0],
        f"plain_ms_n{N}": t_k3[N][1],
    }, {
        "name": "plain",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/plain.cu",
        "replaces": "bayesgm_tpu/ops/_pk_plain.py:30",
        "launches": plain_mh["plain"],
        "max_abs_err": max(k4_errs),
        "ms": t_k4[PLAIN_BS][0],
        "plain_ms": t_k4[PLAIN_BS][1],
        "bound_ms": b_k4[0],
        "bound_by": b_k4[1],
        "library_ms": None,
        f"ms_n{N}": t_k4[N][0],
        f"plain_ms_n{N}": t_k4[N][1],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
