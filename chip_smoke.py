#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises and exits
non-zero:

1. device   - require CUDA; print the card's name and power limit
              (nvidia-smi) and the torch / CUDA versions;
2. build    - build K1 and K2 (bayesgm_torch/csrc/bnn_hosteps.cu) with nvcc;
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

The last lines are a JSON object with the kernels' numbers, the card line,
and {"ok": true, "device": {...}}.  Imports nothing of JAX nor of the JAX
package.
"""

import json
import statistics
import sys
import tempfile
import time

RTOL, ATOL = 1e-4, 1e-3  # f32 summation order over 64-wide dots and the 200-column sum
# K2's z-gradient: f32 dots 64 and 201 wide, through 6 layers forward and 6
# back per chain, each summed in another order than autograd's cuBLAS calls
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-3
N, V_DIM, Z_DIMS = 20000, 200, (1, 1, 1, 7)
BURN_IN, N_MCMC = 200, 200
FIT_BATCH, FIT_EPOCHS, EGM_N_ITER = 32, 1, 200


def flagship_params(output_dir):
    return dict(v_dim=V_DIM, z_dims=list(Z_DIMS), binary_treatment=False,
                dataset="chip_smoke", output_dir=output_dir, use_bnn=True,
                save_res=False, save_model=False, lr_decay="cosine")


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
    from bayesgm_torch.ops._pk_traced_common import philox_sign_words
    from bayesgm_torch.ops._pk_util import (
        flatten_flipout_params,
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

    # 2. build
    lib = load_library("bnn_hosteps.cu")
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
    fit_model = model
    eval_gen = torch.Generator(device=dev).manual_seed(11)
    mse_x0, mse_y0, mse_v0 = (float(t) for t in
                              fit_model.evaluate(data_np, generator=eval_gen)[1:])

    def full_loss_v(z=None):
        """g's training objective (-log p(V|Z) mean + KL term) on all N rows,
        at z = e(V) when no table is given, under a seeded draw."""
        g = torch.Generator(device=dev).manual_seed(13)
        with torch.no_grad():
            if z is None:
                z = _apply(cfg, fit_model.nets["e"], v, g)
            return float(_loss_v(cfg, fit_model.nets["g"], z, v, g)[0])

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
                  use_egm_init=True, egm_n_iter=EGM_N_ITER, egm_batches_per_eval=100, verbose=0)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_launches = {name: k.launches for name, k in fit_model.kernels.items()}
    n_steps = (FIT_EPOCHS + 1) * (N // FIT_BATCH)
    train_s = fit_wall - spans["egm"] - spans["evaluate"]
    mse_x1, mse_y1, mse_v1 = (float(t) for t in fit_model.evaluate(
        data_np, fit_model.data_z, generator=eval_gen)[1:])
    loss_v1 = full_loss_v(fit_model.data_z)
    print(f"[8 fit] n={N}: wall {fit_wall:.3f} s; EGM {spans['egm']:.3f} s "
          f"({1e3 * spans['egm'] / (EGM_N_ITER + 1):.3f} ms/iteration of "
          f"{fit_model.cfg.g_d_freq} critic + 1 generator steps); training "
          f"{train_s:.3f} s ({1e3 * train_s / n_steps:.3f} ms/step over {n_steps} steps); "
          f"evaluations {spans['evaluate']:.3f} s; launches {fit_launches}", flush=True)
    print(f"[8 fit] mse_x {mse_x0:.4f} -> {mse_x1:.4f}, mse_y {mse_y0:.4f} -> {mse_y1:.4f}, "
          f"mse_v {mse_v0:.6f} -> {mse_v1:.6f}, g's loss_v {loss_v0:.4f} -> {loss_v1:.4f} "
          f"(untrained e(V) -> fitted table); last EGM losses {fit_model.egm_losses}; "
          f"last step losses {fit_model.fit_losses}", flush=True)
    losses = list(fit_model.egm_losses.values()) + list(fit_model.fit_losses.values())
    checks = {
        "losses finite": bool(np.all(np.isfinite(losses))),
        "data_z (20000, 10) and finite": (tuple(fit_model.data_z.shape) == (N, sum(Z_DIMS))
                                          and bool(torch.isfinite(fit_model.data_z).all())),
        f"K2 launches == {n_steps}": fit_launches["bnn_hosteps_grad"] == n_steps,
        "no K1 launch in fit": fit_launches["bnn_hosteps"] + fit_launches["bnn_hosteps_paired"] == 0,
        "mse_x fell": mse_x1 < mse_x0,
        "mse_y fell": mse_y1 < mse_y0,
        "g's loss_v fell": loss_v1 < loss_v0,
        "mse_v within 1 % of the untrained model's": mse_v1 < 1.01 * mse_v0,
        "best and SWA snapshots made": (fit_model.best_nets is not None
                                        and fit_model.swa_nets is not None),
    }
    for name, ok in checks.items():
        print(f"[8 fit] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("fit checks failed")
    del fit_model.egm_init, fit_model.evaluate

    # 9. predict on the fitted model
    for k in fit_model.kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adrf, ci, diag = fit_model.predict(data_np, x_values=np.linspace(0, 3, 20), alpha=0.01,
                                       burn_in=BURN_IN, n_mcmc=N_MCMC, q_sd=1.0,
                                       return_diagnostics=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in fit_model.kernels.items()}
    n_launch = launches["bnn_hosteps"] + launches["bnn_hosteps_paired"]
    rate = diag["accept_rate"]
    print(f"[9 predict] n={N}: wall {wall:.3f} s for {BURN_IN + N_MCMC} MH steps "
          f"({1e3 * wall / (BURN_IN + N_MCMC):.3f} ms/step incl. collector and set-up); "
          f"accept {rate:.4f}; launches {launches}", flush=True)
    print(f"[9 predict] ADRF {np.array2string(adrf, precision=4)}", flush=True)
    checks = {
        "adrf shape (20,)": adrf.shape == (20,),
        "adrf finite": bool(np.all(np.isfinite(adrf))),
        "intervals finite and ordered": bool(np.all(np.isfinite(ci)) and np.all(ci[:, 0] <= ci[:, 1])),
        "acceptance in (0, 1)": 0.0 < rate < 1.0,
        "K1 launches == 1 + burn_in + n_mcmc": n_launch == 1 + BURN_IN + N_MCMC,
        "no K2 launch in predict": launches["bnn_hosteps_grad"] == 0,
    }
    for name, ok in checks.items():
        print(f"[9 predict] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("predict checks failed")

    print(json.dumps({"kernels": [{
        "name": "bnn_hosteps",
        "route": "cuda",
        "source": "bayesgm_torch/csrc/bnn_hosteps.cu",
        "replaces": "bayesgm_tpu/ops/_pk_bnn_hosteps.py:107",
        "launches": n_launch,
        "max_abs_err": max(err1, err2),
        "ms": t_k2,
        "plain_ms": t_p2,
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
        f"ms_n{N}": t_g[N][0],
        f"plain_ms_n{N}": t_g[N][1],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
