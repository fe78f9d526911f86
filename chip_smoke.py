#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises and exits
non-zero:

1. device   - require CUDA; print the card's name and power limit
              (nvidia-smi) and the torch / CUDA versions;
2. build    - build K1 (bayesgm_torch/csrc/bnn_hosteps.cu) with nvcc;
3. philox   - the kernel's sign words equal the plain Philox words exactly;
4. K1       - kernel vs its plain PyTorch version at the flagship width,
              unpaired (N=20000), plus binary treatment and fixed sigmas at
              a small N;
5. K1 paired- the same at N=40000 (the per-step [proposed; current] stack);
6. timing   - kernel vs plain version, median of CUDA-event times;
7. slice    - bayesgm_torch.CausalBGM(...).predict on Sim_Hirano_Imbens
              (n=20000, v_dim=200) with burn_in=200, n_mcmc=200; checks the
              ADRF, its intervals, the acceptance rate and K1's launch count.

The last lines are a JSON object with the kernel's numbers, the card line,
and {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import json
import statistics
import sys
import tempfile
import time

RTOL, ATOL = 1e-4, 1e-3  # f32 summation order over 64-wide dots and the 200-column sum
N, V_DIM, Z_DIMS = 20000, 200, (1, 1, 1, 7)
BURN_IN, N_MCMC = 200, 200


def flagship_params(output_dir):
    return dict(v_dim=V_DIM, z_dims=list(Z_DIMS), binary_treatment=False,
                dataset="chip_smoke", output_dir=output_dir, use_bnn=True,
                save_res=False, save_model=False)


def compare(name, got, want):
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite kernel output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    print(f"{name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(rtol={RTOL}, atol={ATOL}) {'ok' if ok else 'FAIL'}", flush=True)
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
    from bayesgm_torch.models.causalbgm import CBGMConfig
    from bayesgm_torch.ops._build import load_library
    from bayesgm_torch.ops._pk_bnn_hosteps import (
        logp_plain,
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

    # 6. timing
    t_k1 = time_ms(lambda: fused(*args1))
    t_p1 = time_ms(lambda: logp_plain(cfg, *args1))
    t_k2 = time_ms(lambda: fused2(*args2))
    t_p2 = time_ms(lambda: logp_plain(cfg, *args2))
    for label, tk, tp in (("unpaired N=20000", t_k1, t_p1), ("paired N=40000", t_k2, t_p2)):
        note = "" if tk <= tp else "  (kernel SLOWER than the plain version)"
        print(f"[6 timing] K1 {label}: kernel {tk:.4f} ms, plain {tp:.4f} ms, "
              f"plain/kernel {tp / tk:.2f}x{note}", flush=True)

    # 7. the slice: the port's predict at the flagship width
    for k in model.kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adrf, ci, diag = model.predict(data_np, x_values=np.linspace(0, 3, 20), alpha=0.01,
                                   burn_in=BURN_IN, n_mcmc=N_MCMC, q_sd=1.0,
                                   return_diagnostics=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in model.kernels.items()}
    n_launch = sum(launches.values())
    rate = diag["accept_rate"]
    print(f"[7 slice] predict n={N}: wall {wall:.3f} s for {BURN_IN + N_MCMC} MH steps "
          f"({1e3 * wall / (BURN_IN + N_MCMC):.3f} ms/step incl. collector and set-up); "
          f"accept {rate:.4f}; K1 launches {launches}", flush=True)
    print(f"[7 slice] ADRF {np.array2string(adrf, precision=4)}", flush=True)
    checks = {
        "adrf shape (20,)": adrf.shape == (20,),
        "adrf finite": bool(np.all(np.isfinite(adrf))),
        "intervals finite and ordered": bool(np.all(np.isfinite(ci)) and np.all(ci[:, 0] <= ci[:, 1])),
        "acceptance in (0, 1)": 0.0 < rate < 1.0,
        "K1 launches == 1 + burn_in + n_mcmc": n_launch == 1 + BURN_IN + N_MCMC,
    }
    for name, ok in checks.items():
        print(f"[7 slice] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("slice checks failed")

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
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
