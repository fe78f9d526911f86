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
              per source, started together; phases 3-15 run while the
              third builds, and phase 16 waits for it;
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
              v_dim=200, lr_decay cosine): EGM warm start of 100 iterations,
              then 1 pass of 625 batches; checks the losses, the latent
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
13. fit     - the plain model's fit, as phase 8 (EGM 100, 1 pass of 625
              batches): K3 launches == 625, none of K4;
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

The rest of CausalBGM's surface, each path with its kernels' counts:

22. resume  - save_model and metrics_path at the flagship widths on 2000
              rows (EGM 50, epochs 0..3, lr_decay cosine): a run killed in
              the evaluate of epoch 2 and resumed by a new instance ends
              with a last checkpoint (nets, Adam states, latent table and
              moments, both generators, best and SWA snapshots) and a
              metrics log equal bit for bit to an uninterrupted run's, with
              K2 launched once per step of each; then the size and write
              time of phase 8's model's full state at n=20000;
23. sampler - metropolis_hastings_sampler (burn_in 200, 100 kept, K1 twice
              per step) and infer_from_latent_posterior on the 20-point grid
              on phase 8's model: shapes, finite values, launch counts;
24. DR/ESS  - predict(estimator="dr") on phase 13's plain model (two
              10000-row batches, 200 + 200 steps) beside the plugin
              predict on the same settings: finite ADRF, ordered intervals,
              K4 launches, ms per step; then predict(ess_target=400,
              n_mcmc=2000) on phase 8's model: the kept count a multiple of
              500 in [1000, 2000], the gate's ESS and split-Rhat where it
              stopped, K1 launches;
25. driver  - bayesgm_torch.main.main (the entry of python -m
              bayesgm_torch.main) on configs/Sim_Sun.yaml, read by
              config_io, without its model: line (the causalbgm engine at
              n=20000), cut by -e 0 -b 100 and a predict: block (burn_in
              200, n_mcmc 1500, ess_target 400): checkpoint, finite ADRF,
              the RMSE line, K2 and K1 launches; then python -m
              bayesgm_torch causalbgm in a new process on a 2000-row .npz
              triplet, which writes its two result files.

CausalBGM's three variants:

26. ident.  - configs/Sim_Sun.yaml as shipped (model: identifiable)
              through bayesgm_torch.main.main, cut as phase 25: finite
              ADRF, the RMSE line, a checkpoint holding prior_net and U,
              the ESS gate's kept count, ms per iVAE training step and per
              MH step, and no kernel launched (the latent loss and the MH
              target are composites, as in JAX); then an identifiable fit
              on 2000 Sim_Sun rows killed in the evaluate of epoch 2 and
              resumed by a new instance, bit-equal to an uninterrupted one;
27. fullmcmc- FullMCMCCausalBGM at the plain model's widths: fit as phase
              13 (K3 launches == 625, no other kernel), run_mcmc_training
              with 100 + 100 HMC steps per net (ms per HMC step and the
              acceptance of g, h and f), predict (200 + 200 MH steps, one
              weight draw per step, no kernel), and one 64-draw chunk of
              infer_from_latent_posterior with its time and peak memory;
28. ensemble- EnsembleCausalBGM with two BNN members (EGM 100, one pass
              each, predict 200 + 200): each member's K2 and K1 launches
              equal a lone CausalBGM's (phases 8 and 9), the pooled draws
              have shape (20, 400) and the ADRF is their mean.

BGM, the second model family (no kernel: its JAX counterpart launches no
Pallas kernel):

29. BGM     - (a) configs/Sim_heteroskedastic.yaml (plain variational
              decoder, n=18000 training rows, x_dim 100, z_dim 10) through
              bayesgm_torch.main.main, cut by -e 1 -b 200 and a predict:
              block (50 + 50 HMC steps, L = 10) on the 2000 held-out rows
              at bs=500: ms per EGM iteration, per training step and per
              HMC step, peak GiB, the correlation lines, finite outputs;
              (b) configs/Sim_low_rank.yaml (flipout decoder, n=10000) cut
              alike, imputing column 0 of 1000 rows: ms per HMC step and
              L + 2 target evaluations per step (the stochastic target's
              L + 1 gradients and one value); (c) a BGM fit on 2000
              Sim_heteroskedastic rows killed in the evaluate of epoch 2
              and resumed, its last checkpoint equal bit for bit to an
              uninterrupted run's; (d) python -m bayesgm_torch bgm in a new
              process on a .npz with NaN holes.  No kernel wrapper is
              called in any of them.

MNISTBGM, BGM on images (no kernel: its JAX counterpart launches no Pallas
kernel; its convolutions are cuDNN's):

30. MNIST   - (a) configs/Mnist.yaml (plain generator, z_dim 10, filters
              32/32/64, cosine decay, save_res and save_model) through
              bayesgm_torch.main.main on the 8192 seeded ellipse images,
              cut by -e 1 -b 200, a fit: block (an evaluation every epoch)
              and a predict: block (50 + 50 HMC steps, L = 10) over the
              driver's four masks on 64 images: ms per EGM iteration, per
              training step and per HMC step, the losses finite, MSE_x after
              the fit below the untrained model's, imputed pixels finite in
              [0, 1] with the observed ones untouched, ordered intervals,
              L + 2 target evaluations per HMC step; (b) use_bnn: true (the
              flipout generator) at the same widths through the model's API:
              EGM 100, one pass, the upper_half mask, the same checks; (c) a
              fit on 512 images killed in the evaluate of epoch 1 and
              resumed, its last checkpoint (nets, Adam states, data_z and
              its moments, both generators) equal bit for bit to an
              uninterrupted run's, under cuDNN's deterministic algorithms
              (set for (c) alone: its default ones differed).  No kernel
              wrapper is called in any of them.  The phase runs under
              PyTorch's default cuDNN TF32 setting (on), as a user's
              process does: every convolution must run with it off (the
              model's entry points turn it off), and it must be on again
              after.  Phase 30's peak memory is printed, with the part
              earlier phases still hold.

The semi-synthetic CausalBGM configs (binary and continuous treatment at
widths the flagship does not have), and the rest of the public surface:

31. semi    - seeded fixtures with the real files' schema under
              $BAYESGM_DATA (ACIC-2018: x.csv with sample_id and 177
              covariates over 20000 rows, the factuals of 10000 of them
              with binary z; Twins: 12000 pairs, 50 covariates after the
              loader's drops, ~1 % NaN rows, ~5 % heavy first twins); then
              (a) configs/Semi_acic.yaml (binary, v_dim 177, z_dims
              [3,6,3,6]) and (b) configs/Semi_Twins.yaml (v_dim 50) through
              bayesgm_torch.main.main, cut by -e 0 -b 100 and a predict:
              block (200 + 200 MH steps): the CSV load, fit and predict
              times, K2 launches == the fit's steps, K1 launches == the
              predict schedule's (per subject batch: one unpaired, one
              paired per step), the ITE (a) or the ADRF (b) finite with
              ordered intervals, the ATE or RMSE line; then K1 (unpaired on
              a predict batch and paired on two) and K2 (32 rows) against
              their plain versions at each config's widths, timed as in
              phase 7, each with its bound;
32. surface - utils.roofline's f32 GEMM peak and HBM triad measured on the
              card (each at most 1.05 x the datasheet's 67 TFLOP/s and
              3.35 TB/s) and its report for K1 paired at 2N rows from phase
              7's device time; every models/networks.py class built on cuda
              with one forward; run_mcmc_for_net for 50 + 50 HMC steps
              (finite samples, acceptance in (0, 1]); the low-rank heads at
              p = 100, rank 2 (Woodbury within 1e-4 of I, Sylvester equal
              to slogdet); estimate_latent_dims on a Sim_Hirano_Imbens
              sample, timed; simulate_regression(effective_rank=...)
              without scikit-learn.

The multi-device layer (bayesgm_torch/parallel) on the one card:

33. mesh    - (a) NCCL, world 1, in this process: the BNN flagship fit
              with mesh=make_mesh(1) (EGM 50, one pass of 625 batches, a
              checkpoint at its eval epoch), predict (100 + 100 MH steps)
              and the raw MH states of the same schedule, against the same
              with mesh=None from the same seed: every checkpoint leaf, the
              latent table and the MH states bit-equal, the best loss, the
              in-sample ADRF and the ADRF draws within rtol 1e-6 (means over
              rows: all-reduced sums), K2 launched 625 times and K1 paired
              200 times, with ms per training step and per MH burn-in step
              with and without the mesh; then the plain flagship alike with
              the mesh, the reference of (b).  (b) gloo, two spawned ranks
              sharing the card: the dry run's sections
              (bayesgm_torch.parallel.dryrun), then the plain flagship's fit
              and predict with the mesh, the same on both ranks and within
              tests/test_parallel.py's tolerances of (a)'s (table rtol 2e-3 /
              atol 2e-5, nets 2e-3 / 2e-6, ADRF 1e-3 / 1e-4), K3 launched 625
              times per rank and K4 2 x 201, and each rank's K4 and K1 paired
              (rho = -20) on its rows against their plain versions.  A rank
              that fails or a collective that times out fails the run.

The gate runners (bayesgm_torch/benchmarks):

34. gates   - in process, at tiny sizes (2000 rows, EGM 20, epochs 0..1, MH
              20 + 20; MNIST 256 images, HMC 10 + 10): binary_ate base
              (BNN), binary_ate --engine identifiable, sun_colangelo_ivae
              --runs SUN and mnist_inpaint --lr_decay cosine, each printing
              its JSON line: the binary base run's K2 launches == its
              training steps and K1's == 1 + 40 per subject batch, no
              launch in the identifiable runs, finite metrics; then K1
              (paired on 20000 rows, unpaired on 10000) and K2 (32 rows) at
              binary_ate's widths (v_dim 100, z_dims [3,6,3,6]) against
              their plain versions, timed as in phase 7, each with its
              bound.

Launch counts are set to 0 just before each driven path and read just
after; the launches of the comparisons do not count.  The last lines are a
JSON object with the kernels' numbers (each with its bound: the larger of
its bytes over 3.35 TB/s and its operations over the 67 TFLOP/s f32 peak,
the in-kernel-eps kernels' weight noise counted once per logical block), the
card line, and {"ok": true, "device": {...}}.  Imports nothing of JAX nor of
the JAX package.
"""

import contextlib
import glob
import io
import json
import os
import shutil
import statistics
import subprocess
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
FIT_BATCH, FIT_EPOCHS, EGM_N_ITER = 32, 0, 100  # phases 8, 13, 27: one pass after EGM 100
DRIVER_EPOCHS = 0  # the -e of phases 25, 26 and 31 (one pass), each with -b EGM_N_ITER
PLAIN_BS = 10000  # predict's subject batch for plain nets (bs=None)
N_RESUME, RESUME_EPOCHS, RESUME_EGM = 2000, 3, 50  # phase 22's fits
API_KEEP = 100  # phase 23's kept MH draws of Z
ESS_TARGET, ESS_N_MCMC = 400, 2000  # phase 24's ESS gate (the configs' ess_target)
DRIVER_N_MCMC, CLI_N = 1500, 2000  # phases 25's and 26's driver cap (one gate check), CLI rows
HMC_STEPS = 100  # phase 27's HMC burn-in and kept steps per net (the JAX defaults: 1000, 2000)
INFER_CHUNK_DRAWS = 64  # one chunk of FullMCMC's infer_from_latent_posterior
ENS_EGM, ENS_EPOCHS = 100, 0  # phase 28's member fits: EGM iterations, passes - 1
BGM_EPOCHS, BGM_EGM, BGM_HMC = 1, 200, 50  # phase 29's cut: -e, -b, HMC burn-in = kept steps
BGM_LEAPFROG, BGM_BS = 10, 500  # the driver's HMC leapfrog steps and subject batch (hetero)
MNIST_EPOCHS, MNIST_EGM, MNIST_HMC = 1, 200, 50  # phase 30a's cut: -e, -b, HMC burn-in = kept steps
MNIST_BNN_EGM, MNIST_RESUME_N, MNIST_LEAPFROG = 100, 512, 10  # 30b's EGM, 30c's images, HMC's L
ACIC_ROWS, ACIC_FACTUALS, TWINS_PAIRS = 20000, 10000, 12000  # phase 31's fixtures
SPIN_CYCLES = 5_000_000  # ~2.5 ms of spin ahead of a timed call: longer than any wrapper's host time
MESH_EGM, MESH_STEPS = 49, 100  # phase 33: EGM iterations - 1 (50 in all), MH burn-in = kept steps
MESH_WORLD, MESH_TIMEOUT = 2, 600  # 33b's ranks on the one card; seconds for the whole spawn
MESH_GRID = 20  # ADRF grid points on [0, 3], as phase 9
GATE_N, GATE_EGM, GATE_MH = 2000, 20, 20  # phase 34's binary and SUN runs: rows, EGM, MH steps
GATE_IMAGES, GATE_TEST, GATE_HMC = 256, 8, 10  # phase 34's MNIST run: images, inpainted, HMC steps


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


def timed_call(spans, name, fn):
    """``fn`` with its synchronized wall time added to ``spans[name]``."""
    import torch

    def run(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t
    return run


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


def _counting_kernel_calls():
    """Patch every kernel wrapper class's ``__call__`` to count its calls;
    returns ``(counts, restore)``."""
    from bayesgm_torch.benchmarks import mxu_probe as mp
    from bayesgm_torch.ops import _pk_bnn_hosteps as hk
    from bayesgm_torch.ops import _pk_bnn_inkernel as ik
    from bayesgm_torch.ops import _pk_plain as pk

    classes = [hk.FusedCausalLogpBnnHosteps, hk.FusedCausalLogpAndGradBnnHosteps,
               pk.FusedCausalLogp, pk.FusedCausalLogpAndGrad, ik.FusedCausalLogpBnn,
               ik.FusedCausalLogpAndGradBnn, ik.FusedMhStepsBnn, mp.ProbeKernel]
    counts = {cls.__name__: 0 for cls in classes}
    saved = {cls: cls.__call__ for cls in classes}
    for cls, call in saved.items():
        def counted(self, *a, _call=call, _name=cls.__name__, **kw):
            counts[_name] += 1
            return _call(self, *a, **kw)
        cls.__call__ = counted

    def restore():
        for cls, call in saved.items():
            cls.__call__ = call
    return counts, restore


def bgm_phase() -> dict:
    """Phase 29: BGM through its entry points at the two configs' widths
    (see the module docstring); raises on any failed check.  Returns the
    measured numbers."""
    import numpy as np
    import torch

    from bayesgm_torch import main as driver
    from bayesgm_torch.datasets.simulators import simulate_z_hetero
    from bayesgm_torch.models import bgm as bgm_mod
    from bayesgm_torch.ops import mcmc
    from bayesgm_torch.utils import checkpoint as ckpt_mod
    from bayesgm_torch.utils import config_io

    out = {}
    calls, restore = _counting_kernel_calls()
    root = tempfile.mkdtemp(prefix="chip_smoke_bgm_")
    try:
        for name in ("Sim_heteroskedastic", "Sim_low_rank"):
            text = (open(f"configs/{name}.yaml").read()
                    .replace("output_dir: '.'", f"output_dir: '{root}'"))
            cfg_path = os.path.join(root, f"{name}.yaml")
            with open(cfg_path, "w") as f:
                f.write(text + f"predict:\n  burn_in: {BGM_HMC}\n  n_mcmc: {BGM_HMC}\n")
            out[name] = _bgm_driver_run(driver, bgm_mod, mcmc, ckpt_mod, config_io, cfg_path,
                                        name)
        out["resume"] = _bgm_resume(bgm_mod, config_io, simulate_z_hetero, root)
        out["cli"] = _bgm_cli(root)
    finally:
        restore()
        shutil.rmtree(root, ignore_errors=True)
    print(f"[29 BGM] kernel wrapper calls over phase 29: {calls}", flush=True)
    if sum(calls.values()):
        raise AssertionError("[29 BGM] a kernel wrapper was called")
    return out


def _bgm_driver_run(driver, bgm_mod, mcmc, ckpt_mod, config_io, cfg_path, name):
    """29 (a) or (b): one config through bayesgm_torch.main.main, its spans
    timed (host clock, synchronized) and its checks made."""
    import numpy as np
    import torch

    tag = "[29a hetero]" if name == "Sim_heteroskedastic" else "[29b low-rank]"
    print(f"{tag} config {config_io.load(cfg_path)}", flush=True)
    spans, built, chains = {}, [], []
    init, hmc, save_ckpt = bgm_mod.BGM.__init__, mcmc.hmc, ckpt_mod.save_checkpoint

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        for method in ("fit", "evaluate", "_save_generated", "predict"):
            setattr(self, method, timed_call(spans, method, getattr(self, method)))
        egm = timed_call(spans, "egm_init", self.egm_init)

        def egm_init(*a, **kw):  # its logging slot's evaluate and writes count as EGM time
            before = {k: spans.get(k, 0.0) for k in ("evaluate", "_save_generated")}
            try:
                return egm(*a, **kw)
            finally:
                spans.update(before)
        self.egm_init = egm_init
        built.append(self)

    def recording_hmc(log_prob_fn, init_state, *a, **kw):
        evals = [0]

        def counted(p, z, d):
            evals[0] += 1
            return log_prob_fn(p, z, d)
        res = timed_call(spans, "chain", hmc)(counted, init_state, *a, **kw)
        chains.append((init_state.shape[0], kw["burn_in"] + kw["n_keep"], evals[0]))
        return res

    bgm_mod.BGM.__init__, mcmc.hmc = recording_init, recording_hmc
    ckpt_mod.save_checkpoint = timed_call(spans, "checkpoint", save_ckpt)
    printed = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # earlier phases' tensors still alive
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            result, intervals = driver.main(["-c", cfg_path, "-e", str(BGM_EPOCHS), "-b",
                                             str(BGM_EGM), "--device", "cuda"])
    finally:
        bgm_mod.BGM.__init__, mcmc.hmc, ckpt_mod.save_checkpoint = init, hmc, save_ckpt
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    lines = printed.getvalue().splitlines()
    m = built[0]
    n_train = len(m.data_z)
    steps = (BGM_EPOCHS + 1) * (n_train // 32)
    egm_s = spans["egm_init"]
    train_s = (spans["fit"] - egm_s - spans.get("checkpoint", 0.0) - spans["evaluate"]
               - spans.get("_save_generated", 0.0))
    n_chain_steps = sum(s for _, s, _ in chains)
    evals_per_step = [(e - 1) / s for _, s, e in chains]
    res = {"wall_s": wall, "peak_gib": peak, "held_gib": held, "fit_s": spans["fit"], "egm_s": egm_s,
           "ms_per_egm_iter": 1e3 * egm_s / (BGM_EGM + 1),
           "ms_per_train_step": 1e3 * train_s / steps, "train_steps": steps,
           "predict_s": spans["predict"],
           "ms_per_hmc_step": 1e3 * spans["chain"] / n_chain_steps,
           "hmc_rows": [r for r, _, _ in chains], "evals_per_hmc_step": evals_per_step}
    report = [l for l in lines if l.startswith(("Pearson", "95%", "Imputation", "HMC Acceptance"))]
    print(f"{tag} n={n_train} train rows: wall {wall:.3f} s; fit {spans['fit']:.3f} s (EGM "
          f"{egm_s:.3f} s = {res['ms_per_egm_iter']:.3f} ms per iteration incl. its "
          f"{-(-(BGM_EGM + 1) // 500)} logging slot; training {1e3 * train_s / steps:.3f} ms per "
          f"step over {steps}); predict {spans['predict']:.3f} s, chains {chains} (rows, steps, "
          f"target evaluations) = {res['ms_per_hmc_step']:.3f} ms per HMC step incl. the kept "
          f"steps' decode; peak {peak:.3f} GiB ({held:.3f} GiB held before it); {report}", flush=True)
    checks = {"one model built": len(built) == 1,
              "outputs finite": bool(np.all(np.isfinite(result))),
              "a checkpoint of epoch 0": os.path.exists(os.path.join(m.checkpoint_path,
                                                                     "ckpt-0.npz"))}
    if name == "Sim_heteroskedastic":
        checks.update({
            "decoder plain": type(m.nets["g"]).__name__ == "VariationalMLP",
            "2000 predictions, (2000, 1, 2) ordered intervals": (
                result.shape == (2000,) and intervals.shape == (2000, 1, 2)
                and bool(np.all(intervals[:, 0, 0] <= intervals[:, 0, 1]))),
            f"four chains of {BGM_BS} rows": [r for r, _, _ in chains] == [BGM_BS] * 4,
            f"{BGM_LEAPFROG} target evaluations per step (deterministic)": all(
                e == 1 + s * BGM_LEAPFROG for _, s, e in chains),
            "correlations finite": sum(1 for l in report if l.startswith("Pearson")) == 2
                                   and all(np.isfinite(float(l.split()[-1]))
                                           for l in report if l.startswith("Pearson")),
        })
    else:
        checks.update({
            "decoder flipout": type(m.nets["g"]).__name__ == "FlipoutVariationalMLP",
            "1000 rows imputed, (1000, 1, 2) intervals": (
                result.shape == (1000, 4) and intervals.shape == (1000, 1, 2)),
            "one chain of 1000 rows": [r for r, _, _ in chains] == [1000],
            f"L + 2 = {BGM_LEAPFROG + 2} target evaluations per step (stochastic)": (
                evals_per_step == [BGM_LEAPFROG + 2]),
            "RMSE line printed": any(l.startswith("Imputation RMSE") for l in report),
        })
    for check, ok in checks.items():
        print(f"{tag} {check}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed")
    return res


def _bgm_resume(bgm_mod, config_io, simulate_z_hetero, root):
    """29 (c): Sim_heteroskedastic's widths on N_RESUME rows (EGM 50, epochs
    0..3, lr_decay cosine), killed in the evaluate of epoch 2 and resumed by
    a new instance, against an uninterrupted run."""
    import numpy as np
    import torch

    params = config_io.load("configs/Sim_heteroskedastic.yaml")
    params.update(save_res=False)
    X, Y = simulate_z_hetero(n=N_RESUME, k=params["z_dim"], d=params["x_dim"] - 1, seed=3)
    data = np.hstack([X, Y[:, None]]).astype("float32")

    def run(folder, die_at=None):
        m = bgm_mod.BGM(dict(params, output_dir=os.path.join(root, folder)), timestamp="resume",
                        random_seed=5, device="cuda")
        if die_at is not None:
            n_calls, evaluate = [0], m.evaluate

            def dying(*a, **kw):
                n_calls[0] += 1
                if n_calls[0] == die_at:
                    raise RuntimeError("simulated kill")
                return evaluate(*a, **kw)
            m.evaluate = dying
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            m.fit(data, epochs=RESUME_EPOCHS, epochs_per_eval=1, batch_size=32,
                  egm_n_iter=RESUME_EGM, egm_batches_per_eval=RESUME_EGM, verbose=0)
        except RuntimeError as e:
            if die_at is None or "simulated kill" not in str(e):
                raise
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    with contextlib.redirect_stdout(io.StringIO()):
        ma, wall_a = run("a")
        mb1, wall_b1 = run("b", die_at=3)
        saved = sorted(os.listdir(mb1.checkpoint_path))
        mb2, wall_b2 = run("b")
    last = f"ckpt-{RESUME_EPOCHS}.npz"
    with np.load(os.path.join(ma.checkpoint_path, last)) as fa, \
            np.load(os.path.join(mb2.checkpoint_path, last)) as fb:
        keys = sorted(fa.files)
        differ = [k for k in keys if not np.array_equal(fa[k], fb[k])]
        same_keys = keys == sorted(fb.files)
    print(f"[29c resume] n={N_RESUME}: uninterrupted {wall_a:.3f} s, killed {wall_b1:.3f} s "
          f"(checkpoints {saved}), resumed {wall_b2:.3f} s; {len(keys)} leaves in {last}, "
          f"differing: {differ[:8]}", flush=True)
    checks = {
        "killed run wrote epochs 0 and 1": saved == ["ckpt-0.npz", "ckpt-1.npz"],
        "last checkpoints equal bit for bit": same_keys and not differ,
        "g_state, both generators and the latent moments in the file": {
            "['g_state']['norm']['var']", "['gen']", "['host_gen']", "['z_opt'].v"} <= set(keys),
        "nets, running statistics and data_z equal": (
            all(torch.equal(p, q) for k in ma.nets
                for p, q in zip(ma.nets[k].parameters(), mb2.nets[k].parameters()))
            and torch.equal(ma.nets["g"].bn_var, mb2.nets["g"].bn_var)
            and torch.equal(ma.data_z, mb2.data_z)),
    }
    for check, ok in checks.items():
        print(f"[29c resume] {check}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[29c resume] checks failed")
    return {"uninterrupted_s": wall_a, "killed_s": wall_b1, "resumed_s": wall_b2}


def _bgm_cli(root):
    """29 (d): python -m bayesgm_torch bgm in a new process on a 400-row
    .npz with NaN holes (the flipout decoder and the gradient penalty, the
    CLI's defaults)."""
    import numpy as np

    rng = np.random.RandomState(4)
    data = (rng.randn(400, 6) @ rng.randn(6, 6)).astype("float32")
    holes = rng.rand(*data.shape) < 0.05
    data[holes] = np.nan
    path = os.path.join(root, "holes.npz")
    np.savez(path, data=data)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bayesgm_torch", "bgm", "-o", root, "-i", path, "-d", "cli",
         "--device", "cuda", "--z_dim", "3", "-N", "20", "--egm_batches_per_eval", "20",
         "-E", "1", "--epochs_per_eval", "1", "-M", "20", "--burn_in", "20"],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t
    res_dirs = glob.glob(os.path.join(root, "results", "cli", "*"))
    imputed = None
    if proc.returncode == 0 and len(res_dirs) == 1:
        imputed = np.loadtxt(os.path.join(res_dirs[0], "imputed_data.txt"))
        with np.load(os.path.join(res_dirs[0], "prediction_intervals.npz"),
                     allow_pickle=True) as f:
            n_intervals = len(f["intervals"])
    std = np.nanstd(data, axis=0)
    scaled = (data - np.nanmean(data, axis=0)) / std
    print(f"[29d CLI] python -m bayesgm_torch bgm on 400 rows, {int(holes.sum())} holes: rc "
          f"{proc.returncode} in {wall:.3f} s; stderr tail {proc.stderr[-300:]!r}", flush=True)
    checks = {"rc 0 and one results folder": proc.returncode == 0 and len(res_dirs) == 1}
    if imputed is not None:
        checks.update({
            "imputed (400, 6), finite": imputed.shape == (400, 6) and bool(np.all(np.isfinite(imputed))),
            "observed entries kept (standardised)": bool(np.allclose(imputed[~holes],
                                                                     scaled[~holes], atol=1e-5)),
            "one interval entry per row": n_intervals == 400,
        })
    for check, ok in checks.items():
        print(f"[29d CLI] {check}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[29d CLI] checks failed")
    return {"wall_s": wall}


def mnist_phase() -> dict:
    """Phase 30: MNISTBGM through its entry points at the shipped widths
    (see the module docstring); raises on any failed check.  Returns the
    measured numbers."""
    import torch

    from bayesgm_torch.models import mnist as mnist_mod
    from bayesgm_torch.ops import mcmc

    out = {}
    calls, restore = _counting_kernel_calls()
    spans, chains = {}, []
    names = ("_train_batch_step", "_egm_iter")  # _egm_iter is BGM's, with MNIST's two steps
    saved = {name: vars(mnist_mod.MNISTBGM).get(name) for name in names}
    hmc = mcmc.hmc
    functional = torch.nn.functional
    convs = {"f32": 0, "tf32": 0}  # convolution calls by cuDNN's TF32 setting at the call
    conv_fns = {name: getattr(functional, name) for name in ("conv2d", "conv_transpose2d")}

    def spying(fn):
        def call(*a, **kw):
            convs["tf32" if torch.backends.cudnn.allow_tf32 else "f32"] += 1
            return fn(*a, **kw)
        return call

    def recording_hmc(log_prob_fn, init_state, *a, **kw):
        evals = [0]

        def counted(p, z, d):
            evals[0] += 1
            return log_prob_fn(p, z, d)
        res = timed_call(spans, "chain", hmc)(counted, init_state, *a, **kw)
        chains.append((init_state.shape[0], kw["burn_in"] + kw["n_keep"], evals[0]))
        return res

    for name in names:  # each step timed alone (host clock, synchronized)
        fn = getattr(mnist_mod.MNISTBGM, name)
        setattr(mnist_mod.MNISTBGM, name, staticmethod(timed_call(spans, name, fn)))
    mcmc.hmc = recording_hmc
    for name, fn in conv_fns.items():
        setattr(functional, name, spying(fn))
    # the phase runs under PyTorch's default, cuDNN's TF32 on, as a user's
    # process does: the model's entry points must turn it off themselves
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    root = tempfile.mkdtemp(prefix="chip_smoke_mnist_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # earlier phases' tensors still alive
    try:
        out["mnist"] = _mnist_driver_run(mnist_mod, root, spans, chains)
        out["mnist-flipout"] = _mnist_flipout(mnist_mod, root, spans, chains)
        out["mnist-resume"] = _mnist_resume(mnist_mod, root)
        tf32_after = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        restore()
        mcmc.hmc = hmc
        for name, fn in conv_fns.items():
            setattr(functional, name, fn)
        for name, fn in saved.items():
            if fn is None:
                delattr(mnist_mod.MNISTBGM, name)
            else:
                setattr(mnist_mod.MNISTBGM, name, fn)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["held_gib"] = held
    out["own_peak_gib"] = out["peak_gib"] - held
    out["convolutions"] = dict(convs)
    print(f"[30 MNIST] peak {out['peak_gib']:.3f} GiB allocated during phase 30, of which "
          f"{held:.3f} GiB held from earlier phases and {out['own_peak_gib']:.3f} GiB its own; "
          f"kernel wrapper calls: {calls}; convolution calls by cuDNN TF32 setting: {convs}, "
          f"the setting after the phase {tf32_after}; {torch.cuda.get_device_name(0)}, "
          f"nvidia-smi: {_card_line()}", flush=True)
    if sum(calls.values()):
        raise AssertionError("[30 MNIST] a kernel wrapper was called")
    if convs["tf32"] or not convs["f32"] or tf32_after is not True:
        raise AssertionError("[30 MNIST] a convolution ran in TF32, or the caller's TF32 "
                             "setting was not restored")
    return out


def _write_table(path, header, values, fmt, key=None):
    """A CSV with a header row, as the real files have it: the float matrix
    ``values`` in ``fmt`` (one per column, or one for all; a NaN becomes an
    empty field, as pandas writes it), after a first column of strings
    ``key`` when given."""
    import numpy as np

    buf = io.StringIO()
    np.savetxt(buf, values, fmt=fmt, delimiter=",")
    lines = buf.getvalue().replace("nan", "").splitlines()
    if key is not None:
        lines = [f"{k},{line}" for k, line in zip(key.tolist(), lines)]
    with open(path, "w") as f:
        f.write(",".join(header) + "\n" + "\n".join(lines) + "\n")


def _semi_fixtures(root, acic_ufid):
    """Seeded stand-ins for the ACIC-2018 and Twins files with their schema
    under ``root`` (the ``$BAYESGM_DATA`` layout).  ACIC: ``x.csv`` with
    ``sample_id`` and 177 covariates (106 continuous, 71 integer-coded) over
    ACIC_ROWS rows, the factuals ``sample_id,z,y`` of ACIC_FACTUALS of them
    (binary z by a logistic propensity, y with a heterogeneous effect).
    Twins: TWINS_PAIRS pairs, 50 covariates after the loader's drops, ~1 %
    of pairs with a NaN covariate, ~5 % with a first twin of 2000 g or
    more."""
    import numpy as np

    rng = np.random.RandomState(31)
    acic = os.path.join(root, "ACIC_2018")
    os.makedirs(os.path.join(acic, "scaling", "factuals"))
    ids = np.char.add("s", np.char.zfill(rng.permutation(ACIC_ROWS).astype(str), 6))
    cont = rng.randn(ACIC_ROWS, 106)
    ints = rng.randint(0, 5, size=(ACIC_ROWS, 71))
    _write_table(os.path.join(acic, "x.csv"), ["sample_id"] + [f"x_{i}" for i in range(177)],
                 np.c_[cont, ints], ["%.6g"] * 106 + ["%d"] * 71, key=ids)
    pick = rng.choice(ACIC_ROWS, size=ACIC_FACTUALS, replace=False)
    logit = cont[pick, :4] @ np.array([0.8, -0.5, 0.3, 0.4]) + 0.2 * (ints[pick, 0] - 2)
    z = (rng.uniform(size=ACIC_FACTUALS) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int64)
    y = (cont[pick, :6] @ rng.uniform(-1, 1, 6) + z * (1.0 + 0.5 * cont[pick, 0])
         + 0.5 * rng.randn(ACIC_FACTUALS))
    _write_table(os.path.join(acic, "scaling", "factuals", f"{acic_ufid}.csv"),
                 ["sample_id", "z", "y"], np.c_[z, y], ["%d", "%.6g"], key=ids[pick])

    twins = os.path.join(root, "Twins")
    os.makedirs(twins)
    n = TWINS_PAIRS
    cov = np.c_[rng.randn(n, 30), rng.randint(0, 9, size=(n, 20)).astype(np.float64)]
    cov[rng.choice(n, n // 100, replace=False), rng.randint(0, 30)] = np.nan
    idx = np.arange(n)
    _write_table(os.path.join(twins, "twin_pairs_X_3years_samesex.csv"),
                 ["Unnamed: 0", "Unnamed: 0.1"] + [f"cov_{i}" for i in range(50)]
                 + ["infant_id_0", "infant_id_1"],
                 np.c_[idx, idx, cov, 2 * idx, 2 * idx + 1],
                 ["%d", "%d"] + ["%.6g"] * 30 + ["%d"] * 20 + ["%d", "%d"])
    w0 = rng.randint(600, 2000, size=n).astype(np.float64)
    w1 = np.clip(w0 + rng.randint(-150, 150, size=n), 500, 1999).astype(np.float64)
    w1[rng.choice(n, n // 20, replace=False)] = rng.randint(2000, 2600, size=n // 20)
    _write_table(os.path.join(twins, "twin_pairs_T_3years_samesex.csv"),
                 ["Unnamed: 0", "dbirwt_0", "dbirwt_1"], np.c_[idx, w0, w1], "%d")
    _write_table(os.path.join(twins, "twin_pairs_Y_3years_samesex.csv"),
                 ["Unnamed: 0", "mort_0", "mort_1"],
                 np.c_[idx, rng.randint(0, 2, n), rng.randint(0, 2, n)], "%d")


def semi_phase() -> dict:
    """Phase 31: the semi-synthetic configs through the driver on seeded
    fixtures with the real schema, then K1 and K2 against their plain
    versions at their shapes (see the module docstring); raises on any
    failed check.  Returns the measured numbers."""
    import torch

    from bayesgm_torch import main as driver

    root = tempfile.mkdtemp(prefix="chip_smoke_semi_")
    data_env = os.environ.get("BAYESGM_DATA")
    out = {}
    try:
        t = time.perf_counter()
        _semi_fixtures(os.path.join(root, "data"), driver.ACIC_UFID)
        print(f"[31 semi] fixtures written in {time.perf_counter() - t:.3f} s", flush=True)
        os.environ["BAYESGM_DATA"] = os.path.join(root, "data")
        for name in ("Semi_acic", "Semi_Twins"):
            out[name] = _semi_driver_run(driver, root, name)
    finally:
        if data_env is None:
            os.environ.pop("BAYESGM_DATA", None)
        else:
            os.environ["BAYESGM_DATA"] = data_env
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    return out


def _semi_driver_run(driver, root, name):
    """31a (Semi_acic) or 31b (Semi_Twins): the shipped config through
    bayesgm_torch.main.main, cut to -e DRIVER_EPOCHS -b EGM_N_ITER and BURN_IN + N_MCMC MH
    steps, its spans timed and its launch counts checked; then K1 and K2
    against their plain versions at the config's shapes, timed."""
    import numpy as np
    import torch

    from bayesgm_torch.models.causalbgm import CausalBGM
    from bayesgm_torch.utils import config_io

    tag = "[31a semi-acic]" if name == "Semi_acic" else "[31b semi-twins]"
    text = (open(f"configs/{name}.yaml").read()
            .replace("output_dir: '.'", f"output_dir: '{os.path.join(root, 'out')}'")
            .replace("predict:\n  burn_in: 1000\n", ""))
    cfg_path = os.path.join(root, f"{name}.yaml")
    with open(cfg_path, "w") as f:
        f.write(text + f"predict:\n  burn_in: {BURN_IN}\n  n_mcmc: {N_MCMC}\n")
    print(f"{tag} config {config_io.load(cfg_path)}", flush=True)

    spans, built, loaded, after_fit = {}, [], [], {}
    init, load = CausalBGM.__init__, driver._load_causal_dataset

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        fit = timed_call(spans, "fit", self.fit)

        def fit_and_count(*fa, **fkw):
            try:
                return fit(*fa, **fkw)
            finally:
                after_fit.update({k: n.launches for k, n in self.kernels.items()})
        self.fit = fit_and_count
        self.predict = timed_call(spans, "predict", self.predict)
        self.egm_init = timed_call(spans, "egm_init", self.egm_init)
        built.append(self)

    def recording_load(dataset):
        res = timed_call(spans, "csv load", load)(dataset)
        loaded.append(res)
        return res

    CausalBGM.__init__, driver._load_causal_dataset = recording_init, recording_load
    printed = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            est, ci = driver.main(["-c", cfg_path, "-e", str(DRIVER_EPOCHS), "-b", str(EGM_N_ITER),
                                   "--device", "cuda"])
    finally:
        CausalBGM.__init__, driver._load_causal_dataset = init, load
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    lines = printed.getvalue().splitlines()
    model = built[0]
    x_np, y_np, v_np, _ = loaded[0]
    n = len(x_np)
    cfg = model.cfg
    fit_k2 = after_fit.get("bnn_hosteps_grad", -1)
    pred = {k: kern.launches - after_fit.get(k, 0) for k, kern in model.kernels.items()}
    steps = (DRIVER_EPOCHS + 1) * -(-n // FIT_BATCH)
    bs = 10000 if cfg.binary_treatment else n  # predict's subject batch (bs=None; the driver's n)
    n_batches = -(-n // bs)
    train_s = spans["fit"] - spans["egm_init"]
    report = [l for l in lines if l.startswith(("ATE estimate:", "ADRF RMSE:"))]
    res = {"n": n, "v_dim": v_np.shape[1], "z_dims": list(cfg.z_dims), "wall_s": wall,
           "csv_load_s": spans["csv load"], "fit_s": spans["fit"], "egm_s": spans["egm_init"],
           "ms_per_egm_iter": 1e3 * spans["egm_init"] / (EGM_N_ITER + 1),
           "ms_per_train_step_incl_evals": 1e3 * train_s / steps, "train_steps": steps,
           "predict_s": spans["predict"],
           "ms_per_mh_step_incl_collector": 1e3 * spans["predict"] / (BURN_IN + N_MCMC),
           "fit_launches": after_fit, "predict_launches": pred}
    print(f"{tag} n={n} rows, v_dim {v_np.shape[1]}, z_dims {list(cfg.z_dims)}, binary "
          f"{cfg.binary_treatment}: wall {wall:.3f} s; CSV load {spans['csv load']:.3f} s; fit "
          f"{spans['fit']:.3f} s (EGM {spans['egm_init']:.3f} s = {res['ms_per_egm_iter']:.3f} "
          f"ms per iteration; training and evaluations {train_s:.3f} s = "
          f"{res['ms_per_train_step_incl_evals']:.3f} ms per step over {steps}); predict "
          f"{spans['predict']:.3f} s ({res['ms_per_mh_step_incl_collector']:.3f} ms per MH step "
          f"incl. the collector, {n_batches} batch(es) of {bs}); launches: fit {after_fit}, "
          f"predict {pred}; {report}", flush=True)
    checks = {
        "one model built": len(built) == 1,
        f"K2 launches in fit == {steps} ({DRIVER_EPOCHS + 1} passes of {-(-n // FIT_BATCH)} "
        "batches)":
            fit_k2 == steps and sum(after_fit.values()) == steps,
        f"K1 launches in predict == {n_batches} + {n_batches} x {BURN_IN + N_MCMC}":
            pred["bnn_hosteps"] == n_batches
            and pred["bnn_hosteps_paired"] == n_batches * (BURN_IN + N_MCMC)
            and sum(pred.values()) == n_batches * (1 + BURN_IN + N_MCMC),
        "intervals finite and ordered": bool(np.all(np.isfinite(ci))
                                             and np.all(ci[:, 0] <= ci[:, 1])),
    }
    if cfg.binary_treatment:
        checks[f"ITE ({n},) finite, ATE line printed"] = (
            est.shape == (n,) and bool(np.all(np.isfinite(est)))
            and any(l.startswith("ATE estimate:") for l in report))
    else:
        checks["ADRF (20,) finite, RMSE line printed"] = (
            est.shape == (20,) and bool(np.all(np.isfinite(est)))
            and any(l.startswith("ADRF RMSE:") for l in report))
    for check, ok in checks.items():
        print(f"{tag} {check}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed")

    # K1 and K2 against their plain versions at this config's shapes
    res["kernels"] = _k1_k2_against_plain(tag, model, x_np, y_np, v_np, bs)
    res["kernels"]["K1 paired"]["launches"] = pred["bnn_hosteps_paired"]
    res["kernels"]["K1 unpaired"]["launches"] = pred["bnn_hosteps"]
    res["kernels"]["K2"]["launches"] = fit_k2
    return res


def _k1_k2_against_plain(tag, model, x_np, y_np, v_np, bs):
    """K1 (unpaired on a ``bs``-row predict batch, paired on two) and K2
    (FIT_BATCH rows) against their plain versions on ``model``'s nets and
    data, timed as in phase 7, each with its bound; raises if one
    disagrees.  Returns the numbers per case."""
    import numpy as np
    import torch

    from bayesgm_torch.ops._pk_bnn_hosteps import (
        logp_and_grad_plain,
        logp_plain,
        make_fused_causal_logp_and_grad_bnn_hosteps,
        make_fused_causal_logp_bnn_hosteps,
    )
    from bayesgm_torch.ops._pk_util import (
        flatten_flipout_params,
        flipout_step_perturbations,
        split_flipout_flat,
    )

    cfg, n = model.cfg, len(x_np)
    dev = torch.device("cuda")
    dims = [model.nets[k].dims for k in "ghf"]
    ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(model.nets[k])) for k in "ghf"))
    sigs = sum(sigs, [])
    x, y, v = (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (x_np, y_np, v_np))
    gen = torch.Generator(device=dev).manual_seed(31)
    z_dim = sum(cfg.z_dims)
    z = torch.randn((n, z_dim), generator=gen, device=dev)
    seed = torch.randint(0, 2**31 - 1, (2,), generator=gen, device=dev, dtype=torch.int32)
    ps, ps2 = flipout_step_perturbations(sigs, gen), flipout_step_perturbations(sigs, gen,
                                                                               n_sets=2)
    k1 = make_fused_causal_logp_bnn_hosteps(cfg, *dims)
    k1p = make_fused_causal_logp_bnn_hosteps(cfg, *dims, paired=True)
    k2 = make_fused_causal_logp_and_grad_bnn_hosteps(cfg, *dims)
    rows = [(r[:bs] if r.shape[0] > bs else r).contiguous() for r in (z, x, y, v)]
    paired = (torch.cat([rows[0] + 0.1 * torch.randn(rows[0].shape, generator=gen, device=dev),
                         rows[0]]), *(torch.cat([a, a]) for a in rows[1:]))
    a1 = (*rows, seed, *ws, ps)
    a1p = (*paired, seed, *ws, ps2)
    a2 = (*(r[:FIT_BATCH].contiguous() for r in (z, x, y, v)), seed, *ws, ps)
    b_rows = rows[0].shape[0]
    errs = [compare(f"{tag} K1 unpaired N={b_rows}", k1(*a1), logp_plain(cfg, *a1)),
            compare(f"{tag} K1 paired N={2 * b_rows}", k1p(*a1p), logp_plain(cfg, *a1p))]
    (neg_k, grad_k), (neg_p, grad_p) = k2(*a2), logp_and_grad_plain(cfg, *a2)
    errs_g = [compare(f"{tag} K2 value N={FIT_BATCH}", neg_k, neg_p),
              compare(f"{tag} K2 grad N={FIT_BATCH}", grad_k, grad_p, GRAD_RTOL, GRAD_ATOL)]
    macs = chain_macs(dims)
    w_floats = sum(t_.numel() for w in ws for t_ in w)
    p_floats = sum(p_.numel() for p_ in ps)

    def io_bytes(r, grad):  # z, x, y, v read; the value (and the z-gradient) written
        return 4 * r * (z_dim + 2 + v.shape[1] + 1 + (z_dim if grad else 0))

    cases = {
        "K1 unpaired": (k1, a1, lambda: logp_plain(cfg, *a1),
                        bound(io_bytes(b_rows, False) + 4 * (w_floats + p_floats),
                              b_rows * 4 * macs), b_rows),
        "K1 paired": (k1p, a1p, lambda: logp_plain(cfg, *a1p),
                      bound(io_bytes(2 * b_rows, False) + 4 * (w_floats + 2 * p_floats),
                            2 * b_rows * 4 * macs), 2 * b_rows),
        "K2": (k2, a2, lambda: logp_and_grad_plain(cfg, *a2),
               bound(io_bytes(FIT_BATCH, True) + 4 * (w_floats + p_floats),
                     FIT_BATCH * 8 * macs), FIT_BATCH),
    }
    kernels = {}
    for label, (kern, args, plain, (b_ms, b_by), r) in cases.items():
        tk, tp = time_ms(lambda: kern(*args)), time_ms(plain)
        td = device_ms(lambda: kern(*args))
        kernels[label] = {"rows": r, "ms": tk, "device_ms": td, "plain_ms": tp,
                          "bound_ms": b_ms, "bound_by": b_by}
        print(f"{tag} timing {label} N={r}: kernel {tk:.4f} ms (device {td:.4f} ms), plain "
              f"{tp:.4f} ms, plain/kernel {tp / tk:.2f}x; bound {b_ms:.6f} ms ({b_by}), device "
              f"time at {100 * b_ms / td:.2f} % of it; {torch.cuda.get_device_name(0)}, "
              f"nvidia-smi: {_card_line()}", flush=True)
    kernels["K1 paired"]["max_abs_err"] = max(errs)
    kernels["K2"]["max_abs_err"] = max(errs_g)
    return kernels


def gates_phase() -> dict:
    """Phase 34: the gate runners in process at tiny sizes, their launch
    counts checked; then K1 paired and K2 against their plain versions at
    binary_ate's widths and full n (see the module docstring); raises on
    any failed check.  Returns the measured numbers."""
    import numpy as np
    import torch

    from bayesgm_torch.benchmarks import binary_ate, mnist_inpaint, sun_colangelo_ivae
    from bayesgm_torch.models.causalbgm import CausalBGM

    tag = "[34 gates]"
    t_phase = time.perf_counter()
    cut = ["--n", str(GATE_N), "--egm", str(GATE_EGM), "--epochs", "1",
           "--n_mcmc", str(GATE_MH), "--burn_in", str(GATE_MH)]
    runs = {
        "binary base": lambda: binary_ate.main(cut),
        "binary identifiable": lambda: binary_ate.main(["--engine", "identifiable", *cut]),
        "sun": lambda: sun_colangelo_ivae.main(["--runs", "SUN", *cut])[0],
        "mnist": lambda: mnist_inpaint.main([
            "--lr_decay", "cosine", "--n", str(GATE_IMAGES), "--n_test", str(GATE_TEST),
            "--egm", str(GATE_EGM), "--epochs", "1", "--n_mcmc", str(GATE_HMC),
            "--burn_in", str(GATE_HMC)]),
    }
    lines, walls = {}, {}
    for name, run in runs.items():
        t = time.perf_counter()
        lines[name] = run()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        print(f"{tag} {name}: wall {walls[name]:.3f} s", flush=True)

    steps = 2 * -(-GATE_N // FIT_BATCH)
    batches = -(-GATE_N // 10000)  # binary predict's subject batches
    base = lines["binary base"]
    zero = {k: 0 for k in base["launches_fit"]}
    checks = {
        f"binary base: K2 launches in fit == {steps} (2 passes of {steps // 2} batches)":
            base["launches_fit"] == {**zero, "bnn_hosteps_grad": steps},
        f"binary base: K1 launches in predict == {batches} + {batches} x {2 * GATE_MH}":
            base["launches_predict"] == {**zero, "bnn_hosteps": batches,
                                         "bnn_hosteps_paired": batches * 2 * GATE_MH},
        "identifiable (binary, SUN): no kernel launched": all(
            not any(lines[k][f"launches_{w}"].values())
            for k in ("binary identifiable", "sun") for w in ("fit", "predict")),
        "binary: dATE, PEHE finite, coverage in [0, 1], widths > 0": all(
            np.isfinite(lines[k]["d_ate"]) and np.isfinite(lines[k]["pehe"])
            and 0.0 <= lines[k]["ite_coverage"] <= 1.0 and lines[k]["iv_width_mean"] > 0
            for k in ("binary base", "binary identifiable")),
        "SUN: RMSE finite, coverage in [0, 1]": bool(
            np.isfinite(lines["sun"]["rmse"]) and 0.0 <= lines["sun"]["coverage"] <= 1.0),
        "MNIST: L1, accuracy in [0, 1], MSE finite": bool(
            0.0 <= lines["mnist"]["inpaint_l1"] <= 1.0
            and 0.0 <= lines["mnist"]["inpaint_accuracy"] <= 1.0
            and np.isfinite(lines["mnist"]["mse_reconstruction"])),
    }
    for check, ok in checks.items():
        print(f"{tag} {check}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed")

    # K1 and K2 at binary_ate's widths (v_dim 100, z_dims [3,6,3,6]) and its
    # full n, on the nets of a model built from its params
    x, y, v, _ = binary_ate.make_data()
    params = dict(v_dim=v.shape[1], z_dims=[3, 6, 3, 6], binary_treatment=True,
                  dataset="chip_smoke_gates", output_dir=tempfile.gettempdir(), use_bnn=True,
                  save_res=False, save_model=False)
    model = CausalBGM(params, random_seed=123, device="cuda")
    kernels = _k1_k2_against_plain(tag, model, x, y, v, 10000)
    kernels["K1 paired"]["launches"] = base["launches_predict"]["bnn_hosteps_paired"]
    kernels["K1 unpaired"]["launches"] = base["launches_predict"]["bnn_hosteps"]
    kernels["K2"]["launches"] = base["launches_fit"]["bnn_hosteps_grad"]
    torch.cuda.synchronize()
    out = {"lines": lines, "walls_s": walls, "kernels": kernels,
           "phase_s": time.perf_counter() - t_phase}
    print(f"{tag} phase wall {out['phase_s']:.3f} s", flush=True)
    return out


def roofline_phase(k1_paired_device_ms, flagship_nets) -> dict:
    """Phase 32: the roofline anchors measured on the card, the report for
    K1 paired at 2N rows, the network facade on the card, weight-space HMC
    through it, the low-rank algebra, the latent-dimension estimator and the
    low-rank design (see the module docstring); raises on any failed
    check.  Returns the measured numbers."""
    import numpy as np
    import torch

    from bayesgm_torch import Sim_Hirano_Imbens_sampler, estimate_latent_dims
    from bayesgm_torch.benchmarks import mxu_probe as mp
    from bayesgm_torch.datasets.simulators import simulate_regression
    from bayesgm_torch.models import networks
    from bayesgm_torch.utils import roofline

    card = f"{torch.cuda.get_device_name(0)}, nvidia-smi: {_card_line()}"
    out = {}
    # (a) the anchors, in this process, against the datasheet figures
    peak = roofline.measure_matmul_peak("float32")
    bw = roofline.measure_hbm_bandwidth()
    out.update(matmul_peak_tflops=peak / 1e12, hbm_tb_per_s=bw / 1e12)
    print(f"[32 roofline] f32 GEMM 4096^3 (TF32 off) {peak / 1e12:.3f} TFLOP/s "
          f"({100 * peak / mp.F32_FLOP_PER_S:.1f} % of {mp.F32_FLOP_PER_S / 1e12:.0f}); HBM triad "
          f"{bw / 1e12:.4f} TB/s ({100 * bw / mp.HBM_BYTES_PER_S:.1f} % of "
          f"{mp.HBM_BYTES_PER_S / 1e12:.2f}); {card}", flush=True)
    flops_row, bytes_row = roofline.bnn_eval_cost(flagship_nets, V_DIM)
    report = roofline.roofline_report(2 * N / (k1_paired_device_ms / 1e3), flops_row, bytes_row,
                                      peak, bw)
    out["k1_paired_report"] = report
    print(f"[32 roofline] K1 paired at {2 * N} rows, device {k1_paired_device_ms:.4f} ms "
          f"(phase 7): {report}", flush=True)

    # (b) every facade class on the card, one forward each
    x4 = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    img = np.random.default_rng(1).random((2, 28, 28, 1)).astype(np.float32)
    shapes = {}
    for cls, kw, inp in (
            (networks.BaseFullyConnectedNet, dict(input_dim=4, output_dim=3), x4),
            (networks.Discriminator, dict(input_dim=4), x4),
            (networks.BaseVariationalNet, dict(input_dim=4, output_dim=3), x4),
            (networks.BaseVariationalLowRankNet, dict(input_dim=4, output_dim=3), x4),
            (networks.BayesianFullyConnectedNet, dict(input_dim=4, output_dim=3), x4),
            (networks.BayesianVariationalNet, dict(input_dim=4, output_dim=3), x4),
            (networks.BayesianVariationalLowRankNet, dict(input_dim=4, output_dim=3), x4),
            (networks.MCMCFullyConnectedNet, dict(input_dim=4, output_dim=3), x4),
            (networks.MNISTEncoderConv, {}, img),
            (networks.MNISTGenerator, {}, np.zeros((2, 10), np.float32)),
            (networks.MNISTDiscriminator, {}, img)):
        res = cls(**kw, device="cuda")(inp)
        res = res if isinstance(res, tuple) else (res,)
        if not all(r.is_cuda and bool(torch.isfinite(r).all()) for r in res):
            raise AssertionError(f"[32 facade] {cls.__name__}: output off the card or not finite")
        shapes[cls.__name__] = [tuple(r.shape) for r in res]
    print(f"[32 facade] one forward each on cuda: {shapes}", flush=True)

    # (c) weight-space HMC through the facade on a small regression
    rng = np.random.RandomState(0)
    xr = rng.randn(200, 2).astype(np.float32)
    yr = (xr[:, :1] - 0.5 * xr[:, 1:] + 0.1 * rng.randn(200, 1)).astype(np.float32)
    mnet = networks.MCMCFullyConnectedNet(input_dim=2, output_dim=1, nb_units=[16], device="cuda")
    printed = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        samples = networks.run_mcmc_for_net(
            mnet, xr, yr, lambda y_true, y_pred: -0.5 * torch.sum((y_true - y_pred) ** 2) / 0.01,
            num_samples=50, num_burnin_steps=50)
    hmc_s = time.perf_counter() - t
    rate = float(printed.getvalue().split("Acceptance rate:")[1].split()[0])
    out.update(hmc_ms_per_step=1e3 * hmc_s / 100, hmc_accept=rate)
    print(f"[32 facade] run_mcmc_for_net 50 + 50 steps: samples {samples.shape}, acceptance "
          f"{rate:.4f}, {1e3 * hmc_s / 100:.3f} ms per step; {card}", flush=True)

    # (d) the low-rank algebra at p = 100, rank 2
    lr = networks.BaseVariationalLowRankNet(input_dim=4, output_dim=100, nb_units=[64], rank=2,
                                            device="cuda")
    with torch.no_grad():
        _, var_d, u = lr(x4)
        sigma = torch.diag_embed(var_d) + u @ u.transpose(-1, -2)
        inv_err = float((lr.compute_covariance_inverse(var_d, u) @ sigma
                         - torch.eye(100, device="cuda")).abs().max())
        logdet = lr.compute_log_det(var_d, u)
        dense_logdet = torch.linalg.slogdet(sigma.double())[1]
        logdet_err = float((logdet.double() - dense_logdet).abs().max())
    out.update(woodbury_max_err=inv_err, sylvester_max_abs_err=logdet_err)
    print(f"[32 low-rank] p=100, rank 2, 8 rows: max |Sigma^-1 Sigma - I| {inv_err:.3e} (limit "
          f"1e-4); max |log det - slogdet(dense, f64)| {logdet_err:.3e} (limit 1e-4 + 1e-5 "
          f"|log det|)", flush=True)

    # (e) the latent-dimension estimator on a Sim_Hirano_Imbens sample
    xh, yh, vh = Sim_Hirano_Imbens_sampler(N=N, v_dim=V_DIM, seed=0).load_all()
    t = time.perf_counter()
    dims_est = estimate_latent_dims(xh, yh, vh)
    est_s = time.perf_counter() - t
    out.update(estimate_latent_dims=dims_est, estimate_s=est_s)
    print(f"[32 estimator] estimate_latent_dims on Sim_Hirano_Imbens (n={N}, v_dim={V_DIM}): "
          f"{dims_est} in {est_s:.3f} s (host)", flush=True)

    # (f) the low-rank design without scikit-learn
    xs, ys = simulate_regression(500, 20, 2, effective_rank=5)
    checks = {
        f"GEMM peak <= 1.05 x {mp.F32_FLOP_PER_S / 1e12:.0f} TFLOP/s":
            0 < peak <= 1.05 * mp.F32_FLOP_PER_S,
        f"HBM triad <= 1.05 x {mp.HBM_BYTES_PER_S / 1e12:.2f} TB/s":
            0 < bw <= 1.05 * mp.HBM_BYTES_PER_S,
        "every facade class ran on cuda": len(shapes) == 11,
        "HMC samples (50, n_weights) finite": (samples.shape == (50, mnet.get_weights().numel())
                                               and bool(np.all(np.isfinite(samples)))),
        "HMC acceptance in (0, 1]": 0.0 < rate <= 1.0,
        "Woodbury within 1e-4": inv_err <= 1e-4,
        "Sylvester equals slogdet": bool(torch.allclose(logdet.double(), dense_logdet,
                                                        rtol=1e-5, atol=1e-4)),
        "estimated dims: four, z0 = 3, all >= 1": (len(dims_est) == 4 and dims_est[0] == 3
                                                   and min(dims_est) >= 1),
        "simulate_regression(effective_rank=5) without scikit-learn": (
            xs.shape == (500, 20) and ys.shape == (500, 2) and bool(np.all(np.isfinite(xs)))
            and "sklearn" not in sys.modules),
    }
    for check, ok in checks.items():
        print(f"[32] {check}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[32] checks failed")
    return out


def _card_line():
    from bayesgm_torch.utils.device import card_info

    return card_info()


def _mnist_step_times(spans, before, egm_iters, chain_steps):
    """Per-step ms from the spans added since ``before``."""
    def added(name):
        return spans.get(name, 0.0) - before.get(name, 0.0)
    return {"ms_per_egm_iter": 1e3 * added("_egm_iter") / egm_iters["iters"],
            "ms_per_train_step": 1e3 * added("_train_batch_step") / egm_iters["steps"],
            "ms_per_hmc_step": 1e3 * added("chain") / chain_steps}


def _mnist_checks(tag, model, mse0, predictions, new_chains):
    """The checks 30a and 30b share; raises if one fails."""
    import numpy as np

    losses = {**model.egm_losses, **model.fit_losses}
    checks = {
        "EGM and training losses finite": all(np.isfinite(v) for v in losses.values()),
        f"MSE_x after the fit {model.history_loss[-1]:.5f} below the untrained model's "
        f"{mse0:.5f}": model.history_loss[-1] < mse0,
        "imputed pixels finite, in [0, 1]": all(
            bool(np.all(np.isfinite(imp)) and np.all((imp >= 0) & (imp <= 1)))
            for _, imp, _ in predictions),
        "observed pixels untouched": all(
            bool(np.array_equal(imp[~np.isnan(test)], test[~np.isnan(test)]))
            for test, imp, _ in predictions),
        "intervals ordered": all(bool(np.all(iv[..., 0] <= iv[..., 1])) for _, _, iv in predictions),
        f"L + 2 = {MNIST_LEAPFROG + 2} target evaluations per HMC step": all(
            e == 1 + s * (MNIST_LEAPFROG + 2) for _, s, e in new_chains),
        "64 rows per chain": [r for r, _, _ in new_chains] == [64] * len(predictions),
    }
    for check, ok in checks.items():
        print(f"{tag} {check}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed")


def _recording_model(mnist_mod, built, predictions, mse0):
    """Patch ``MNISTBGM.__init__`` to record each model, the untrained
    model's reconstruction MSE (under a generator of its own, so the
    model's streams are untouched) and every predict's input and output."""
    import numpy as np
    import torch

    init = mnist_mod.MNISTBGM.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        fit, predict = self.fit, self.predict

        def fit_(data, **kw_):
            gen = torch.Generator(device=self.device).manual_seed(0)
            mse0.append(float(self.evaluate(data, generator=gen)))
            return fit(data, **kw_)

        def predict_(data, **kw_):
            imputed, iv = predict(data, **kw_)
            predictions.append((np.asarray(data), imputed, iv))
            return imputed, iv
        self.fit, self.predict = fit_, predict_
        built.append(self)
    mnist_mod.MNISTBGM.__init__ = recording_init
    return init


def _mnist_driver_run(mnist_mod, root, spans, chains):
    """30 (a): configs/Mnist.yaml through bayesgm_torch.main.main."""
    import torch

    from bayesgm_torch import main as driver

    text = (open("configs/Mnist.yaml").read().replace("output_dir: '.'", f"output_dir: '{root}'")
            + f"fit:\n  epochs_per_eval: 1\npredict:\n  burn_in: {MNIST_HMC}\n"
            f"  n_mcmc: {MNIST_HMC}\n")
    cfg_path = os.path.join(root, "Mnist.yaml")
    with open(cfg_path, "w") as f:
        f.write(text)
    built, predictions, mse0 = [], [], []
    before, n_chains = dict(spans), len(chains)
    init = _recording_model(mnist_mod, built, predictions, mse0)
    printed = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            results = driver.main(["-c", cfg_path, "-e", str(MNIST_EPOCHS), "-b", str(MNIST_EGM),
                                   "--device", "cuda"])
    finally:
        mnist_mod.MNISTBGM.__init__ = init
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    m, new_chains = built[0], chains[n_chains:]
    steps = (MNIST_EPOCHS + 1) * (len(m.data_z) // 32)
    res = {"wall_s": wall, "train_steps": steps, "untrained_mse": mse0[0],
           "mse_x": m.history_loss, "results": results,
           **_mnist_step_times(spans, before, {"iters": MNIST_EGM + 1, "steps": steps},
                               sum(s for _, s, _ in new_chains))}
    lines = [l for l in printed.getvalue().splitlines()
             if l.startswith(("Inpainting", "HMC Acceptance", "MNIST unavailable", "Loaded MNIST"))]
    print(f"[30a mnist] {len(m.data_z)} images: wall {wall:.3f} s; EGM iteration "
          f"{res['ms_per_egm_iter']:.3f} ms, training step {res['ms_per_train_step']:.3f} ms over "
          f"{steps}, HMC step at 64 images {res['ms_per_hmc_step']:.3f} ms incl. the kept steps' "
          f"decode, chains {new_chains} (rows, steps, target evaluations); MSE_x {m.history_loss} "
          f"(untrained {mse0[0]:.5f}); {lines}", flush=True)
    if len(built) != 1 or type(m.nets["g"]).__name__ != "MNISTGenerator" or m.cfg.use_bnn:
        raise AssertionError("[30a mnist] expected one plain-generator MNISTBGM")
    _mnist_checks("[30a mnist]", m, mse0[0], predictions, new_chains)
    if len(predictions) != 4 or not os.path.exists(os.path.join(m.checkpoint_path, "ckpt-1.npz")):
        raise AssertionError("[30a mnist] four masks and a checkpoint of epoch 1 expected")
    return res


def _mnist_flipout(mnist_mod, root, spans, chains):
    """30 (b): the flipout generator through the model's API."""
    import numpy as np
    import torch

    from bayesgm_torch.datasets.images import load_mnist_images
    from bayesgm_torch.utils import config_io
    from bayesgm_torch.utils.helpers import mnist_mask_indices

    params = config_io.load("configs/Mnist.yaml")
    params.update(use_bnn=True, output_dir=os.path.join(root, "b"), save_res=False,
                  save_model=False)
    with contextlib.redirect_stdout(io.StringIO()):
        data = load_mnist_images()
    built, predictions, mse0 = [], [], []
    before, n_chains = dict(spans), len(chains)
    init = _recording_model(mnist_mod, built, predictions, mse0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        m = mnist_mod.MNISTBGM(params, random_seed=123, device="cuda")
        with contextlib.redirect_stdout(io.StringIO()):
            m.fit(data, epochs=0, epochs_per_eval=1, egm_n_iter=MNIST_BNN_EGM,
                  egm_batches_per_eval=MNIST_BNN_EGM + 1, verbose=0)
            _, miss = mnist_mask_indices(mode="upper_half")
            test = np.array(data[:64]).reshape(64, -1)
            test[:, miss] = np.nan
            m.predict(test.reshape(64, 28, 28, 1), bs=64, n_mcmc=MNIST_HMC, burn_in=MNIST_HMC)
    finally:
        mnist_mod.MNISTBGM.__init__ = init
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    new_chains = chains[n_chains:]
    steps = len(m.data_z) // 32
    res = {"wall_s": wall, "train_steps": steps, "untrained_mse": mse0[0], "mse_x": m.history_loss,
           **_mnist_step_times(spans, before, {"iters": MNIST_BNN_EGM + 1, "steps": steps},
                               sum(s for _, s, _ in new_chains))}
    print(f"[30b mnist-flipout] wall {wall:.3f} s; EGM iteration {res['ms_per_egm_iter']:.3f} ms, "
          f"training step {res['ms_per_train_step']:.3f} ms over {steps}, HMC step at 64 images "
          f"{res['ms_per_hmc_step']:.3f} ms, chains {new_chains}; MSE_x {m.history_loss} "
          f"(untrained {mse0[0]:.5f})", flush=True)
    if type(m.nets["g"].u1).__name__ != "FlipoutConv":
        raise AssertionError("[30b mnist-flipout] expected the flipout generator")
    _mnist_checks("[30b mnist-flipout]", m, mse0[0], predictions, new_chains)
    return res


def _mnist_resume(mnist_mod, root):
    """30 (c): Mnist.yaml's widths on MNIST_RESUME_N ellipse images (EGM
    50, epochs 0..2, cosine decay), killed in the evaluate of epoch 1 and
    resumed by a new instance, against an uninterrupted run."""
    import numpy as np
    import torch

    from bayesgm_torch.datasets.images import make_ellipse_images
    from bayesgm_torch.utils import config_io

    params = config_io.load("configs/Mnist.yaml")
    params.update(save_res=False)
    data = make_ellipse_images(MNIST_RESUME_N, seed=5)

    def run(folder, die_at=None):
        m = mnist_mod.MNISTBGM(dict(params, output_dir=os.path.join(root, folder)),
                               timestamp="resume", random_seed=5, device="cuda")
        if die_at is not None:
            n_calls, evaluate = [0], m.evaluate

            def dying(*a, **kw):
                n_calls[0] += 1
                if n_calls[0] == die_at:
                    raise RuntimeError("simulated kill")
                return evaluate(*a, **kw)
            m.evaluate = dying
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            m.fit(data, epochs=2, epochs_per_eval=1, batch_size=32, egm_n_iter=50,
                  egm_batches_per_eval=51, verbose=0)
        except RuntimeError as e:
            if die_at is None or "simulated kill" not in str(e):
                raise
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    # cuDNN's default convolution backward algorithms may accumulate with
    # atomics, in another order each run: bit-equal resume needs its
    # deterministic algorithms (this phase only)
    modes = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            ma, wall_a = run("a")
            mb1, wall_b1 = run("b", die_at=2)
            saved = sorted(os.listdir(mb1.checkpoint_path))
            mb2, wall_b2 = run("b")
        with np.load(os.path.join(ma.checkpoint_path, "ckpt-2.npz")) as fa, \
                np.load(os.path.join(mb2.checkpoint_path, "ckpt-2.npz")) as fb:
            keys = sorted(fa.files)
            differ = [k for k in keys if not np.array_equal(fa[k], fb[k])]
            same_keys = keys == sorted(fb.files)
        deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = modes
    print(f"[30c mnist-resume] {MNIST_RESUME_N} images: uninterrupted {wall_a:.3f} s, killed "
          f"{wall_b1:.3f} s (checkpoints {saved}), resumed {wall_b2:.3f} s; {len(keys)} leaves, "
          f"differing: {differ[:8]} ({len(differ)}); cudnn.deterministic, benchmark "
          f"{deterministic}", flush=True)
    checks = {
        "killed run wrote epoch 0": saved == ["ckpt-0.npz"],
        "last checkpoints equal bit for bit": same_keys and not differ,
        "Adam states, both generators and the latent moments in the file": {
            "['opt_g'].m['u1']['w']", "['opt_ge'].v['e']['c1']['w']", "['gen']", "['host_gen']",
            "['z_opt'].v", "['data_z']"} <= set(keys),
        "nets and data_z equal": (
            all(torch.equal(p, q) for k in ma.nets
                for p, q in zip(ma.nets[k].parameters(), mb2.nets[k].parameters()))
            and torch.equal(ma.data_z, mb2.data_z)),
    }
    for check, ok in checks.items():
        print(f"[30c mnist-resume] {check}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[30c mnist-resume] checks failed")
    return {"uninterrupted_s": wall_a, "killed_s": wall_b1, "resumed_s": wall_b2,
            "leaves": len(keys)}


class _StepClock:
    """Wall time of calls ``first``..``last`` of the module function
    ``module.name`` (a synchronize before call ``first`` and after call
    ``last``; none between), patched for the ``with`` block; ``ms`` is the
    time per call."""

    def __init__(self, module, name, last, first=1):
        self.module, self.name, self.first, self.last = module, name, first, last
        self.calls, self.t0, self.t1 = 0, None, None

    def __enter__(self):
        import torch

        fn = self.orig = getattr(self.module, self.name)

        def clocked(*a, **kw):
            self.calls += 1
            if self.calls == self.first:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
            out = fn(*a, **kw)
            if self.calls == self.last:
                torch.cuda.synchronize()
                self.t1 = time.perf_counter()
            return out

        setattr(self.module, self.name, clocked)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    @property
    def ms(self):
        return 1e3 * (self.t1 - self.t0) / (self.last - self.first + 1)


def _mesh_fit_predict(use_bnn, data_np, out_dir, mesh, timestamp):
    """Phase 33's run of one flagship model (seed 123): fit cut to EGM 50 and
    one pass (checkpoint at its eval epoch), predict by MH (100 + 100
    steps), then the raw MH states of the same schedule; returns the model,
    the launch counts of fit and predict, the draws and ms per step."""
    import numpy as np
    import torch

    from bayesgm_torch import CausalBGM
    from bayesgm_torch.models import causalbgm as cb
    from bayesgm_torch.ops import mcmc
    from bayesgm_torch.ops import rows as rows_mod

    model = CausalBGM(dict(flagship_params(out_dir, use_bnn), save_model=True), timestamp=timestamp,
                      random_seed=123, device=mesh.device if mesh is not None else "cuda")
    n_steps = -(-N // FIT_BATCH)
    for k in model.kernels.values():
        k.launches = 0
    with _StepClock(cb, "_train_batch_step", n_steps) as fit_clock:
        model.fit(data_np, epochs=0, epochs_per_eval=1, batch_size=FIT_BATCH,
                  egm_n_iter=MESH_EGM, egm_batches_per_eval=500, verbose=0, mesh=mesh)
    fit_launches = {k: w.launches for k, w in model.kernels.items()}
    for k in model.kernels.values():
        k.launches = 0
    with _StepClock(mcmc, "_mh_step", MESH_STEPS) as mh_clock:
        adrf, ci, draws = model.predict(data_np, x_values=np.linspace(0, 3, MESH_GRID),
                                        alpha=0.01, burn_in=MESH_STEPS, n_mcmc=MESH_STEPS,
                                        q_sd=1.0, return_draws=True, mesh=mesh)
    pred_launches = {k: w.launches for k, w in model.kernels.items()}
    lp, plp, make_params, _ = model._make_param_log_prob(mesh=mesh)
    rows = None if mesh is None else mesh.rows(N)
    gen = torch.Generator(device=model.device).manual_seed(11)
    with torch.no_grad(), rows_mod.split(rows):
        local = tuple(a if rows is None else a[rows.lo:rows.hi] for a in data_np)
        init = cb._randn_rows((len(local[0]), sum(Z_DIMS)), gen, model.device)
        states = mcmc.adaptive_mh(lp, init, gen, burn_in=MESH_STEPS, n_keep=MESH_STEPS,
                                  q_sd=1.0, recompute_current=use_bnn,
                                  paired_log_prob_fn=plp, params=make_params(
                                      model.nets, local, use_bnn), mesh=mesh).samples
        if rows is not None:
            states = rows.gather(states, axis=1)
    return dict(model=model, fit=fit_launches, predict=pred_launches, adrf=adrf, ci=ci,
                draws=draws, states=states, fit_ms=fit_clock.ms, mh_ms=mh_clock.ms)


def _checkpoint_leaves(model):
    import numpy as np

    from bayesgm_torch.utils import checkpoint as ckpt_mod

    with np.load(ckpt_mod.latest_checkpoint(model.checkpoint_path)) as f:
        return {k: f[k] for k in f.files}


def _mesh_rank(rank, world, init_method, out_dir, data_path):
    """33b: one rank of a gloo world on the card: the dry run's sections,
    the plain flagship's fit and predict, and this rank's K4 and K1 paired
    (rho = -20) against their plain versions on its rows; writes its
    results to ``{out_dir}/rank{rank}.npz``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from bayesgm_torch import CausalBGM
    from bayesgm_torch.ops._pk_bnn_hosteps import logp_plain
    from bayesgm_torch.ops._pk_plain import logp_plain as plain_logp
    from bayesgm_torch.ops._pk_util import (
        flatten_flipout_params,
        flatten_mlp_params,
        flipout_step_perturbations,
        split_flipout_flat,
    )
    from bayesgm_torch.parallel import make_mesh
    from bayesgm_torch.parallel.dryrun import run_sections

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=180))
    mesh = make_mesh(world)
    t = time.perf_counter()
    run_sections(mesh, os.path.join(out_dir, f"dry{rank}"))
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t
    with np.load(data_path) as f:
        data_np = tuple(f[k] for k in "xyv")
    res = _mesh_fit_predict(False, data_np, os.path.join(out_dir, "plain"), mesh, "w2")
    model = res["model"]
    # this rank's K4 and K1 paired against their plain versions on its rows
    rows = mesh.rows(N)
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(5)
    x, y, v = (torch.as_tensor(a[rows.lo:rows.hi], device=dev) for a in data_np)
    z = torch.randn((rows.local, sum(Z_DIMS)), generator=gen, device=dev)
    flats = [flatten_mlp_params(model.nets[k]) for k in "ghf"]
    k4 = model.kernels["plain"]
    err4 = compare(f"[33b rank {rank} K4 on rows {rows.lo}:{rows.hi}]", k4(z, x, y, v, *flats),
                   plain_logp(model.cfg, z, x, y, v, *flats))
    bnn = CausalBGM(flagship_params(os.path.join(out_dir, "bnn")), random_seed=123, device=dev)
    with torch.no_grad():
        for k in "ghf":
            for r in bnn.nets[k].rho:
                r.fill_(-20.0)
    ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(bnn.nets[k])) for k in "ghf"))
    ps2 = flipout_step_perturbations(sum(sigs, []), gen, n_sets=2)
    seed = mesh.mix_seed(torch.randint(0, 2**31 - 1, (2,), generator=gen, device=dev,
                                       dtype=torch.int32))
    zz = torch.cat([z, torch.randn(z.shape, generator=gen, device=dev)])
    args = (zz, *(torch.cat([a, a]) for a in (x, y, v)), seed, *ws, ps2)
    k1 = bnn.kernels["bnn_hosteps_paired"]
    err1 = compare(f"[33b rank {rank} K1 paired rho=-20 on 2 x rows {rows.lo}:{rows.hi}]",
                   k1(*args), logp_plain(bnn.cfg, *args))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             adrf=res["adrf"], ci=res["ci"], draws=res["draws"],
             states=res["states"].cpu().numpy(), data_z=model.data_z.cpu().numpy(),
             fit=np.asarray([res["fit"]["plain_grad"], res["fit"]["plain"]]),
             predict=np.asarray([res["predict"]["plain_grad"], res["predict"]["plain"]]),
             k4_launches=np.asarray(k4.launches), k1_launches=np.asarray(k1.launches),
             err4=np.asarray(err4), err1=np.asarray(err1), dry_s=np.asarray(dry_s),
             fit_ms=np.asarray(res["fit_ms"]), mh_ms=np.asarray(res["mh_ms"]),
             **{f"net.{k}.{i}": p.detach().cpu().numpy()
                for k in "ghf" for i, p in enumerate(model.nets[k].parameters())})
    dist.destroy_process_group()


def mesh_phase(card) -> dict:
    """Phase 33: every mesh path on the card (see the module docstring)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from bayesgm_torch import Sim_Hirano_Imbens_sampler
    from bayesgm_torch.parallel import make_mesh

    data_np = tuple(np.asarray(a, np.float32) for a in
                    Sim_Hirano_Imbens_sampler(batch_size=32, N=N, v_dim=V_DIM, seed=0).load_all())
    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        # 33a: NCCL, world 1, the BNN flagship against mesh=None
        dist.init_process_group("nccl", init_method=f"file://{root}/rdzv_nccl", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=300))
        try:
            mesh1 = make_mesh(1)
            runs = {tag: _mesh_fit_predict(True, data_np, os.path.join(root, tag), m, tag)
                    for tag, m in (("mesh", mesh1), ("none", None))}
            plain1 = _mesh_fit_predict(False, data_np, os.path.join(root, "plain1"), mesh1, "w1")
        finally:
            dist.destroy_process_group()
        a, b = runs["mesh"], runs["none"]
        leaves_a, leaves_b = _checkpoint_leaves(a["model"]), _checkpoint_leaves(b["model"])
        near = ("['best_loss']", "['best_causal_pre']")  # means over rows: all-reduced sums
        diff = sorted(k for k in leaves_b if k not in near
                      and not np.array_equal(leaves_a[k], leaves_b[k]))
        err_adrf = float(np.max(np.abs(a["draws"] - b["draws"]) / np.abs(b["draws"])))
        checks = {
            f"checkpoint leaves ({len(leaves_b)}: nets, Adam states, latent table and moments, "
            "generators, snapshots) bit-equal": set(leaves_a) == set(leaves_b) and not diff,
            "best loss and in-sample ADRF within rtol 1e-6": all(
                np.allclose(leaves_a[k], leaves_b[k], rtol=1e-6, atol=0) for k in near),
            "data_z bit-equal": torch.equal(a["model"].data_z, b["model"].data_z),
            f"MH states ({MESH_STEPS}, {N}, {sum(Z_DIMS)}) bit-equal": torch.equal(
                a["states"], b["states"]),
            "ADRF draws within rtol 1e-6": err_adrf <= 1e-6,
            f"K2 launches == {-(-N // FIT_BATCH)}, fit": a["fit"]["bnn_hosteps_grad"] == -(
                -N // FIT_BATCH) and a["fit"] == b["fit"],
            f"K1 paired launches == {2 * MESH_STEPS}, predict": (
                a["predict"]["bnn_hosteps_paired"] == 2 * MESH_STEPS
                and a["predict"]["bnn_hosteps"] == 1 and a["predict"] == b["predict"]),
        }
        print(f"[33a mesh NCCL world 1] BNN flagship n={N}: ms per training step {a['fit_ms']:.3f} "
              f"(mesh) vs {b['fit_ms']:.3f} (none), per MH burn-in step {a['mh_ms']:.3f} vs "
              f"{b['mh_ms']:.3f}; launches fit {a['fit']}, predict {a['predict']}; ADRF max rel "
              f"diff {err_adrf:.3e}; differing leaves {diff}", flush=True)
        for name, ok in checks.items():
            print(f"[33a mesh] {name}: {'ok' if ok else 'FAIL'}", flush=True)
        if not all(checks.values()):
            raise AssertionError("[33a mesh] checks failed")
        out["33a"] = dict(fit_ms_mesh=a["fit_ms"], fit_ms_none=b["fit_ms"], mh_ms_mesh=a["mh_ms"],
                          mh_ms_none=b["mh_ms"], k2_launches=a["fit"]["bnn_hosteps_grad"],
                          k1_paired_launches=a["predict"]["bnn_hosteps_paired"],
                          adrf_max_rel=err_adrf, plain_fit_ms=plain1["fit_ms"],
                          plain_mh_ms=plain1["mh_ms"])
        del runs, a, b

        # 33b: gloo, two ranks sharing the card
        data_path = os.path.join(root, "data.npz")
        np.savez(data_path, x=data_np[0], y=data_np[1], v=data_np[2])
        t = time.perf_counter()
        ctx = mp.start_processes(_mesh_rank, args=(MESH_WORLD, f"file://{root}/rdzv_gloo", root,
                                                   data_path),
                                 nprocs=MESH_WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"[33b mesh] the {MESH_WORLD} ranks outlived {MESH_TIMEOUT} s")
        spawn_s = time.perf_counter() - t
        ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz"))) for r in range(MESH_WORLD)]
    r0 = ranks[0]
    same = all(np.array_equal(r[k], r0[k]) for r in ranks[1:]
               for k in ("adrf", "ci", "draws", "states", "data_z"))
    ref_z = plain1["model"].data_z.cpu().numpy()
    ref_nets = {f"net.{k}.{i}": p.detach().cpu().numpy()
                for k in "ghf" for i, p in enumerate(plain1["model"].nets[k].parameters())}
    steps = -(-N // FIT_BATCH)
    rows_per_batch = PLAIN_BS // MESH_WORLD
    checks = {
        "every rank returns the same ADRF, draws, MH states and latent table": same,
        "latent table vs world 1 within rtol 2e-3 / atol 2e-5": np.allclose(
            r0["data_z"], ref_z, rtol=2e-3, atol=2e-5),
        "nets vs world 1 within rtol 2e-3 / atol 2e-6": all(
            np.allclose(r0[k], w, rtol=2e-3, atol=2e-6) for k, w in ref_nets.items()),
        "ADRF and intervals vs world 1 within rtol 1e-3 / atol 1e-4": (
            np.allclose(r0["adrf"], plain1["adrf"], rtol=1e-3, atol=1e-4)
            and np.allclose(r0["ci"], plain1["ci"], rtol=1e-3, atol=1e-4)),
        f"K3 launches == {steps} per rank (replicated), K4 per rank == 2 x (1 + "
        f"{2 * MESH_STEPS})": all(
            list(r["fit"]) == [steps, 0] and list(r["predict"]) == [0, 2 * (1 + 2 * MESH_STEPS)]
            for r in ranks),
    }
    print(f"[33b mesh gloo world {MESH_WORLD} on one card] spawn {spawn_s:.1f} s; per rank: dry "
          f"run {[round(float(r['dry_s']), 1) for r in ranks]} s, ms per training step "
          f"{[round(float(r['fit_ms']), 3) for r in ranks]} (world 1: {plain1['fit_ms']:.3f}), per "
          f"MH burn-in step on {rows_per_batch} rows {[round(float(r['mh_ms']), 3) for r in ranks]}"
          f" (world 1: {plain1['mh_ms']:.3f}); launches fit [K3, K4] "
          f"{[list(map(int, r['fit'])) for r in ranks]}, predict "
          f"{[list(map(int, r['predict'])) for r in ranks]}; K4 max_abs_err "
          f"{[float(r['err4']) for r in ranks]}, K1 paired max_abs_err "
          f"{[float(r['err1']) for r in ranks]}; ADRF max abs diff vs world 1 "
          f"{float(np.max(np.abs(r0['adrf'] - plain1['adrf']))):.3e}", flush=True)
    for name, ok in checks.items():
        print(f"[33b mesh] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[33b mesh] checks failed")
    out["33b"] = dict(spawn_s=spawn_s, fit_ms=[float(r["fit_ms"]) for r in ranks],
                      mh_ms=[float(r["mh_ms"]) for r in ranks],
                      k4_max_abs_err=[float(r["err4"]) for r in ranks],
                      k1_paired_max_abs_err=[float(r["err1"]) for r in ranks])
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[33 mesh] {json.dumps(out)} ({card})", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np

    from bayesgm_torch import CausalBGM, Sim_Hirano_Imbens_sampler, Sim_Sun_sampler
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
    from bayesgm_torch.ops.optim import table_adam_init
    from bayesgm_torch.utils import config_io
    from bayesgm_torch.utils.checkpoint import save_checkpoint
    from bayesgm_torch.utils.device import card_info
    from bayesgm_torch.utils.profiling import MetricsLogger

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {card}", flush=True)

    # 2. build, one nvcc per source, all started together; K1-K4's sources
    # are awaited here, K5-K8's (the longest build) before phase 16, so
    # phases 3-15 run while it builds
    def print_build(lib):
        ptxas = [l.strip() for l in lib.build_log.splitlines() if "registers" in l or "spill" in l]
        print(f"[2 build] {lib.path.name} in {lib.build_s:.1f} s; " + " | ".join(ptxas), flush=True)

    build_pool = ThreadPoolExecutor()
    builds = [build_pool.submit(load_library, src)
              for src in ("bnn_hosteps.cu", "plain.cu", "bnn_inkernel.cu")]
    build_pool.shutdown(wait=False)
    for fut in builds[:2]:
        print_build(fut.result())

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
        """Fit ``fit_model`` (EGM_N_ITER, FIT_EPOCHS + 1 passes), time its spans, check it
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
        fit_model.egm_init = timed_call(spans, "egm", fit_model.egm_init)
        fit_model.evaluate = timed_call(spans, "evaluate", fit_model.evaluate)
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
    print_build(builds[2].result())
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

    # 22. resume: the flagship BNN widths at N_RESUME rows, run uninterrupted,
    # then killed in the evaluate of epoch 2 and resumed by a new instance;
    # the last checkpoint files (nets, Adam states, latent table and moments,
    # both generators, best and SWA snapshots) and the metrics logs must be
    # equal bit for bit
    r_data = Sim_Hirano_Imbens_sampler(batch_size=32, N=N_RESUME, v_dim=V_DIM, seed=1).load_all()
    r_steps = -(-N_RESUME // FIT_BATCH)  # batches per pass, the remainder batch included
    resume_root = tempfile.mkdtemp(prefix="chip_smoke_resume_")

    def resume_model(run):
        p = flagship_params(os.path.join(resume_root, run))
        p.update(save_model=True, metrics_path=os.path.join(resume_root, run, "metrics.jsonl"))
        return CausalBGM(p, timestamp="resume", random_seed=5, device="cuda")

    def resume_fit(m, die_at=None):
        """Fit ``m`` (EGM 50, epochs 0..RESUME_EPOCHS); with ``die_at`` its
        evaluate raises on that call.  Returns (K2 launches, wall s)."""
        if die_at is not None:
            calls, evaluate = [0], m.evaluate

            def dying_evaluate(*a, **kw):
                calls[0] += 1
                if calls[0] == die_at:
                    raise RuntimeError("simulated kill")
                return evaluate(*a, **kw)

            m.evaluate = dying_evaluate
        m.kernels["bnn_hosteps_grad"].launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            m.fit(r_data, epochs=RESUME_EPOCHS, epochs_per_eval=1, batch_size=FIT_BATCH,
                  use_egm_init=True, egm_n_iter=RESUME_EGM, egm_batches_per_eval=RESUME_EGM,
                  verbose=0)
        except RuntimeError as e:
            if die_at is None or "simulated kill" not in str(e):
                raise
        torch.cuda.synchronize()
        return m.kernels["bnn_hosteps_grad"].launches, time.perf_counter() - t

    ma = resume_model("a")
    k2_a, wall_a = resume_fit(ma)
    mb1 = resume_model("b")
    k2_b1, wall_b1 = resume_fit(mb1, die_at=3)
    saved_b1 = sorted(os.listdir(mb1.checkpoint_path))
    mb2 = resume_model("b")
    k2_b2, wall_b2 = resume_fit(mb2)
    last = f"ckpt-{RESUME_EPOCHS}.npz"
    with np.load(os.path.join(ma.checkpoint_path, last)) as fa, \
            np.load(os.path.join(mb2.checkpoint_path, last)) as fb:
        keys = sorted(fa.files)
        differ = [k for k in keys if not np.array_equal(fa[k], fb[k])]
        same_keys = keys == sorted(fb.files)
    metrics = [[(r["event"], r["epoch"], r["mse_x"], r["mse_y"], r["mse_v"])
                for r in MetricsLogger(m.params["metrics_path"]).read()] for m in (ma, mb2)]
    print(f"[22 resume] n={N_RESUME}: uninterrupted {wall_a:.3f} s, killed {wall_b1:.3f} s "
          f"(checkpoints {saved_b1}), resumed {wall_b2:.3f} s; K2 launches {k2_a}, {k2_b1}, "
          f"{k2_b2}; {len(keys)} leaves in {last}, differing: {differ[:8]}", flush=True)
    checks = {
        "killed run wrote epochs 0 and 1": saved_b1 == ["ckpt-0.npz", "ckpt-1.npz"],
        "same keys in the last checkpoints": same_keys,
        "last checkpoints equal bit for bit": same_keys and not differ,
        "nets and data_z equal": all(torch.equal(p, q) for k in ma.nets for p, q in
                                     zip(ma.nets[k].parameters(), mb2.nets[k].parameters()))
                                 and torch.equal(ma.data_z, mb2.data_z),
        "both generators' states equal": (torch.equal(ma._gen.get_state(), mb2._gen.get_state())
                                          and torch.equal(ma._host_gen.get_state(),
                                                          mb2._host_gen.get_state())),
        "best_epoch equal": ma.best_epoch == mb2.best_epoch,
        "metrics logs equal": metrics[0] == metrics[1] and len(metrics[0]) == RESUME_EPOCHS + 1,
        f"K2 launches {4 * r_steps} / {3 * r_steps} / {2 * r_steps}":
            (k2_a, k2_b1, k2_b2) == (4 * r_steps, 3 * r_steps, 2 * r_steps),
    }
    for name, ok in checks.items():
        print(f"[22 resume] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[22 resume] the resumed run differs from the uninterrupted one")
    # the write of phase 8's model's bundle at N rows
    torch.cuda.synchronize()
    t = time.perf_counter()
    bundle = fit_model._full_state_bundle(fit_model.data_z, table_adam_init(fit_model.data_z),
                                          FIT_EPOCHS, 0.0, fit_model.best_causal_pre)
    t_bundle = time.perf_counter() - t
    path = save_checkpoint(os.path.join(resume_root, "n20000"), FIT_EPOCHS, bundle)
    t_write = time.perf_counter() - t - t_bundle
    ckpt_mb = os.path.getsize(path) / 2**20
    print(f"[22 checkpoint] n={N}: {ckpt_mb:.3f} MiB; {1e3 * (t_bundle + t_write):.3f} ms "
          f"({1e3 * t_bundle:.3f} ms to gather the state on the host, {1e3 * t_write:.3f} ms "
          f"to write)", flush=True)
    shutil.rmtree(resume_root)

    # 23. the sampler API on phase 8's fitted BNN model: MH draws of Z (K1
    # unpaired, both sides of each step), then the 20-point effect draws
    for k in fit_model.kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    z_draws = fit_model.metropolis_hastings_sampler(data_np, burn_in=BURN_IN, n_keep=API_KEEP)
    t_mh = time.perf_counter() - t
    api_launches = {name: k.launches for name, k in fit_model.kernels.items()}
    t = time.perf_counter()
    eff = fit_model.infer_from_latent_posterior(z_draws, x_values=np.linspace(0, 3, 20))
    t_inf = time.perf_counter() - t
    api_launches_infer = sum(k.launches for k in fit_model.kernels.values()) - sum(
        api_launches.values())
    want_k1 = 1 + 2 * (BURN_IN + API_KEEP)
    print(f"[23 sampler] metropolis_hastings_sampler {t_mh:.3f} s ({BURN_IN} + {API_KEEP} "
          f"steps), draws {z_draws.shape}; infer_from_latent_posterior {t_inf:.3f} s, effect "
          f"draws {eff.shape}; launches {api_launches}", flush=True)
    checks = {
        f"draws shape ({API_KEEP}, {N}, {sum(Z_DIMS)}) and finite":
            z_draws.shape == (API_KEEP, N, sum(Z_DIMS)) and bool(np.all(np.isfinite(z_draws))),
        f"effect draws shape (20, {API_KEEP}) and finite":
            eff.shape == (20, API_KEEP) and bool(np.all(np.isfinite(eff))),
        f"K1 unpaired launches == {want_k1}, no other kernel":
            api_launches["bnn_hosteps"] == want_k1 and sum(api_launches.values()) == want_k1,
        "no kernel launch in infer_from_latent_posterior": api_launches_infer == 0,
    }
    for name, ok in checks.items():
        print(f"[23 sampler] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[23 sampler] checks failed")

    # 24. DR on phase 13's plain model (two batches of PLAIN_BS), beside the
    # plugin collector on the same chains; then the ESS gate on phase 8's
    # BNN model
    grid = np.linspace(0, 3, 20)
    dr_walls = {}
    for est in ("dr", "plugin"):
        for k in plain_model.kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        adrf_e, ci_e = plain_model.predict(data_np, x_values=grid, alpha=0.01, burn_in=BURN_IN,
                                           n_mcmc=N_MCMC, q_sd=1.0, estimator=est)
        torch.cuda.synchronize()
        dr_walls[est] = time.perf_counter() - t
        if est == "dr":
            adrf_dr, ci_dr = adrf_e, ci_e
            dr_launches = {name: k.launches for name, k in plain_model.kernels.items()}
    extra_ms = 1e3 * (dr_walls["dr"] - dr_walls["plugin"]) / (n_batches * N_MCMC)
    print(f"[24 DR] n={N}, {n_batches} batches: wall {dr_walls['dr']:.3f} s (plugin "
          f"{dr_walls['plugin']:.3f} s) for {BURN_IN} + {N_MCMC} steps per batch, "
          f"{1e3 * dr_walls['dr'] / (n_batches * (BURN_IN + N_MCMC)):.3f} ms/step (plugin "
          f"{1e3 * dr_walls['plugin'] / (n_batches * (BURN_IN + N_MCMC)):.3f}); DR adds "
          f"{extra_ms:.3f} ms per kept step of a batch; launches {dr_launches}", flush=True)
    print(f"[24 DR] ADRF {np.array2string(adrf_dr, precision=4)}", flush=True)
    checks = {
        "DR adrf finite, intervals ordered": (bool(np.all(np.isfinite(adrf_dr)))
                                              and bool(np.all(ci_dr[:, 0] <= ci_dr[:, 1]))),
        f"K4 launches == {n_batches * (1 + BURN_IN + N_MCMC)}":
            dr_launches["plain"] == n_batches * (1 + BURN_IN + N_MCMC)
            and dr_launches["plain_grad"] == 0,
    }
    for k in fit_model.kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, ci_s, diag_s, draws_s = fit_model.predict(
        data_np, x_values=grid, alpha=0.01, burn_in=BURN_IN, n_mcmc=ESS_N_MCMC, q_sd=1.0,
        ess_target=ESS_TARGET, return_diagnostics=True, return_draws=True)
    torch.cuda.synchronize()
    ess_wall = time.perf_counter() - t
    kept = draws_s.shape[1]
    ess_launches = {name: k.launches for name, k in fit_model.kernels.items()}
    min_ess, max_rhat = float(np.min(diag_s["ess"])), float(np.max(diag_s["rhat"]))
    print(f"[24 ESS] ess_target={ESS_TARGET}, n_mcmc={ESS_N_MCMC}: kept {kept} steps in "
          f"{ess_wall:.3f} s; gate series min ESS {min_ess:.1f}, max split-Rhat {max_rhat:.4f}; "
          f"launches {ess_launches}", flush=True)
    checks.update({
        f"kept a multiple of 500 in [1000, {ESS_N_MCMC}]":
            kept % 500 == 0 and 1000 <= kept <= ESS_N_MCMC,
        "the gate held where the chain stopped": kept == ESS_N_MCMC or (
            min_ess >= ESS_TARGET and max_rhat <= 1.01),
        f"K1 paired launches == {BURN_IN + kept}":
            ess_launches["bnn_hosteps_paired"] == BURN_IN + kept
            and ess_launches["bnn_hosteps"] == 1,
    })
    for name, ok in checks.items():
        print(f"[24 DR/ESS] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[24 DR/ESS] checks failed")

    # 25. the driver on configs/Sim_Sun.yaml (read by config_io) without its
    # model: line, so the causalbgm engine runs (phase 26 runs the file as
    # shipped), depth cut by -e DRIVER_EPOCHS -b EGM_N_ITER and a predict: block; then the CLI
    # in a new process on a 2000-row .npz triplet
    from bayesgm_torch import main as driver

    drive_root = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    sun_text = (open("configs/Sim_Sun.yaml").read()
                .replace("output_dir: '.'", f"output_dir: '{drive_root}'")
                .replace("  burn_in: 1000\n", f"  burn_in: {BURN_IN}\n  n_mcmc: {DRIVER_N_MCMC}\n"))
    cfg_path = os.path.join(drive_root, "Sim_Sun.yaml")
    with open(cfg_path, "w") as f:
        f.write(sun_text.replace("model: identifiable\n", ""))
    print(f"[25 driver] config {config_io.load(cfg_path)}", flush=True)
    built = []
    init = CausalBGM.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)

    CausalBGM.__init__ = recording_init
    out = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            adrf_d, ci_d = driver.main(["-c", cfg_path, "-e", str(DRIVER_EPOCHS), "-b",
                                        str(EGM_N_ITER), "--device", "cuda"])
    finally:
        CausalBGM.__init__ = init
    torch.cuda.synchronize()
    drive_wall = time.perf_counter() - t
    printed = out.getvalue().splitlines()
    rmse_lines = [line for line in printed if line.startswith("ADRF RMSE:")]
    dm = built[0]
    drive_launches = {name: k.launches for name, k in dm.kernels.items()}
    ckpts = sorted(os.listdir(dm.checkpoint_path))
    print(f"[25 driver] wall {drive_wall:.3f} s; {rmse_lines}; {[l for l in printed if 'Acceptance' in l]}; "
          f"checkpoints {ckpts}; launches {drive_launches}", flush=True)
    checks = {
        "one model built": len(built) == 1,
        "ADRF finite, intervals ordered": (adrf_d.shape == (20,)
                                           and bool(np.all(np.isfinite(adrf_d)))
                                           and bool(np.all(ci_d[:, 0] <= ci_d[:, 1]))),
        "RMSE line printed": len(rmse_lines) == 1,
        "checkpoint of epoch 0 written": ckpts == ["ckpt-0.npz"],
        f"K2 launches == {(DRIVER_EPOCHS + 1) * (N // FIT_BATCH)}": (
            drive_launches["bnn_hosteps_grad"] == (DRIVER_EPOCHS + 1) * (N // FIT_BATCH)),
        "K1 paired launched": drive_launches["bnn_hosteps_paired"] >= BURN_IN + 1000,
    }
    triplet = os.path.join(drive_root, "triplet.npz")
    tx, ty, tv = Sim_Hirano_Imbens_sampler(N=CLI_N, v_dim=V_DIM, seed=2).load_all()
    np.savez(triplet, x=tx, y=ty, v=tv)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bayesgm_torch", "causalbgm", "-o", drive_root, "-i", triplet,
         "-d", "cli", "--device", "cuda", "--no-binary_treatment", "--x_values", "0.5", "1.0",
         "1.5", "-Z", "1", "1", "1", "7", "-N", "20", "--batches_per_eval", "20", "-E", "1",
         "--epochs_per_eval", "1", "-M", "20", "--burn_in", "20"],
        capture_output=True, text=True, timeout=600)
    cli_wall = time.perf_counter() - t
    res_dirs = glob.glob(os.path.join(drive_root, "results", "cli", "*"))
    est = ivl = None
    if proc.returncode == 0 and len(res_dirs) == 1:
        est = np.loadtxt(os.path.join(res_dirs[0], "causal_effect_point_estimate.txt"))
        ivl = np.loadtxt(os.path.join(res_dirs[0], "causal_effect_posterior_interval.txt"))
    print(f"[25 CLI] python -m bayesgm_torch causalbgm on {CLI_N} rows: rc {proc.returncode} in "
          f"{cli_wall:.3f} s; estimate {est}; stderr tail {proc.stderr[-300:]!r}", flush=True)
    checks["CLI wrote both files: (3,) and (3, 2), finite and ordered"] = (
        est is not None and est.shape == (3,) and ivl.shape == (3, 2)
        and bool(np.all(np.isfinite(est))) and bool(np.all(ivl[:, 0] <= ivl[:, 1])))
    for name, ok in checks.items():
        print(f"[25 driver/CLI] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    shutil.rmtree(drive_root)
    if not all(checks.values()):
        raise AssertionError("[25 driver/CLI] checks failed")

    # 26. the identifiable engine: configs/Sim_Sun.yaml as shipped (model:
    # identifiable) through bayesgm_torch.main.main at n=20000, cut as phase
    # 25; its latent loss and MH target are composites, so no kernel runs
    from bayesgm_torch import EnsembleCausalBGM, FullMCMCCausalBGM, IdentifiableCausalBGM

    ident_root = tempfile.mkdtemp(prefix="chip_smoke_ident_")
    cfg_path = os.path.join(ident_root, "Sim_Sun.yaml")
    with open(cfg_path, "w") as f:
        f.write(sun_text.replace(drive_root, ident_root))
    print(f"[26 identifiable] config {config_io.load(cfg_path)}", flush=True)
    built, spans, chains = [], {}, []
    ident_init, mh = IdentifiableCausalBGM.__init__, mcmc.adaptive_mh

    def recording_ident_init(self, *a, **kw):
        ident_init(self, *a, **kw)
        for name in ("fit", "evaluate", "predict"):
            setattr(self, name, timed_call(spans, name, getattr(self, name)))
        egm = timed_call(spans, "egm_init", self.egm_init)

        def egm_init(*a, **kw):  # its evaluations (save_res) count as EGM time
            before = spans.get("evaluate", 0.0)
            try:
                return egm(*a, **kw)
            finally:
                spans["evaluate"] = before
        self.egm_init = egm_init
        built.append(self)

    def recording_mh(*a, **kw):
        res = timed_call(spans, "chain", mh)(*a, **kw)
        chains.append((kw["burn_in"], res.samples.shape[0]))
        return res

    IdentifiableCausalBGM.__init__, mcmc.adaptive_mh = recording_ident_init, recording_mh
    for entry in ik.LAUNCHES:
        ik.LAUNCHES[entry] = 0
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            adrf_i, ci_i = driver.main(["-c", cfg_path, "-e", str(DRIVER_EPOCHS), "-b",
                                        str(EGM_N_ITER), "--device", "cuda"])
    finally:
        IdentifiableCausalBGM.__init__, mcmc.adaptive_mh = ident_init, mh
    printed = out.getvalue().splitlines()
    im = built[0]
    ident_launches = {name: k.launches for name, k in im.kernels.items()}
    ident_launches.update({f"bnn_inkernel_{e}": n for e, n in ik.LAUNCHES.items()})
    n_ident_steps = (DRIVER_EPOCHS + 1) * (N // FIT_BATCH)
    train_s = spans["fit"] - spans["egm_init"] - spans["evaluate"]
    (burn_i, kept_i), = chains
    with np.load(os.path.join(im.checkpoint_path, "ckpt-0.npz")) as f:
        ckpt_keys = set(f.files)
        ckpt_u = f["['data_u']"] if "['data_u']" in ckpt_keys else None
    rmse_lines = [line for line in printed if line.startswith("ADRF RMSE:")]
    print(f"[26 identifiable] n={N}: fit {spans['fit']:.3f} s (EGM {spans['egm_init']:.3f} s, "
          f"evaluations {spans['evaluate']:.3f} s, training {train_s:.3f} s = "
          f"{1e3 * train_s / n_ident_steps:.3f} ms per iVAE step over {n_ident_steps}); predict "
          f"{spans['predict']:.3f} s, chain {spans['chain']:.3f} s for {burn_i} + {kept_i} MH "
          f"steps ({1e3 * spans['chain'] / (burn_i + kept_i):.3f} ms/step incl. the collector); "
          f"{rmse_lines}; {[l for l in printed if 'Acceptance' in l]}; launches {ident_launches}",
          flush=True)
    checks = {
        "one model built": len(built) == 1,
        "ADRF finite, intervals ordered": (adrf_i.shape == (20,)
                                           and bool(np.all(np.isfinite(adrf_i)))
                                           and bool(np.all(ci_i[:, 0] <= ci_i[:, 1]))),
        "RMSE line printed": len(rmse_lines) == 1,
        "checkpoint of epoch 0 holds prior_net and data_u": (
            ckpt_u is not None and any(k.startswith("['prior_net']") for k in ckpt_keys)
            and np.array_equal(ckpt_u, im.data_u.cpu().numpy())),
        f"U one-hot ({N}, 10)": (tuple(im.data_u.shape) == (N, 10)
                                 and bool(torch.all(im.data_u.sum(dim=1) == 1))),
        "no kernel launched": sum(ident_launches.values()) == 0,
        f"kept a multiple of 500 in [1000, {DRIVER_N_MCMC}]":
            kept_i % 500 == 0 and 1000 <= kept_i <= DRIVER_N_MCMC,
    }
    for name, ok in checks.items():
        print(f"[26 identifiable] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    shutil.rmtree(ident_root)
    if not all(checks.values()):
        raise AssertionError("[26 identifiable] checks failed")

    # 26 resume: the identifiable recipe's widths at N_RESUME Sim_Sun rows
    # (EGM 50, epochs 0..3, lr_decay cosine), killed in the evaluate of epoch
    # 2 and resumed by a new instance, against an uninterrupted run
    sun_params = config_io.loads(sun_text)
    sun_params.pop("predict")
    i_data = Sim_Sun_sampler(batch_size=32, N=N_RESUME, v_dim=V_DIM, seed=1).load_all()
    i_steps = N_RESUME // FIT_BATCH  # full batches only: the identifiable fit skips the rest
    i_root = tempfile.mkdtemp(prefix="chip_smoke_ident_resume_")

    def ident_resume(run, die_at=None):
        p = dict(sun_params, output_dir=os.path.join(i_root, run), save_res=False,
                 lr_decay="cosine")
        m = IdentifiableCausalBGM(p, timestamp="resume", random_seed=5, device="cuda")
        if die_at is not None:
            calls, evaluate = [0], m.evaluate

            def dying_evaluate(*a, **kw):
                calls[0] += 1
                if calls[0] == die_at:
                    raise RuntimeError("simulated kill")
                return evaluate(*a, **kw)

            m.evaluate = dying_evaluate
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            m.fit(i_data, epochs=RESUME_EPOCHS, epochs_per_eval=1, batch_size=FIT_BATCH,
                  use_egm_init=True, egm_n_iter=RESUME_EGM, egm_batches_per_eval=RESUME_EGM,
                  verbose=0)
        except RuntimeError as e:
            if die_at is None or "simulated kill" not in str(e):
                raise
        torch.cuda.synchronize()
        return m, time.perf_counter() - t

    ia, wall_ia = ident_resume("a")
    ib1, wall_ib1 = ident_resume("b", die_at=3)
    saved_ib1 = sorted(os.listdir(ib1.checkpoint_path))
    ib2, wall_ib2 = ident_resume("b")
    last = f"ckpt-{RESUME_EPOCHS}.npz"
    with np.load(os.path.join(ia.checkpoint_path, last)) as fa, \
            np.load(os.path.join(ib2.checkpoint_path, last)) as fb:
        keys = sorted(fa.files)
        differ = [k for k in keys if not np.array_equal(fa[k], fb[k])]
        same_keys = keys == sorted(fb.files)
    print(f"[26 resume] n={N_RESUME}: uninterrupted {wall_ia:.3f} s, killed {wall_ib1:.3f} s "
          f"(checkpoints {saved_ib1}), resumed {wall_ib2:.3f} s "
          f"({1e3 * wall_ib2 / (2 * i_steps):.3f} ms per iVAE step incl. 2 evaluations); "
          f"{len(keys)} leaves in {last}, differing: {differ[:8]}", flush=True)
    checks = {
        "killed run wrote epochs 0 and 1": saved_ib1 == ["ckpt-0.npz", "ckpt-1.npz"],
        "last checkpoints equal bit for bit": same_keys and not differ,
        "prior_net, prior_opt and data_u in the file": {"['data_u']", "['prior_opt'].t"} <= set(keys),
        "nets, prior net, U and data_z equal": (
            all(torch.equal(p, q) for k in ia.nets
                for p, q in zip(ia.nets[k].parameters(), ib2.nets[k].parameters()))
            and all(torch.equal(p, q) for p, q in zip(ia.prior_net.parameters(),
                                                      ib2.prior_net.parameters()))
            and torch.equal(ia.data_u, ib2.data_u) and torch.equal(ia.data_z, ib2.data_z)),
        "both generators' states equal": (torch.equal(ia._gen.get_state(), ib2._gen.get_state())
                                          and torch.equal(ia._host_gen.get_state(),
                                                          ib2._host_gen.get_state())),
    }
    for name, ok in checks.items():
        print(f"[26 resume] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    shutil.rmtree(i_root)
    if not all(checks.values()):
        raise AssertionError("[26 resume] the resumed identifiable run differs")

    # 27. FullMCMC at the Sim_Hirano_Imbens widths (plain nets): the
    # inherited fit through K3, weight-space HMC over g, h and f (PyTorch
    # composites), then predict with one weight draw per MH step
    spans, hmc_runs = {}, []
    hmc = mcmc.hmc

    def recording_hmc(*a, **kw):
        t_span = {}
        res = timed_call(t_span, "hmc", hmc)(*a, **kw)
        hmc_runs.append((t_span["hmc"], kw["burn_in"] + kw["n_keep"], float(res.accept_rate),
                         float(res.step_size)))
        return res

    with tempfile.TemporaryDirectory() as out_dir:
        fm = FullMCMCCausalBGM(flagship_params(out_dir), random_seed=123, device="cuda")
    for k in fm.kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    fm.fit(data_np, epochs=FIT_EPOCHS, epochs_per_eval=1, batch_size=FIT_BATCH,
           use_egm_init=True, egm_n_iter=EGM_N_ITER, egm_batches_per_eval=100, verbose=0)
    torch.cuda.synchronize()
    fm_fit_wall = time.perf_counter() - t
    fm_fit_launches = {name: k.launches for name, k in fm.kernels.items()}
    for k in fm.kernels.values():
        k.launches = 0
    mcmc.hmc = recording_hmc
    try:
        fm.run_mcmc_training(data_np, num_samples=HMC_STEPS, num_burnin=HMC_STEPS,
                             num_leapfrog=3)
    finally:
        mcmc.hmc = hmc
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    adrf_f, ci_f, diag_f = fm.predict(data_np, x_values=np.linspace(0, 3, 20), alpha=0.01,
                                      burn_in=BURN_IN, n_mcmc=N_MCMC, q_sd=1.0,
                                      return_diagnostics=True)
    torch.cuda.synchronize()
    fm_pred_wall = time.perf_counter() - t
    fm_pred_peak = torch.cuda.max_memory_allocated() / 2**30
    fm_launches = {name: k.launches for name, k in fm.kernels.items()}
    z_chunk = fm.metropolis_hastings_sampler(data_np, burn_in=BURN_IN, n_keep=INFER_CHUNK_DRAWS)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated() / 2**30
    torch.cuda.synchronize()
    t = time.perf_counter()
    eff_f = fm.infer_from_latent_posterior(z_chunk, x_values=np.linspace(0, 3, 20))
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t)
    chunk_peak = torch.cuda.max_memory_allocated() / 2**30
    for (wall, steps, acc, step), name in zip(hmc_runs, "ghf"):
        d = getattr(fm, f"{name}_net_samples").shape[1]
        print(f"[27 fullmcmc HMC] {name}_net ({d} weights, {N} rows): {wall:.3f} s for {steps} "
              f"steps, {1e3 * wall / steps:.3f} ms per HMC step (3 leapfrog steps); acceptance "
              f"{acc:.4f}; final step size {step:.3e}", flush=True)
    print(f"[27 fullmcmc] fit {fm_fit_wall:.3f} s, launches {fm_fit_launches}; predict "
          f"{fm_pred_wall:.3f} s for {BURN_IN} + {N_MCMC} MH steps and {N_MCMC} paired effect "
          f"draws, peak {fm_pred_peak:.3f} GiB, launches {fm_launches}; one "
          f"{INFER_CHUNK_DRAWS}-draw chunk of infer_from_latent_posterior on the 20-point grid: "
          f"{chunk_ms:.3f} ms, peak {chunk_peak:.3f} GiB ({base_mem:.3f} GiB before)", flush=True)
    print(f"[27 fullmcmc] ADRF {np.array2string(adrf_f, precision=4)}", flush=True)
    n_fit_steps = (FIT_EPOCHS + 1) * -(-N // FIT_BATCH)  # the remainder batch included
    checks = {
        f"K3 launches == {n_fit_steps} in fit, none else": (
            fm_fit_launches["plain_grad"] == n_fit_steps and fm_fit_launches["plain"] == 0),
        "no kernel launched by HMC and predict": sum(fm_launches.values()) == 0,
        f"weight samples ({HMC_STEPS}, D) finite for g, h and f": all(
            getattr(fm, f"{k}_net_samples").shape[0] == HMC_STEPS
            and bool(np.all(np.isfinite(getattr(fm, f"{k}_net_samples")))) for k in "ghf"),
        "ADRF finite, intervals ordered": (adrf_f.shape == (20,)
                                           and bool(np.all(np.isfinite(adrf_f)))
                                           and bool(np.all(ci_f[:, 0] <= ci_f[:, 1]))),
        f"effect draws ({INFER_CHUNK_DRAWS}, 20) finite": (eff_f.shape == (INFER_CHUNK_DRAWS, 20)
                                                            and bool(np.all(np.isfinite(eff_f)))),
    }
    for name, ok in checks.items():
        print(f"[27 fullmcmc] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[27 fullmcmc] checks failed")
    del fm, z_chunk

    # 28. EnsembleCausalBGM: two BNN members at the flagship widths, each
    # fitted (EGM ENS_EGM, ENS_EPOCHS + 1 passes) and predicted as a lone
    # CausalBGM is (K2 once per step; K1 once, then paired once per step)
    with tempfile.TemporaryDirectory() as out_dir:
        ens = EnsembleCausalBGM(dict(flagship_params(out_dir), n_members=2), random_seed=123,
                                device="cuda")
    member_fit, member_pred = [], []
    for m in ens.members:
        fit_m = m.fit
        pred_m = m.predict

        def counted(fn, store, model=m):
            def run(*a, **kw):
                for k in model.kernels.values():
                    k.launches = 0
                out = fn(*a, **kw)
                store.append({name: k.launches for name, k in model.kernels.items()})
                return out
            return run

        m.fit, m.predict = counted(fit_m, member_fit), counted(pred_m, member_pred)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ens.fit(data_np, epochs=ENS_EPOCHS, epochs_per_eval=1, batch_size=FIT_BATCH,
            use_egm_init=True, egm_n_iter=ENS_EGM, egm_batches_per_eval=100, verbose=0)
    torch.cuda.synchronize()
    ens_fit_wall = time.perf_counter() - t
    t = time.perf_counter()
    adrf_e, ci_e, diag_e, pooled = ens.predict(data_np, x_values=np.linspace(0, 3, 20),
                                               alpha=0.01, burn_in=BURN_IN, n_mcmc=N_MCMC,
                                               q_sd=1.0, return_diagnostics=True,
                                               return_draws=True)
    torch.cuda.synchronize()
    ens_pred_wall = time.perf_counter() - t
    lone_k2 = fit_launches["bnn_hosteps_grad"] // (FIT_EPOCHS + 1) * (ENS_EPOCHS + 1)
    lone_pred = {"bnn_hosteps": 1, "bnn_hosteps_paired": BURN_IN + N_MCMC}  # phase 9's counts
    print(f"[28 ensemble] 2 members, n={N}: fit {ens_fit_wall:.3f} s (EGM {ENS_EGM}, "
          f"{ENS_EPOCHS + 1} passes each), predict {ens_pred_wall:.3f} s ({BURN_IN} + {N_MCMC} "
          f"steps each); pooled draws {pooled.shape}; member launches: fit {member_fit}, "
          f"predict {member_pred}; min ESS {float(np.min(diag_e['ess'])):.1f}, max split-Rhat "
          f"{float(np.max(diag_e['rhat'])):.4f}", flush=True)
    checks = {
        f"each member's K2 launches == {lone_k2}, as a lone CausalBGM's (phase 8 per pass)": all(
            f["bnn_hosteps_grad"] == lone_k2 and sum(f.values()) == lone_k2 for f in member_fit),
        "each member's predict launches == phase 9's": all(
            p == {**{k: 0 for k in p}, **lone_pred} for p in member_pred),
        f"pooled draws (20, {2 * N_MCMC})": pooled.shape == (20, 2 * N_MCMC),
        "ADRF = pooled mean, finite, intervals ordered": (
            bool(np.allclose(adrf_e, pooled.mean(axis=1))) and bool(np.all(np.isfinite(adrf_e)))
            and bool(np.all(ci_e[:, 0] <= ci_e[:, 1]))),
        "members differ": not np.array_equal(pooled[:, :N_MCMC], pooled[:, N_MCMC:]),
    }
    for name, ok in checks.items():
        print(f"[28 ensemble] {name}: {'ok' if ok else 'FAIL'}", flush=True)
    if not all(checks.values()):
        raise AssertionError("[28 ensemble] checks failed")
    del ens

    # 29. BGM: both configs through the driver, a resumed fit and the CLI
    bgm_phase()

    # 30. MNISTBGM: Mnist.yaml through the driver, the flipout generator, a resumed fit
    mnist_phase()

    # 31. the semi-synthetic configs through the driver, K1 and K2 at their shapes
    semi = semi_phase()

    # 32. the roofline anchors, the facade, the low-rank algebra, the estimator
    roofline_phase(d_k2, fit_model.nets)

    # 33. every mesh path: NCCL at world 1 against mesh=None, two gloo ranks on the card
    mesh_phase(card)

    # 34. the gate runners at tiny sizes; K1 and K2 at binary_ate's widths
    gates = gates_phase()

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
        "semi": {name: {k: semi[name]["kernels"][k] for k in ("K1 paired", "K1 unpaired")}
                 for name in semi},
        "binary_ate": {k: gates["kernels"][k] for k in ("K1 paired", "K1 unpaired")},
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
        "semi": {name: semi[name]["kernels"]["K2"] for name in semi},
        "binary_ate": gates["kernels"]["K2"],
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
