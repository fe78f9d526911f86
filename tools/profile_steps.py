#!/usr/bin/env python3
"""Where the time of the port's steps goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/profile_steps.py [--nets plain bnn mnist] [--steps 50] [--warmup 10]

For each kind of nets, at the width of the repo's training benchmark
(Sim_Hirano_Imbens, n=20000, v_dim=200, z_dims [1,1,1,7], default units,
random weights from seed 123), it times four units of work:

- a training step (batch 32; the latent update through K2 or K3);
- an EGM iteration (5 critic + 1 generator steps, batch 32);
- an MH burn-in step over one predict batch (K1 paired for BNN nets over all
  n rows, K4 for plain nets over 10000 rows), no collector;
- an MH kept step: the same plus the 20-point ADRF collector.

For BNN nets it also times an MH burn-in step in windows of 50 steps, one K5
launch each (``params['mh_window_kernel']``; ``--steps`` must then be a
multiple of 50), single launches of K6 (n and 2n rows), K8's base variant
(2n rows, block 512) and K7 (n, 1000, 512 and 32 rows), and single launches of K1 (n rows,
and the paired 2n) and K2 (32 and n rows); for plain nets, single launches
of K3 (32 and n rows) and K4 (10000, n and 1000 rows).  The
script imports the package from the working directory, so run from the
root of another checkout it measures that checkout's kernels.

``--nets mnist`` profiles MNISTBGM at the widths of ``configs/Mnist.yaml``
(plain generator, and the flipout one), random weights from seed 123, on
the 8192 seeded ellipse images: a training step (batch 32), an EGM
iteration (batch 32), and an HMC step over 64 images with the upper half
hidden (L = 10), without and with the kept step's decode.

A training step or an EGM iteration runs ``--warmup`` times, then
``--steps`` times under the host clock (synchronized), then ``--steps`` times
under ``torch.profiler``; an MH unit is one chain of ``--steps`` steps, run
once to warm up, once timed and once profiled (its initial evaluation is
spread over the steps).  It prints per unit: wall ms per step, device-busy ms
per step (the sum of the kernels' device time), the busy share, the device
kernels per step, and the kernels that take the most device time.  Imports
nothing of JAX.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

N, V_DIM, Z_DIMS = 20000, 200, (1, 1, 1, 7)
X_VALUES = [3.0 * i / 19 for i in range(20)]


def _units(model, data, plain, steps):
    """``[(name, zero-argument function, steps per call)]``."""
    import torch

    from bayesgm_torch.benchmarks.mxu_probe import make_probe_kernel
    from bayesgm_torch.models import causalbgm as cb
    from bayesgm_torch.ops import mcmc, optim
    from bayesgm_torch.ops._pk_bnn_inkernel import (
        make_fused_causal_logp_and_grad_bnn,
        make_fused_causal_logp_bnn,
    )
    from bayesgm_torch.ops._pk_util import (
        flatten_flipout_params,
        flatten_mlp_params,
        flipout_step_perturbations,
        split_flipout_flat,
    )

    cfg, dev = model.cfg, model.device
    x, y, v = model._data(data)
    gen = torch.Generator(device=dev).manual_seed(1)
    model.data_z = torch.randn((N, sum(Z_DIMS)), generator=gen, device=dev)
    z_opt = optim.table_adam_init(model.data_z)
    latent_vg = model._build_fused_latent_vg()
    state = {"z_opt": z_opt}

    def train_step():
        idx = torch.randint(0, N, (32,), generator=gen, device=dev)
        model.opts, state["z_opt"], _ = cb._train_batch_step(
            cfg, model.nets, model.opts, model.data_z, state["z_opt"], idx, gen, (x, y, v),
            latent_vg=latent_vg)

    def egm_iter():
        model._opt_d, model._opt_ge, _ = cb._egm_iter(cfg, model.nets, model._opt_d,
                                                      model._opt_ge, (x, y, v), gen, 32)

    rows = 10000 if plain else N
    lp, plp, make_params, make_multi_step = model._make_param_log_prob()
    params = make_params(model.nets, tuple(a[:rows].cpu().numpy() for a in (x, y, v)),
                         not plain)
    collect_p = cb._effect_collector_p(cfg, X_VALUES, True)
    init = torch.randn((rows, sum(Z_DIMS)), generator=gen, device=dev)

    def mh(n_burn, n_keep, multi_step=None):
        def run():
            with torch.no_grad():
                mcmc.adaptive_mh(lp, init, gen, burn_in=n_burn, n_keep=n_keep, q_sd=1.0,
                                 adaptive=False, recompute_current=not plain,
                                 collect=collect_p, paired_log_prob_fn=plp,
                                 multi_step_fn=multi_step, params=params)
        return run

    units = [("training step", train_step, 1), ("EGM iteration", egm_iter, 1),
             (f"MH burn-in step ({rows} rows)", mh(steps, 0), steps)]
    if not plain:
        units.append((f"MH burn-in window ({cb.MH_WINDOW} steps, {rows} rows, K5)",
                      mh(steps, 0, make_multi_step(cb.MH_WINDOW)), steps))
    units.append((f"MH kept step ({rows} rows)", mh(0, steps), steps))
    if plain:
        # K3 and K4 alone at the main path's shapes: fit's batch of 32 and
        # MALA's N rows; predict's batch of 10000.
        flats = [flatten_mlp_params(model.nets[k]) for k in "ghf"]
        k3, k4 = model.kernels["plain_grad"], model.kernels["plain"]
        full = (model.data_z, x, y, v)
        rows32 = [a[:32].contiguous() for a in full]
        batch = [init] + [a[:rows].contiguous() for a in (x, y, v)]
        rows1k = [a[:1000].contiguous() for a in full]
        units += [("K3 launch (32 rows)", lambda: k3(*rows32, *flats), 1),
                  (f"K3 launch ({N} rows)", lambda: k3(*full, *flats), 1),
                  (f"K4 launch ({rows} rows)", lambda: k4(*batch, *flats), 1),
                  (f"K4 launch ({N} rows)", lambda: k4(*full, *flats), 1),
                  ("K4 launch (1000 rows)", lambda: k4(*rows1k, *flats), 1)]
    if not plain:
        dims = [model.nets[k].dims for k in "ghf"]
        flats = [flatten_flipout_params(model.nets[k]) for k in "ghf"]
        seed = torch.tensor([1, 2], dtype=torch.int32, device=dev)
        k6 = make_fused_causal_logp_bnn(cfg, *dims)
        k7 = make_fused_causal_logp_and_grad_bnn(cfg, *dims)
        base = make_probe_kernel("base", cfg, *dims)
        stack2 = [torch.cat([a, a]) for a in (init, x, y, v)]
        units += [(f"K6 launch ({N} rows)", lambda: k6(init, x, y, v, seed, *flats), 1),
                  (f"K6 launch ({2 * N} rows)", lambda: k6(*stack2, seed, *flats), 1),
                  (f"K8 base launch ({2 * N} rows)", lambda: base(*stack2, seed, *flats), 1),
                  (f"K7 launch ({N} rows)", lambda: k7(init, x, y, v, seed, *flats), 1)]
        for rows7 in (32, 512, 1000):  # K7 in its cluster form (32, 512) and tiles (1000)
            sub = [a[:rows7].contiguous() for a in (init, x, y, v)]
            units.append((f"K7 launch ({rows7} rows)", lambda sub=sub: k7(*sub, seed, *flats), 1))
        # K1 and K2 alone at the main path's shapes: MH's paired 2N rows, the
        # initial unpaired N rows, fit's batch of 32 and MALA's N rows.
        ws, sigs = zip(*(split_flipout_flat(f) for f in flats))
        sigs = sum(sigs, [])
        ps1 = flipout_step_perturbations(sigs, gen)
        ps2 = flipout_step_perturbations(sigs, gen, n_sets=2)
        stack = [torch.cat([a, a]) for a in (init, x, y, v)]
        k1, k1p, k2 = (model.kernels[k] for k in
                       ("bnn_hosteps", "bnn_hosteps_paired", "bnn_hosteps_grad"))
        rows32 = [a[:32].contiguous() for a in (init, x, y, v)]
        units += [(f"K1 launch ({N} rows)", lambda: k1(init, x, y, v, seed, *ws, ps1), 1),
                  (f"K1 paired launch ({2 * N} rows)", lambda: k1p(*stack, seed, *ws, ps2), 1),
                  ("K2 launch (32 rows)", lambda: k2(*rows32, seed, *ws, ps1), 1),
                  (f"K2 launch ({N} rows)", lambda: k2(init, x, y, v, seed, *ws, ps1), 1)]
    return units


def _mnist_units(model, images):
    """``[(name, zero-argument function, steps per call)]`` of MNISTBGM."""
    import contextlib
    import io

    import numpy as np
    import torch

    from bayesgm_torch.models import mnist as mn
    from bayesgm_torch.ops import optim
    from bayesgm_torch.utils.helpers import mnist_mask_indices

    cfg, dev = model.cfg, model.device
    data = model._train_data(images)
    n = data.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    model.data_z = torch.randn((n, cfg.z_dim), generator=gen, device=dev)
    state = {"z_opt": optim.table_adam_init(model.data_z)}

    def train_step():
        idx = torch.randint(0, n, (32,), generator=gen, device=dev)
        model.opt_g, state["z_opt"], _ = mn._train_batch_step(
            cfg, model.nets["g"], model.opt_g, model.data_z, state["z_opt"], idx, gen, data)

    def egm_iter():
        model._opt_d, model._opt_ge, _ = model._egm_iter(
            cfg, model.nets, model._opt_d, model._opt_ge, data, gen, 32,
            disc_step=mn._egm_disc_step, gen_step=mn._egm_gen_step)

    _, miss = mnist_mask_indices(mode="upper_half")
    test = np.array(images[:64]).reshape(64, -1)
    observed = [np.setdiff1d(np.arange(784), miss).tolist()] * 64

    def hmc(n_burn, n_keep):
        def run():
            with contextlib.redirect_stdout(io.StringIO()):  # the acceptance line
                model.tfp_mcmc_sampler(test, ind_x1=observed, n_mcmc=n_keep, burn_in=n_burn,
                                       num_leapfrog_steps=10, collect_p=model._decode_p)
        return run

    return lambda steps: [("training step", train_step, 1), ("EGM iteration", egm_iter, 1),
                          ("HMC burn-in step (64 images)", hmc(steps, 0), steps),
                          ("HMC kept step (64 images, decode)", hmc(0, steps), steps)]


def profile(label, fn, calls, per_call, warmup):
    """Time ``calls`` calls of ``fn`` (``per_call`` steps each), then profile
    as many; per-step numbers."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    steps = calls * per_call
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    out = {"unit": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms, "kernels_per_step": len(kernels) / steps,
           "top": [{"name": name[:60], "ms_per_step": tot / 1e3 / steps,
                    "us_per_launch": tot / cnt, "launches_per_step": cnt / steps}
                   for name, (tot, cnt) in top]}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nets", nargs="+", default=["plain", "bnn"],
                    choices=["plain", "bnn", "mnist"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=10)
    args = ap.parse_args()
    if "bnn" in args.nets and args.steps % 50:
        ap.error("--steps must be a multiple of 50 for the BNN window unit")

    import torch

    if not torch.cuda.is_available():
        print("profile_steps: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bayesgm_torch import CausalBGM, Sim_Hirano_Imbens_sampler
    from bayesgm_torch.utils.device import card_info

    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card_info()}", flush=True)
    data = Sim_Hirano_Imbens_sampler(batch_size=32, N=N, v_dim=V_DIM, seed=0).load_all()
    for nets in args.nets:
        if nets == "mnist":
            _profile_mnist(args)
            continue
        with tempfile.TemporaryDirectory() as out_dir:
            model = CausalBGM(dict(v_dim=V_DIM, z_dims=list(Z_DIMS), binary_treatment=False,
                                   dataset="profile", output_dir=out_dir,
                                   use_bnn=nets == "bnn", save_res=False,
                                   lr_decay="cosine"),
                              random_seed=123, device="cuda")
        for label, fn, per_call in _units(model, data, nets == "plain", args.steps):
            if per_call == 1:
                profile(f"{nets}: {label}", fn, args.steps, 1, args.warmup)
            else:
                profile(f"{nets}: {label}", fn, 1, per_call, 1)
    return 0


def _profile_mnist(args):
    from bayesgm_torch.datasets.images import make_ellipse_images
    from bayesgm_torch.models.mnist import MNISTBGM
    from bayesgm_torch.utils import config_io

    images = make_ellipse_images(8192, seed=0)
    for use_bnn in (False, True):
        label = "mnist-flipout" if use_bnn else "mnist"
        with tempfile.TemporaryDirectory() as out_dir:
            params = dict(config_io.load("configs/Mnist.yaml"), use_bnn=use_bnn,
                          output_dir=out_dir, save_res=False, save_model=False)
            model = MNISTBGM(params, random_seed=123, device="cuda")
        for name, fn, per_call in _mnist_units(model, images)(args.steps):
            if per_call == 1:
                profile(f"{label}: {name}", fn, args.steps, 1, args.warmup)
            else:
                profile(f"{label}: {name}", fn, 1, per_call, 1)


if __name__ == "__main__":
    sys.exit(main())
