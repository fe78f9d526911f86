#!/usr/bin/env python3
"""Where the time of the port's steps goes, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/profile_steps.py [--nets plain bnn] [--steps 50] [--warmup 10]

For each kind of nets, at the width of the repo's training benchmark
(Sim_Hirano_Imbens, n=20000, v_dim=200, z_dims [1,1,1,7], default units,
random weights from seed 123), it times four units of work:

- a training step (batch 32; the latent update through K2 or K3);
- an EGM iteration (5 critic + 1 generator steps, batch 32);
- an MH burn-in step over one predict batch (K1 paired for BNN nets over all
  n rows, K4 for plain nets over 10000 rows), no collector;
- an MH kept step: the same plus the 20-point ADRF collector.

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

    from bayesgm_torch.models import causalbgm as cb
    from bayesgm_torch.ops import mcmc, optim

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
    lp, plp, make_params = model._make_param_log_prob()
    params = make_params(model.nets, tuple(a[:rows].cpu().numpy() for a in (x, y, v)),
                         not plain)
    collect_p = cb._effect_collector_p(cfg, X_VALUES, True)
    init = torch.randn((rows, sum(Z_DIMS)), generator=gen, device=dev)

    def mh(n_burn, n_keep):
        def run():
            with torch.no_grad():
                mcmc.adaptive_mh(lp, init, gen, burn_in=n_burn, n_keep=n_keep, q_sd=1.0,
                                 adaptive=False, recompute_current=not plain,
                                 collect=collect_p, paired_log_prob_fn=plp, params=params)
        return run

    return [("training step", train_step, 1), ("EGM iteration", egm_iter, 1),
            (f"MH burn-in step ({rows} rows)", mh(steps, 0), steps),
            (f"MH kept step ({rows} rows)", mh(0, steps), steps)]


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
    ap.add_argument("--nets", nargs="+", default=["plain", "bnn"], choices=["plain", "bnn"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=10)
    args = ap.parse_args()

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


if __name__ == "__main__":
    sys.exit(main())
