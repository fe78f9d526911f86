"""Dry run of every mesh path of the port in a world of N processes (port of
``__graft_entry__.dryrun_multichip``).

``python -m bayesgm_torch.parallel.dryrun --world N`` spawns N ranks: NCCL
over N cards when there are N, or gloo on the CPU with ``--device cpu``.
Each rank builds the mesh and runs, section by section:

- the tiny setup (plain nets on ``4 N`` rows);
- one full-batch sharded training step and one sharded MH round;
- CausalBGM, IdentifiableCausalBGM, FullMCMCCausalBGM (with its weight
  HMC), BGM and MNISTBGM ``fit``/``predict`` with ``mesh=``.

A rank that fails makes the run exit non-zero; so does a collective that
does not complete within ``--timeout`` seconds.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile

import numpy as np
import torch


def _tiny_setup(v_dim=8, z_dims=(1, 1, 1, 3), n=32, seed=0, device="cpu"):
    """``(cfg, nets, (x, y, v), z)``: plain nets of ``__graft_entry__``'s
    widths from a seeded generator, and seeded numpy data."""
    from bayesgm_torch.models import causalbgm as cb
    from bayesgm_torch.ops.nn import MLP, Critic

    cfg = cb.CBGMConfig(
        v_dim=v_dim, z_dims=tuple(z_dims), binary_treatment=False, use_bnn=False,
        kl_weight=1e-4, sigma_v=None, sigma_x=None, sigma_y=None, use_z_rec=1.0,
        lr=2e-4, lr_theta=1e-4, lr_z=1e-4, g_d_freq=5)
    z_dim = sum(z_dims)
    gen = torch.Generator().manual_seed(seed)
    nets = {
        "g": MLP(z_dim, v_dim + 1, [16, 16], gen),
        "e": MLP(v_dim, z_dim, [16, 16], gen),
        "f": MLP(z_dims[0] + z_dims[1] + 1, 2, [16], gen),
        "h": MLP(z_dims[0] + z_dims[2], 2, [16], gen),
        "dz": Critic(z_dim, [16], gen),
    }
    nets = {k: net.to(device) for k, net in nets.items()}
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1).astype("float32")
    y = rng.randn(n, 1).astype("float32")
    v = rng.randn(n, v_dim).astype("float32")
    z = rng.randn(n, z_dim).astype("float32")
    return cfg, nets, (x, y, v), z


def run_sections(mesh, out_dir: str) -> dict:
    """Every section of the dry run on this rank; returns what it checked."""
    from bayesgm_torch.models.bgm import BGM
    from bayesgm_torch.models.causalbgm import CausalBGM
    from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM
    from bayesgm_torch.models.identifiable import IdentifiableCausalBGM
    from bayesgm_torch.models.mnist import MNISTBGM
    from bayesgm_torch.ops import optim
    from bayesgm_torch.parallel import shard_rows
    from bayesgm_torch.parallel.sharded import (
        make_sharded_causal_train_step,
        make_sharded_mh_predict,
    )

    dev = mesh.device
    n = mesh.size * 4
    cfg, nets, (x, y, v), z = _tiny_setup(n=n, device=dev)
    opts = {k: optim.adam_init(nets[k].parameters()) for k in ("g", "f", "h")}
    data = tuple(shard_rows(a, mesh)[0] for a in (x, y, v))
    z_table, _ = shard_rows(z, mesh)
    z_opt = optim.table_adam_init(z_table)
    gen = torch.Generator(device=dev).manual_seed(1)
    step = make_sharded_causal_train_step(cfg, mesh)
    nets, opts, z_table, z_opt, losses = step(nets, opts, z_table, z_opt, data, gen)
    losses = {k: float(t) for k, t in losses.items()}
    if not all(np.isfinite(val) for val in losses.values()):
        raise RuntimeError(f"sharded train step: non-finite losses {losses}")

    run = make_sharded_mh_predict(cfg, mesh, nets, data, x_values=[0.5, 1.0])
    res = run(torch.Generator(device=dev).manual_seed(2), burn_in=20, n_keep=10, q_sd=1.0)
    effects = res.samples.cpu().numpy()
    if effects.shape != (10, 2) or not np.all(np.isfinite(effects)):
        raise RuntimeError(f"sharded MH predict: effects {effects.shape}")

    params = dict(v_dim=8, z_dims=[1, 1, 1, 3], binary_treatment=False,
                  dataset="dryrun", output_dir=out_dir, use_bnn=False,
                  g_units=[16, 16], e_units=[16, 16], f_units=[16], h_units=[16],
                  dz_units=[16], save_res=False, save_model=False)
    rng = np.random.RandomState(1)
    xd = rng.rand(n, 1).astype("float32")
    yd = rng.randn(n, 1).astype("float32")
    vd = rng.randn(n, 8).astype("float32")
    kw = dict(device=dev)
    model = CausalBGM(params, random_seed=3, **kw)
    model.fit((xd, yd, vd), epochs=1, epochs_per_eval=1, batch_size=8,
              use_egm_init=False, verbose=0, mesh=mesh)
    adrf, _ = model.predict((xd, yd, vd), alpha=0.2, n_mcmc=10, burn_in=20,
                            x_values=[0.5, 1.0], q_sd=1.0, mesh=mesh)
    _check("CausalBGM", adrf, (2,))

    iparams = dict(params, dataset="dryrun_ivae", prior_units=[16], n_segments=4)
    imodel = IdentifiableCausalBGM(iparams, random_seed=6, **kw)
    imodel.fit((xd, yd, vd), epochs=1, epochs_per_eval=1, batch_size=8,
               use_egm_init=False, verbose=0, mesh=mesh)
    iadrf, _ = imodel.predict((xd, yd, vd), alpha=0.2, n_mcmc=10, burn_in=20,
                              x_values=[0.5, 1.0], q_sd=1.0, mesh=mesh)
    _check("IdentifiableCausalBGM", iadrf, (2,))

    fmodel = FullMCMCCausalBGM(dict(params, dataset="dryrun_fullmcmc"), random_seed=8, **kw)
    fmodel.fit((xd, yd, vd), epochs=1, epochs_per_eval=1, batch_size=8,
               use_egm_init=False, verbose=0, mesh=mesh)
    fmodel.run_mcmc_training((xd, yd, vd), num_samples=4, num_burnin=4, mesh=mesh)
    fadrf, _ = fmodel.predict((xd, yd, vd), alpha=0.2, n_mcmc=8, burn_in=8,
                              x_values=[0.5, 1.0], q_sd=1.0, mesh=mesh)
    _check("FullMCMCCausalBGM", fadrf, (2,))

    bdata = rng.randn(n, 4).astype("float32")
    bgm = BGM(dict(x_dim=4, z_dim=2, dataset="dryrun_bgm", output_dir=out_dir,
                   use_bnn=False, g_units=[8], e_units=[8], dz_units=[8], dx_units=[8],
                   save_res=False, save_model=False), random_seed=4, **kw)
    bgm.fit(bdata, epochs=1, epochs_per_eval=1, batch_size=8, use_egm_init=False,
            verbose=0, mesh=mesh)
    test = np.array(bdata[:n])
    test[:, 0] = np.nan
    imputed, _ = bgm.predict(test, alpha=0.2, bs=n, n_mcmc=10, burn_in=10, mesh=mesh)
    _check("BGM", imputed, test.shape)

    mdata = (rng.rand(n, 28, 28, 1) > 0.7).astype("float32")
    mnist = MNISTBGM(dict(z_dim=4, dataset="dryrun_mnist", output_dir=out_dir,
                          use_bnn=False, dz_units=[8], save_res=False, save_model=False),
                     random_seed=9, **kw)
    mnist.fit(mdata, epochs=1, epochs_per_eval=1, batch_size=8, use_egm_init=False,
              verbose=0, mesh=mesh)
    mtest = np.array(mdata[:n])
    mtest[:, 10:18, 10:18, :] = np.nan
    minp, _ = mnist.predict(mtest, alpha=0.2, bs=n, n_mcmc=8, burn_in=8, mesh=mesh)
    _check("MNISTBGM", minp, mtest.shape)
    return dict(losses=losses, accept_rate=float(res.accept_rate), adrf=adrf.tolist())


def _check(name, out, shape):
    if np.shape(out) != tuple(shape) or not np.all(np.isfinite(out)):
        raise RuntimeError(f"{name} under the mesh: output {np.shape(out)}, expected {shape}, "
                           "all finite")


def _rank_main(rank, world, backend, device, init_method, timeout, out_dir):
    import torch.distributed as dist

    from bayesgm_torch.parallel import make_mesh

    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_mesh(world, device=device)
        got = run_sections(mesh, out_dir)
        if rank == 0:
            print(f"dryrun({world}, {backend}) OK: {got}")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=2, help="number of ranks (processes)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: NCCL, one card per rank; cpu: gloo on the CPU")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds a collective may wait before the run fails")
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dryrun: CUDA is not available (use --device cpu for gloo on the CPU)")
        if torch.cuda.device_count() < args.world:
            raise SystemExit(f"dryrun: --world {args.world} needs {args.world} cards, "
                             f"{torch.cuda.device_count()} visible")
    backend = "nccl" if args.device == "cuda" else "gloo"
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.start_processes(_rank_main, args=(args.world, backend, args.device,
                                                   init_method, args.timeout, tmp),
                                 nprocs=args.world, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except mp.ProcessRaisedException as e:
            print(f"dryrun: a rank failed:\n{e}", file=sys.stderr)
            return 1
        except mp.ProcessExitedException as e:
            print(f"dryrun: a rank exited: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
