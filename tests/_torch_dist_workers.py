"""The worker side of the port's tests in gloo worlds on the CPU.

Torch only: a spawned child imports this module and ``bayesgm_torch``,
never JAX nor a test file.  :func:`spawn` starts ``world`` processes, each
initializes gloo through a file rendezvous (TCP ports would collide across
the test workers), builds the mesh and runs the named scenarios in order.
A scenario is ``fn(mesh, out_dir) -> dict of numpy arrays``; each rank
writes ``{name}.w{world}.r{rank}.npz``, and in a world of one the rank also
runs the scenario without a mesh and writes ``{name}.ref.npz``, the
reference the parent holds every world against.  A rank that raises, or a
spawn that outlives its timeout, fails the spawn.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def spawn(world: int, names, out_dir: str, timeout: float = 300.0):
    """Run the scenarios ``names`` in a gloo world of ``world`` CPU
    processes; raises if a rank fails or the world outlives ``timeout``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, list(names), out_dir), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"world {world}: still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        errors = []
        for r in sorted(bad):
            path = os.path.join(out_dir, f"error.w{world}.r{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        raise RuntimeError(f"world {world}: ranks {bad} failed\n" + "\n".join(errors))


def load(out_dir, name, world, rank=0):
    return dict(np.load(os.path.join(out_dir, f"{name}.w{world}.r{rank}.npz")))


def load_ref(out_dir, name):
    return dict(np.load(os.path.join(out_dir, f"{name}.ref.npz")))


def _worker(rank, world, names, out_dir):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdzv.w{world}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        from bayesgm_torch.parallel import make_mesh

        mesh = make_mesh(world, device="cpu")
        for name in names:
            res = SCENARIOS[name](mesh, os.path.join(out_dir, f"{name}.w{world}"))
            np.savez(os.path.join(out_dir, f"{name}.w{world}.r{rank}.npz"), **res)
            if world == 1:
                ref = SCENARIOS[name](None, os.path.join(out_dir, f"{name}.ref"))
                np.savez(os.path.join(out_dir, f"{name}.ref.npz"), **ref)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error.w{world}.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


# ---------------------------------------------------------------------------
# shared set-ups
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _gather(mesh, t, axis=0):
    """Every rank's rows of ``t`` (``t`` itself without a mesh)."""
    if mesh is None:
        return t
    rows = mesh.rows_of(t.shape[axis])
    return rows.gather(t, axis)


def _take(mesh, a):
    """This rank's rows of ``a`` (all of it without a mesh), a tensor."""
    t = torch.as_tensor(np.asarray(a))
    return t if mesh is None else mesh.rows(t.shape[0]).take(t).contiguous()


def _leaves(nets, names):
    return {f"{k}.{i}": _np(p) for k in names for i, p in enumerate(nets[k].parameters())}


def hi_like_data(n=64, v_dim=6, seed=0, binary=False):
    """``tests/test_parallel.py``'s data."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, v_dim).astype("float32")
    x = rng.rand(n, 1).astype("float32")
    y = (x + v[:, :1] + 0.1 * rng.randn(n, 1)).astype("float32")
    if binary:
        x = (x > 0.5).astype("float32")
    return x, y, v


def step_setup():
    """The configuration, nets and data of ``tests/test_parallel.py``'s
    ``setup`` fixture (plain nets from a seeded generator)."""
    from bayesgm_torch.models import causalbgm as cb
    from bayesgm_torch.ops.nn import MLP, Critic

    cfg = cb.CBGMConfig(v_dim=6, z_dims=(1, 1, 1, 2), binary_treatment=False, use_bnn=False,
                        kl_weight=1e-4, sigma_v=None, sigma_x=None, sigma_y=None,
                        use_z_rec=1.0, lr=2e-4, lr_theta=1e-4, lr_z=1e-4, g_d_freq=5)
    gen = torch.Generator().manual_seed(0)
    nets = {"g": MLP(5, 7, [8, 8], gen), "e": MLP(6, 5, [8, 8], gen), "f": MLP(3, 2, [8], gen),
            "h": MLP(2, 2, [8], gen), "dz": Critic(5, [8], gen)}
    rng = np.random.RandomState(0)
    n = 64
    data = (rng.rand(n, 1).astype("float32"), rng.randn(n, 1).astype("float32"),
            rng.randn(n, 6).astype("float32"))
    z = rng.randn(n, 5).astype("float32")
    return cfg, nets, data, z


# ---------------------------------------------------------------------------
# helpers and kernels (tests/test_torch_parallel.py)
# ---------------------------------------------------------------------------


@scenario
def helpers(mesh, out_dir):
    """The mesh helpers; an empty rank at n = 5 over 8 ranks."""
    from bayesgm_torch.parallel import (
        data_sharding,
        make_mesh,
        replicate,
        replicated_shard_map,
        rowwise_shard_map,
        shard_rows,
    )
    from bayesgm_torch.parallel.mesh import mesh_batches

    if mesh is None:
        return {}
    try:
        make_mesh(mesh.size + 1, device="cpu")
        raised = 0
    except ValueError:
        raised = 1
    arr = np.arange(64, dtype=np.float32).reshape(16, 4)
    local, rows = shard_rows(arr, mesh)
    five = mesh.rows(5)
    t5 = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    g5 = five.gather(five.take(t5))
    # minibatches of rows spread over the ranks, some ranks holding none
    first, second = mesh_batches(five, [torch.tensor([4, 0, 2]), torch.tensor([1, 3])])
    (b5,) = first.take(five.take(t5).contiguous())
    (b5b,) = second.take(five.take(t5).contiguous())
    total = five.all_sum(torch.tensor([float(five.local)]))
    tree = {"a": torch.ones(3)}
    seed = torch.tensor([7, 11], dtype=torch.int32)
    mapped = rowwise_shard_map(lambda a, s: a * 2 + s[1].to(a.dtype), mesh, 1,
                               seed_arg=1)(t5, seed)
    return dict(raised=np.asarray(raised), local=_np(local), lo_hi=np.asarray([rows.lo, rows.hi]),
                gathered=_np(rows.gather(local)), five_lo_hi=np.asarray([five.lo, five.hi]),
                five_gathered=_np(g5), batch5=_np(b5), batch5b=_np(b5b), total=_np(total),
                spec=np.asarray([str(s) for s in data_sharding(mesh, ndim=3).spec]),
                replicated=np.asarray(replicate(tree, mesh) is tree),
                same_fn=np.asarray(replicated_shard_map(len, mesh) is len),
                mapped=_np(mapped), size=np.asarray(mesh.size))


@scenario
def train_step(mesh, out_dir):
    """The full-batch sharded step; without a mesh, the port's one-device
    step over every row (``_train_batch_step`` with all indices).  Then
    the same with ``deconf_weight`` (its penalty's means over every rank's
    rows), keys prefixed ``deconf.``."""
    out = _train_step(mesh, 0.0)
    out.update({f"deconf.{k}": a for k, a in _train_step(mesh, 0.5).items()})
    return out


def _train_step(mesh, deconf_weight):
    from bayesgm_torch.models import causalbgm as cb
    from bayesgm_torch.ops import optim
    from bayesgm_torch.parallel.sharded import make_sharded_causal_train_step

    cfg, nets, data, z = step_setup()
    cfg = cfg._replace(deconf_weight=deconf_weight)
    opts = {k: optim.adam_init(nets[k].parameters()) for k in ("g", "f", "h")}
    gen = torch.Generator().manual_seed(7)
    if mesh is None:
        z_t = torch.as_tensor(z)
        z_opt = optim.table_adam_init(z_t)
        tdata = tuple(torch.as_tensor(a) for a in data)
        opts, z_opt, losses = cb._train_batch_step(cfg, nets, opts, z_t, z_opt,
                                                   torch.arange(z_t.shape[0]), gen, tdata)
        losses = {k: losses[k] for k in ("loss_v", "loss_x", "loss_y", "loss_postrior_z")}
    else:
        z_t = _take(mesh, z)
        z_opt = optim.table_adam_init(z_t)
        step = make_sharded_causal_train_step(cfg, mesh)
        nets, opts, z_t, z_opt, losses = step(nets, opts, z_t, z_opt,
                                              tuple(_take(mesh, a) for a in data), gen)
    out = {f"loss.{k}": _np(v) for k, v in losses.items()}
    out.update(z=_np(_gather(mesh, z_t)), m=_np(_gather(mesh, z_opt.m)),
               v=_np(_gather(mesh, z_opt.v)), **_leaves(nets, "ghf"))
    out.update({f"opt.{k}.m{i}": _np(t) for k in "ghf" for i, t in enumerate(opts[k].m)})
    return out


@scenario
def sharded_mh(mesh, out_dir):
    """The sharded MH predict; without a mesh the same chain on one rank."""
    from bayesgm_torch.models import causalbgm as cb
    from bayesgm_torch.ops import mcmc
    from bayesgm_torch.parallel.sharded import make_sharded_mh_predict

    cfg, nets, data, _ = step_setup()
    gen = torch.Generator().manual_seed(0)
    if mesh is None:
        x, y, v = (torch.as_tensor(a) for a in data)
        collect = cb._effect_collector(cfg, nets, [0.5, 1.0, 1.5], True)
        with torch.no_grad():
            init = torch.randn((x.shape[0], 5), generator=gen)
            res = mcmc.adaptive_mh(
                lambda p, z, g: -cb._neg_log_posterior_rows(cfg, nets, z, x, y, v, g), init,
                gen, burn_in=30, n_keep=20, q_sd=1.0, collect=lambda p, z, g: collect(z, g))
    else:
        run = make_sharded_mh_predict(cfg, mesh, nets, tuple(_take(mesh, a) for a in data),
                                      x_values=[0.5, 1.0, 1.5])
        res = run(gen, burn_in=30, n_keep=20, q_sd=1.0)
    return dict(effects=_np(res.samples), rate=_np(res.accept_rate), q_sd=_np(res.q_sd))


def _logp_model(out_dir, use_bnn, rho=None):
    from bayesgm_torch.models.causalbgm import CausalBGM

    p = dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="meshlp",
             output_dir=out_dir, use_bnn=use_bnn, save_res=False, save_model=False,
             use_pallas_latent=True)
    if use_bnn:
        p.update(g_units=[16, 8], e_units=[16, 8], f_units=[8], h_units=[8], dz_units=[8])
    m = CausalBGM(p, random_seed=3 if not use_bnn else 5, device="cpu")
    if rho is not None:
        with torch.no_grad():
            for k in "ghf":
                for r in m.nets[k].rho:
                    r.fill_(rho)
    return m


def _logp_inputs(seed):
    rng = np.random.RandomState(seed)
    n = 37  # not divisible by the world: uneven blocks
    data = (rng.rand(n, 1).astype("float32"), rng.randn(n, 1).astype("float32"),
            rng.randn(n, 6).astype("float32"))
    return data, rng.randn(n, 5).astype("float32"), rng.randn(n, 5).astype("float32")


@scenario
def param_logp(mesh, out_dir):
    """The params-mode MH targets per rank at n = 37: K4 (plain) and K1
    (BNN), each through its wrapper (the plain versions here)."""
    out = {}
    for tag, use_bnn in (("plain", False), ("bnn", True)):
        m = _logp_model(out_dir, use_bnn)
        data, z, z2 = _logp_inputs(1)
        lp, plp, make_params, multi = m._make_param_log_prob(mesh=mesh)
        params = make_params(m.nets, tuple(_take(mesh, a).numpy() for a in data), use_bnn)
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            out[f"{tag}.lp"] = _np(_gather(mesh, lp(params, _take(mesh, z), gen)))
            if plp is not None:
                a, b = plp(params, _take(mesh, z), _take(mesh, z2), gen)
                out[f"{tag}.plp"] = np.stack([_np(_gather(mesh, a)), _np(_gather(mesh, b))])
        out[f"{tag}.launches"] = np.asarray([k.launches for k in m.kernels.values()])
        out[f"{tag}.multi_step"] = np.asarray(multi is not None)
    return out


@scenario
def bnn_paired_rho20(mesh, out_dir):
    """The BNN target per rank in the deterministic flipout limit (rho =
    -20: the weight noise vanishes, so every rank's signs give the
    composite's value): K1 paired and unpaired, and the composite."""
    from bayesgm_torch.models import causalbgm as cb

    m = _logp_model(out_dir, True, rho=-20.0)
    data, z_prop, z_cur = _logp_inputs(6)
    lp, plp, make_params, _ = m._make_param_log_prob(mesh=mesh)
    params = make_params(m.nets, tuple(_take(mesh, a).numpy() for a in data), True)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        got_p, got_c = plp(params, _take(mesh, z_prop), _take(mesh, z_cur), gen)
        got_lp = lp(params, _take(mesh, z_prop), gen)
        x, y, v = (torch.as_tensor(a) for a in data)
        want = [-cb._neg_log_posterior_rows(m.cfg, m.nets, torch.as_tensor(zz), x, y, v, gen)
                for zz in (z_prop, z_cur)]
    return dict(prop=_np(_gather(mesh, got_p)), cur=_np(_gather(mesh, got_c)),
                lp=_np(_gather(mesh, got_lp)), want_prop=_np(want[0]), want_cur=_np(want[1]))


@scenario
def latent_vg(mesh, out_dir):
    """The latent value-and-gradient (K3's wrapper) run replicated on every
    rank: each rank's output is the one-device output."""
    from bayesgm_torch.parallel import replicated_shard_map

    m = _logp_model(out_dir, False)
    vg = m._build_fused_latent_vg()
    if mesh is not None:
        vg = replicated_shard_map(vg, mesh)
    rng = np.random.RandomState(2)
    bz, bx, by, bv = (torch.as_tensor(a) for a in (
        rng.randn(16, 5).astype("float32"), rng.rand(16, 1).astype("float32"),
        rng.randn(16, 1).astype("float32"), rng.randn(16, 6).astype("float32")))
    neg, grad = vg(bz, bx, by, bv, m.nets, torch.Generator().manual_seed(0))
    return dict(neg=_np(neg), grad=_np(grad))


# ---------------------------------------------------------------------------
# models (tests/test_torch_parallel_models.py)
# ---------------------------------------------------------------------------


def _causal_params(out_dir, **kw):
    p = dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="mesh",
             output_dir=out_dir, use_bnn=False, g_units=[8], e_units=[8], f_units=[8],
             h_units=[8], dz_units=[8], save_res=False, save_model=False)
    p.update(kw)
    return p


@scenario
def fit_predict(mesh, out_dir):
    """CausalBGM's public fit and predict (``tests/test_parallel.py``'s
    case), with plain nets and with flipout nets on the composite target."""
    from bayesgm_torch.models.causalbgm import CausalBGM

    data = hi_like_data()
    out = {}
    for tag, use_bnn in (("plain", False), ("bnn", True)):
        m = CausalBGM(_causal_params(out_dir, use_bnn=use_bnn), random_seed=11, device="cpu")
        m.fit(data, epochs=2, epochs_per_eval=2, batch_size=16, use_egm_init=False,
              verbose=0, mesh=mesh)
        adrf, ci = m.predict(data, alpha=0.2, n_mcmc=20, burn_in=30, x_values=[0.5, 1.0],
                             q_sd=1.0, mesh=mesh)
        out.update({f"{tag}.data_z": _np(m.data_z), f"{tag}.adrf": adrf, f"{tag}.ci": ci,
                    **{f"{tag}.{k}": a for k, a in _leaves(m.nets, "ghf").items()}})
    # binary treatment through MALA: the ITE draws are gathered
    m = CausalBGM(_causal_params(out_dir, binary_treatment=True, dataset="mesh_b"),
                  random_seed=2, device="cpu")
    m.fit(hi_like_data(binary=True), epochs=1, epochs_per_eval=1, batch_size=16,
          use_egm_init=False, verbose=0, mesh=mesh)
    ite, ci = m.predict(hi_like_data(binary=True), alpha=0.2, n_mcmc=10, burn_in=10,
                        sampler="mala", mesh=mesh)
    out.update({"mala.ite": ite, "mala.ci": ci})
    return out


@scenario
def egm_kernel_fit(mesh, out_dir):
    """A fit through the EGM and the kernel wrappers (K3 replicated in the
    latent update, K4 per rank in predict), with a checkpoint at every
    eval epoch."""
    from bayesgm_torch.models.causalbgm import CausalBGM
    from bayesgm_torch.utils import checkpoint as ckpt

    data = hi_like_data(n=40)
    m = CausalBGM(_causal_params(out_dir, use_pallas_latent=True, save_model=True),
                  timestamp="t0", random_seed=4, device="cpu")
    m.fit(data, epochs=1, epochs_per_eval=1, batch_size=16, egm_n_iter=4,
          egm_batches_per_eval=2, verbose=0, mesh=mesh)
    adrf, ci = m.predict(data, alpha=0.2, n_mcmc=10, burn_in=10, x_values=[0.5], mesh=mesh)
    with np.load(ckpt.latest_checkpoint(m.checkpoint_path)) as f:
        state = {k: f[k] for k in f.files}
    return dict(adrf=adrf, ci=ci, data_z=_np(m.data_z),
                launches=np.asarray([m.kernels["plain_grad"].launches,
                                     m.kernels["plain"].launches]),
                **{f"ckpt.{k}": v for k, v in state.items()})


@scenario
def resume(mesh, out_dir):
    """A fit killed after its first eval epochs and resumed from the
    checkpoint (written by rank 0 alone) against an uninterrupted one."""
    from bayesgm_torch.models.causalbgm import CausalBGM

    data = hi_like_data(n=48)
    p = _causal_params(out_dir, save_model=True)
    full = CausalBGM(dict(p, dataset="full"), timestamp="a", random_seed=5, device="cpu")
    full.fit(data, epochs=3, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0,
             mesh=mesh)
    first = CausalBGM(dict(p, dataset="cut"), timestamp="b", random_seed=5, device="cpu")
    first.fit(data, epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False,
              verbose=0, mesh=mesh)
    files = sorted(os.listdir(first.checkpoint_path))
    again = CausalBGM(dict(p, dataset="cut"), timestamp="b", random_seed=5, device="cpu")
    again.fit(data, epochs=3, epochs_per_eval=1, batch_size=16, use_egm_init=False,
              verbose=0, mesh=mesh)
    return dict(full_z=_np(full.data_z), resumed_z=_np(again.data_z),
                files=np.asarray(files), **{f"full.{k}": a for k, a in
                                            _leaves(full.nets, "ghf").items()},
                **{f"resumed.{k}": a for k, a in _leaves(again.nets, "ghf").items()})


@scenario
def early_stop(mesh, out_dir):
    """The ESS gate of predict(ess_target=) on gathered ITE draws: it stops
    at the same kept step on every rank, and where one rank does."""
    from bayesgm_torch.models.causalbgm import CausalBGM

    data = hi_like_data(n=24, binary=True)
    m = CausalBGM(_causal_params(out_dir, binary_treatment=True, dataset="gate"),
                  random_seed=3, device="cpu")
    m.fit(data, epochs=0, epochs_per_eval=1, batch_size=8, use_egm_init=False, verbose=0,
          mesh=mesh)
    ite, ci, draws = m.predict(data, alpha=0.2, n_mcmc=2000, burn_in=0, ess_target=2.0,
                               ess_rhat=10.0, return_draws=True, mesh=mesh)
    return dict(ite=ite, ci=ci, n_draws=np.asarray(draws.shape[0]), draws=draws)


@scenario
def identifiable(mesh, out_dir):
    from bayesgm_torch.models.identifiable import IdentifiableCausalBGM

    data = hi_like_data()
    m = IdentifiableCausalBGM(_causal_params(out_dir, dataset="ivae", prior_units=[8],
                                             n_segments=4), random_seed=6, device="cpu")
    m.fit(data, epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0,
          mesh=mesh)
    adrf, ci = m.predict(data, alpha=0.2, n_mcmc=10, burn_in=20, x_values=[0.5, 1.0],
                         q_sd=1.0, mesh=mesh)
    return dict(adrf=adrf, ci=ci, data_z=_np(m.data_z), data_u=_np(m.data_u),
                prior=_np(next(m.prior_net.parameters())))


@scenario
def fullmcmc(mesh, out_dir):
    """``tests/test_parallel.py``'s FullMCMC case."""
    from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM

    data = hi_like_data()
    m = FullMCMCCausalBGM(_causal_params(out_dir, dataset="mesh_fullmcmc"), random_seed=13,
                          device="cpu")
    m.fit(data, epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0,
          mesh=mesh)
    m.run_mcmc_training(data, num_samples=8, num_burnin=8, mesh=mesh)
    adrf, ci = m.predict(data, alpha=0.2, n_mcmc=10, burn_in=10, x_values=[0.5, 1.0],
                         q_sd=1.0, mesh=mesh)
    draws = m.metropolis_hastings_sampler(data, burn_in=5, n_keep=4, mesh=mesh)
    return dict(g=m.g_net_samples, h=m.h_net_samples, f=m.f_net_samples, adrf=adrf, ci=ci,
                draws=draws)


@scenario
def bgm_predict(mesh, out_dir):
    """``tests/test_parallel.py``'s BGM case, with both decoders."""
    from bayesgm_torch.models.bgm import BGM

    rng = np.random.RandomState(0)
    z = rng.randn(64, 2)
    w = rng.randn(2, 4)
    data = (z @ w + 0.1 * rng.randn(64, 4)).astype("float32")
    out = {}
    for tag, use_bnn in (("plain", False), ("bnn", True)):
        p = dict(x_dim=4, z_dim=2, dataset=f"mesh_bgm_{tag}", output_dir=out_dir,
                 use_bnn=use_bnn, g_units=[8], e_units=[8], dz_units=[8], dx_units=[8],
                 save_res=False, save_model=False)
        m = BGM(p, random_seed=5, device="cpu")
        m.fit(data, epochs=2, epochs_per_eval=2, batch_size=16, use_egm_init=False,
              verbose=0, mesh=mesh)
        test = np.array(data[:16])
        test[:, 0] = np.nan
        imputed, intervals = m.predict(test, alpha=0.2, bs=16, n_mcmc=20, burn_in=20,
                                       mesh=mesh)
        out.update({f"{tag}.imputed": imputed, f"{tag}.intervals": intervals,
                    f"{tag}.data_z": _np(m.data_z)})
    return out


@scenario
def mnist_predict(mesh, out_dir):
    """``tests/test_parallel.py``'s MNIST case (the batch-statistic
    BatchNorm over every rank's chains)."""
    from bayesgm_torch.models.mnist import MNISTBGM

    rng = np.random.RandomState(2)
    data = (rng.rand(16, 28, 28, 1) > 0.7).astype("float32")
    p = dict(z_dim=4, dataset="mesh_mnist", output_dir=out_dir, use_bnn=False,
             dz_units=[8], save_res=False, save_model=False)
    m = MNISTBGM(p, random_seed=7, device="cpu")
    m.fit(data, epochs=1, epochs_per_eval=1, batch_size=8, use_egm_init=False, verbose=0,
          mesh=mesh)
    test = np.array(data[:8])
    test[:, 10:18, 10:18, :] = np.nan
    imputed, intervals = m.predict(test, alpha=0.2, bs=8, n_mcmc=6, burn_in=6, mesh=mesh)
    return dict(imputed=imputed, intervals=np.asarray(intervals), data_z=_np(m.data_z))


@scenario
def ensemble(mesh, out_dir):
    """An ensemble of two members; ``mesh`` reaches each member."""
    from bayesgm_torch.models.ensemble import EnsembleCausalBGM

    data = hi_like_data(n=32)
    m = EnsembleCausalBGM(_causal_params(out_dir, dataset="ens", n_members=2),
                          random_seed=3, device="cpu")
    m.fit(data, epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False, verbose=0,
          mesh=mesh)
    adrf, ci = m.predict(data, alpha=0.2, n_mcmc=10, burn_in=10, x_values=[0.5, 1.0],
                         mesh=mesh)
    return dict(adrf=adrf, ci=ci)


@scenario
def jax_parity_step(mesh, out_dir):
    """The port's full-batch step on ``__graft_entry__._tiny_setup``'s plain
    nets and data, read from ``jax_tiny.npz`` (written by the parent in the
    checkpoint layout)."""
    from bayesgm_torch import bridge
    from bayesgm_torch.models import causalbgm as cb
    from bayesgm_torch.ops import optim
    from bayesgm_torch.parallel.sharded import make_sharded_causal_train_step
    from bayesgm_torch.utils import checkpoint as ckpt

    if mesh is None:
        return {}
    inp = bridge.npz_tree(os.path.join(os.path.dirname(out_dir), "jax_tiny.npz"))
    nets = bridge.nets_from_numpy(inp["nets"])
    cfg = cb.CBGMConfig(v_dim=8, z_dims=(1, 1, 1, 3), binary_treatment=False, use_bnn=False,
                        kl_weight=1e-4, sigma_v=None, sigma_x=None, sigma_y=None,
                        use_z_rec=1.0, lr=2e-4, lr_theta=1e-4, lr_z=1e-4, g_d_freq=5)
    opts = {k: optim.adam_init(nets[k].parameters()) for k in ("g", "f", "h")}
    z_t = _take(mesh, inp["z"])
    z_opt = optim.table_adam_init(z_t)
    step = make_sharded_causal_train_step(cfg, mesh)
    nets, opts, z_t, z_opt, losses = step(
        nets, opts, z_t, z_opt, tuple(_take(mesh, inp[k]) for k in "xyv"),
        torch.Generator().manual_seed(0))
    out = {f"loss.{k}": _np(v) for k, v in losses.items()}
    out.update(z=_np(_gather(mesh, z_t)), m=_np(_gather(mesh, z_opt.m)),
               v=_np(_gather(mesh, z_opt.v)))
    out.update(ckpt.flatten({"nets": bridge.nets_to_numpy(nets)}))
    return out

