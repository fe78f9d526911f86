"""Both packages' FullMCMC weight HMC stepped side by side from one fitted
state on the same draws: where, and by how much, the port's trajectories
part from the JAX package's (not a test; pytest does not collect it).

It loads a ``fitted.npz`` of ``tools/fullmcmc_stage_split.py`` into both
packages' ``FullMCMCCausalBGM`` (binary_ate's params and data, as
``tests/_jax_fullmcmc_reference.py`` builds them; ``--flagship`` the
flagship's), captures the HMC targets over g's, h's and f's flat weights
that each package's ``run_mcmc_training`` hands to its ``hmc``, and steps
JAX's ``_hmc_step`` (``bayesgm_tpu/ops/mcmc.py``) and the port's
(``bayesgm_torch/ops/mcmc.py``) on momenta and accept uniforms drawn with
numpy from one seed: the full schedule, ``--hmc_burnin`` steps (the
first 80 % adapting the step size) then ``--hmc_samples`` kept steps
(``run_mcmc_training``'s 1000 and 2000), with its step size, leapfrog count
and adaptation rate.

``--precision f64`` runs both in float64: JAX with ``jax_enable_x64``, its
flat weights unravelled to float64 leaves and ``bayesgm_tpu.ops.nn``'s
dense layer without its float32 result type (replaced inside this process
only); the port's data, latent table and weights as float64 tensors.  The
uniforms are float32 values in both precisions, so the two packages see the
same numbers.

Where the two accept decisions (or the two step-size nudges) differ, the
step is recorded with its margin ``|log accept ratio - log u|`` (or
``|accept probability - 0.75|``; a nudge the same way rounded to another
float32 is a ``step_rounding`` parting, its margin the relative difference
of the two step sizes), and the port's chain is set to JAX's state before
the next step, so that every later step is compared again from one state
(``--resync_each_step``: before every step, so that each step's difference
is that step's own).  Each step's line (``--log``): the largest ``|state
difference|`` and that over the largest ``|state|``, both packages' log
target, log accept ratio and step size, and ``log u``.  Per net one
``summary`` line on stdout: the first parting step and its margin, every
parting's step and margin, the largest relative state difference over the
steps where the decisions agree, both packages' acceptance over the kept
steps and their final step sizes (``--stop_at_parting`` ends each net at
its first parting; ``--nets`` picks the nets); under ``--precision f64``
first one ``rounding`` line per net: each package's log target at the
fitted weights in float32 and in float64, and their difference.

At binary_ate's size on 2 CPU cores, float64: about 1 h for g's 3000 steps
and 15 min for h's:
    python tests/_jax_hmc_trajectory.py --state DIR/fitted.npz --precision f64 \\
        --log DIR/traj_f64.jsonl
"""

import argparse
import json
import os
import sys
import time
from functools import partial

PRE = argparse.ArgumentParser(add_help=False)
PRE.add_argument("--precision", choices=["f32", "f64"], default="f32")
PRECISION = PRE.parse_known_args()[0].precision

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
if PRECISION == "f64":
    jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)

import _jax_fullmcmc_reference as ref  # noqa: E402
from bayesgm_tpu.models import fullmcmc as jfm  # noqa: E402
from bayesgm_tpu.ops import mcmc as jmcmc  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_torch.models import fullmcmc as tfm  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402

NP_DTYPE = {"f32": np.float32, "f64": np.float64}
DRAW_SEED = 0  # the numpy seed of the momenta and uniforms
TORCH_DTYPE = {"f32": torch.float32, "f64": torch.float64}


def _capture(model, module, data):
    """The ``(log_prob, init_state, hmc kwargs)`` of each net that
    ``model.run_mcmc_training`` hands to ``module.mcmc.hmc`` (no step
    taken)."""
    seen = []
    real = module.mcmc.hmc

    def hmc(log_prob, init, _rng, **kw):
        seen.append((log_prob, init, kw))
        if module is jfm:
            return jmcmc.HMCResult(init[None], 0.0, 0.0)
        return tmcmc.HMCResult(init[None], torch.tensor(0.0), torch.tensor(0.0))

    module.mcmc.hmc = hmc
    try:
        model.run_mcmc_training(data)
    finally:
        module.mcmc.hmc = real
    return seen


def _f64_dense_apply(p, x):
    return jnp.dot(x, p["w"]) + p["b"]


def targets(a, precision):
    """Both packages' targets per net in ``precision``: ``{net: (jax
    log_prob, port log_prob, init as numpy, hmc kwargs)}``."""
    jm, data, _ = ref.build(a)
    pm = tfm.FullMCMCCausalBGM(jm.params, random_seed=0, device="cpu")
    pm.load_weights(a.state)
    dt = NP_DTYPE[precision]
    # the unravel of the loaded nets, to leaves of this precision
    jm._unravel = {k: ravel_pytree(jax.tree.map(lambda t: jnp.asarray(t, dt), jm.nets[k]))[1]
                   for k in "ghf"}
    if precision == "f64":
        jnn.dense_apply = _f64_dense_apply
        pm._data = lambda d: tuple(torch.as_tensor(np.asarray(t, np.float64)) for t in d)
        pm.data_z = pm.data_z.double()
    j_seen, p_seen = _capture(jm, jfm, data), _capture(pm, tfm, data)
    out = {}
    for k, (j_lp, j_init, kw), (p_lp, p_init, p_kw) in zip("ghf", j_seen, p_seen):
        init = np.asarray(j_init)
        np.testing.assert_array_equal(p_init.numpy(), init)
        assert kw == p_kw, (kw, p_kw)
        out[k] = (j_lp, p_lp, init.astype(dt), kw)
    return out


def _logp_at(j_lp, p_lp, init, precision):
    j = float(j_lp(jnp.asarray(init), None)[0])
    p = float(p_lp(torch.as_tensor(init, dtype=TORCH_DTYPE[precision]), None)[0])
    return j, p


class _Injected:
    """While active, the momentum and the accept uniform that each
    package's ``_hmc_step`` draws are the given arrays, and the port's log
    accept ratio is kept in ``port_lar``.  JAX's step is traced once under
    it with the arrays as arguments."""

    def __init__(self):
        self.port_lar = None

    def jax_trace(self, mom, u):
        real_normal, real_uniform = jax.random.normal, jax.random.uniform
        real_jnp, box = jmcmc.jnp, {}

        class _Jnp:
            def __getattr__(self, name):
                return getattr(real_jnp, name)

            @staticmethod
            def minimum(x, y):  # the step-size rule's min(log accept ratio, 0)
                box["lar"] = x
                return real_jnp.minimum(x, y)

        jax.random.normal = lambda key, shape, dtype=None: mom
        jax.random.uniform = lambda key, shape=(), *args, **kw: u
        jmcmc.jnp = _Jnp()
        return real_normal, real_uniform, real_jnp, box

    @staticmethod
    def jax_restore(saved):
        jax.random.normal, jax.random.uniform, jmcmc.jnp, _ = saved

    def port(self, mom, u):
        inj = self
        real = (tmcmc._momentum, tmcmc._rand_rows, tmcmc._metropolis_accept)

        def accept(*args):
            out = real[2](*args)
            inj.port_lar = out[1]
            return out

        tmcmc._momentum = lambda state, g: mom
        tmcmc._rand_rows = lambda like, g: u.to(like.dtype)
        tmcmc._metropolis_accept = accept
        return real

    @staticmethod
    def port_restore(real):
        tmcmc._momentum, tmcmc._rand_rows, tmcmc._metropolis_accept = real


def run_net(name, j_lp, p_lp, init, kw, a, precision, log):
    """Step both packages' HMC over one net's weights; its summary line."""
    dt, tdt = NP_DTYPE[precision], TORCH_DTYPE[precision]
    burn_in, n_keep = a.hmc_burnin, a.hmc_samples
    n_adapt = int(burn_in * kw["adapt_fraction"])
    step_kw = dict(num_leapfrog=kw["num_leapfrog"], target_accept=0.75, n_adapt=n_adapt,
                   adaptation_rate=kw["adaptation_rate"])
    inj = _Injected()
    key = jax.random.PRNGKey(0)
    grad_fn = jax.grad(lambda s, k: jnp.sum(j_lp(s, k)))

    @jax.jit
    def j_step(carry, mom, u):
        saved = inj.jax_trace(mom, u)
        try:
            new, (acc, _) = jmcmc._hmc_step(carry, key, log_prob_fn=j_lp, grad_fn=grad_fn,
                                            **step_kw)
            return new, acc, saved[3]["lar"]
        finally:
            inj.jax_restore(saved)

    p_vg = partial(tmcmc._value_and_grad, p_lp)
    js = jnp.asarray(init)
    j_carry = (js, j_lp(js, key), jnp.asarray(kw["step_size"], jnp.float32),
               jnp.asarray(0, jnp.int32))
    ps = torch.as_tensor(init, dtype=tdt)
    p_logp, p_grad = p_vg(ps, None)
    p_carry = (ps, p_logp, p_grad, torch.tensor(kw["step_size"], dtype=torch.float32), 0)

    rng = np.random.default_rng(DRAW_SEED)
    partings, rel_max, acc = [], 0.0, {"jax": 0, "port": 0}
    t0, t = time.time(), -1
    for t in range(burn_in + n_keep):
        mom = rng.standard_normal(init.shape).astype(dt)
        u = np.float32(rng.random(init.shape[:1]))
        before = float(j_carry[2])
        j_carry, j_acc, j_lar = j_step(j_carry, jnp.asarray(mom), jnp.asarray(u, dt))
        real = inj.port(torch.as_tensor(mom), torch.as_tensor(u))
        try:
            p_carry, p_acc = tmcmc._hmc_step(p_carry, None, value_and_grad_fn=p_vg, **step_kw)
        finally:
            inj.port_restore(real)
        j_state = np.asarray(j_carry[0], np.float64)
        p_state = p_carry[0].double().numpy()
        diff = float(np.max(np.abs(p_state - j_state)))
        rel = diff / float(np.max(np.abs(j_state)))
        j_lar, p_lar = float(j_lar[0]), float(inj.port_lar[0])
        log_u = float(np.log(np.float64(u[0])))
        j_step_size, p_step_size = float(j_carry[2]), float(p_carry[3])
        ja, pa = bool(j_acc[0]), bool(p_acc[0])
        if t >= burn_in:
            acc["jax"] += ja
            acc["port"] += pa
        line = dict(net=name, t=t, max_abs_diff=diff, rel_diff=rel,
                    logp_jax=float(j_carry[1][0]), logp_port=float(p_carry[1][0]),
                    lar_jax=j_lar, lar_port=p_lar, log_u=log_u, accept_jax=ja,
                    accept_port=pa, step_jax=j_step_size, step_port=p_step_size)
        if log is not None:
            log.write(json.dumps(line) + "\n")
        parted = None
        if ja != pa:
            parted = dict(t=t, kind="accept",
                          margin=min(abs(j_lar - log_u), abs(p_lar - log_u)),
                          lar_jax=j_lar, lar_port=p_lar, log_u=log_u)
        elif j_step_size != p_step_size:
            probs = [min(np.exp(min(x, 0.0)), 1.0) for x in (j_lar, p_lar)]
            if (j_step_size > before) == (p_step_size > before):
                # one nudge, rounded to another float32
                parted = dict(t=t, kind="step_rounding",
                              margin=abs(p_step_size - j_step_size) / j_step_size)
            else:
                # the nudge went the other way: mean accept prob on either side of 0.75
                parted = dict(t=t, kind="step_size", margin=min(abs(q - 0.75) for q in probs))
            parted.update(accept_prob_jax=probs[0], accept_prob_port=probs[1],
                          step_jax=j_step_size, step_port=p_step_size)
        else:
            rel_max = max(rel_max, rel)
        if parted is not None:
            parted["rel_diff"] = rel
            partings.append(parted)
            if a.stop_at_parting:
                break
        if parted is not None or a.resync_each_step:
            # the port's chain continues from JAX's state
            ps = torch.as_tensor(np.asarray(j_carry[0]), dtype=tdt)
            p_logp, p_grad = p_vg(ps, None)
            p_carry = (ps, p_logp, p_grad, torch.tensor(float(j_carry[2]), dtype=torch.float32),
                       p_carry[4])
    first = partings[0] if partings else None
    return dict(stage="summary", net=name, precision=precision, steps=t + 1,
                burn_in=burn_in, n_keep=n_keep, n_weights=int(init.shape[-1]),
                first_parting=first, n_partings=len(partings),
                partings=[(p["t"], p["kind"], p["margin"]) for p in partings],
                max_rel_diff_agreeing=rel_max,
                accept_jax=acc["jax"] / max(n_keep, 1), accept_port=acc["port"] / max(n_keep, 1),
                step_jax=float(j_carry[2]), step_port=float(p_carry[3]),
                s=round(time.time() - t0, 1))


def main(argv=None):
    p = ref.make_parser()
    p.description = __doc__.split("\n\n")[0]
    p.add_argument("--precision", choices=["f32", "f64"], default="f32")
    p.add_argument("--log", default=None, help="JSON lines, one per step")
    p.add_argument("--stop_at_parting", action="store_true",
                   help="end each net's run at its first parting")
    p.add_argument("--resync_each_step", action="store_true",
                   help="start every step of the port from JAX's state")
    p.add_argument("--nets", nargs="+", default=list("ghf"), choices=list("ghf"))
    a = ref.parse(argv, p)
    if a.precision != PRECISION:
        raise SystemExit("--precision is read when the script starts")
    common = dict(state=a.state, seed=a.seed, draw_seed=DRAW_SEED,
                  protocol="flagship" if a.flagship else "binary_ate")
    if a.precision == "f64":
        real_dense = jnn.dense_apply
        f32 = targets(a, "f32")
        jnn.dense_apply = real_dense
        f64 = targets(a, "f64")
        for k in a.nets:
            j32, p32 = _logp_at(f32[k][0], f32[k][1], f32[k][2], "f32")
            j64, p64 = _logp_at(f64[k][0], f64[k][1], f64[k][2], "f64")
            print(json.dumps(dict(stage="rounding", net=k, logp_f32_jax=j32, logp_f64_jax=j64,
                                  logp_f32_port=p32, logp_f64_port=p64,
                                  err_f32_jax=abs(j32 - j64), err_f32_port=abs(p32 - p64),
                                  f64_port_minus_jax=p64 - j64, **common)), flush=True)
        nets = f64
    else:
        nets = targets(a, "f32")
    log = open(a.log, "w") if a.log else None
    try:
        for k in a.nets:
            j_lp, p_lp, init, kw = nets[k]
            print(json.dumps({**run_net(k, j_lp, p_lp, init, kw, a, a.precision, log),
                              **common}), flush=True)
    finally:
        if log is not None:
            log.close()


if __name__ == "__main__":
    main()
