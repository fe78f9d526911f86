"""The ported model: JAX weights through save_weights / the bridge, predict
from both packages on the same data (per step and with the MH window
kernel), MALA, the device contract, and that the port (fit, save_weights,
predict by MH, windowed MH and MALA, both kinds of nets) never imports
JAX."""

import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesgm_tpu.datasets import Sim_Hirano_Imbens_sampler  # noqa: E402
from bayesgm_tpu.models import causalbgm as jcb  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(tmp_path, **kw):
    p = dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="t",
             output_dir=str(tmp_path), save_res=False, g_units=[16, 16], e_units=[16],
             h_units=[8], f_units=[8], dz_units=[8])
    p.update(kw)
    return p


def _data(n=64, binary=False):
    x, y, v = Sim_Hirano_Imbens_sampler(batch_size=32, N=n, v_dim=6, seed=0).load_all()
    if binary:
        x = (x > np.median(x)).astype(np.float32)
    return x, y, v


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """A JAX CausalBGM (flipout nets, random init) saved with save_weights."""
    tmp = tmp_path_factory.mktemp("jaxw")
    model = jcb.CausalBGM(_params(tmp), random_seed=0)
    path = str(tmp / "w.npz")
    model.save_weights(path)
    return model, path


def test_load_npz_gives_every_tensor_of_the_jax_nets(jax_weights):
    jmodel, path = jax_weights
    bundle = bridge.load_npz(path)
    assert {"g", "h", "f", "e"} <= set(bundle["nets"])
    for k in ("g", "h", "f", "e"):
        jnet, tnet = jmodel.nets[k], bundle["nets"][k]
        np.testing.assert_array_equal(tnet.gamma.detach().numpy(), np.asarray(jnet["norm"]["gamma"]))
        np.testing.assert_array_equal(tnet.beta.detach().numpy(), np.asarray(jnet["norm"]["beta"]))
        for i, layer in enumerate(jnet["layers"]):
            for name in ("loc", "rho", "b"):
                np.testing.assert_array_equal(getattr(tnet, name)[i].detach().numpy(),
                                              np.asarray(layer[name]))


def test_load_weights_checks_dims(jax_weights, tmp_path):
    _, path = jax_weights
    model = tcb.CausalBGM(_params(tmp_path), random_seed=1, device="cpu").load_weights(path)
    assert model.nets["g"].dims == [5, 16, 16, 7]
    wrong = tcb.CausalBGM(_params(tmp_path, g_units=[8]), random_seed=1, device="cpu")
    with pytest.raises(ValueError, match="dims"):
        wrong.load_weights(path)


def test_predict_matches_jax_within_monte_carlo_error(jax_weights, tmp_path):
    """Same bridged weights, same data: each ADRF point within
    4 * sqrt(se_port^2 + se_jax^2), se = sd(draws) / sqrt(ESS)."""
    jmodel, path = jax_weights
    data = _data()
    kw = dict(x_values=np.linspace(0, 3, 5), alpha=0.05, burn_in=150, n_mcmc=300, q_sd=1.0,
              return_diagnostics=True, return_draws=True)
    adrf_j, ci_j, diag_j, draws_j = jmodel.predict(data, **kw)
    tmodel = tcb.CausalBGM(_params(tmp_path), random_seed=3, device="cpu").load_weights(path)
    adrf_t, ci_t, diag_t, draws_t = tmodel.predict(data, **kw)

    assert adrf_t.shape == adrf_j.shape == (5,)
    assert np.all(ci_t[:, 0] <= ci_t[:, 1])
    se = lambda draws, diag: draws.std(axis=1) / np.sqrt(diag["ess"])
    bound = 4.0 * np.sqrt(se(draws_t, diag_t) ** 2 + se(draws_j, diag_j) ** 2)
    assert np.all(np.abs(adrf_t - adrf_j) <= bound), (adrf_t, adrf_j, bound)
    assert abs(diag_t["accept_rate"] - diag_j["accept_rate"]) <= 0.05


def _count_calls(model, name):
    """Wrap ``model.kernels[name]`` to record the row count of every call."""
    calls, fused = [], model.kernels[name]
    model.kernels[name] = lambda *a: calls.append(a[0].shape[0]) or fused(*a)
    return calls, fused


def test_window_predict_matches_jax_within_monte_carlo_error(jax_weights, tmp_path):
    """params['mh_window_kernel']: the burn-in runs in K5 windows of 50 steps
    (on the CPU, K5's plain version through its wrapper: burn_in / 50 calls,
    no kernel launch), the kept steps stay paired K1.  The ADRF lies within
    Monte-Carlo error of JAX predict on the same bridged weights (JAX on the
    CPU runs per step), with the tolerance of the per-step predict test."""
    jmodel, path = jax_weights
    data = _data()
    kw = dict(x_values=np.linspace(0, 3, 5), alpha=0.05, burn_in=150, n_mcmc=300, q_sd=1.0,
              return_diagnostics=True, return_draws=True)
    adrf_j, _, diag_j, draws_j = jmodel.predict(data, **kw)
    tmodel = tcb.CausalBGM(_params(tmp_path, mh_window_kernel=True), random_seed=3,
                           device="cpu").load_weights(path)
    k5_calls, k5 = _count_calls(tmodel, "bnn_mh_window")
    k1_calls, _ = _count_calls(tmodel, "bnn_hosteps_paired")
    adrf_t, ci_t, diag_t, draws_t = tmodel.predict(data, **kw)
    assert k5_calls == [64] * 3 and k5.launches == 0 and k1_calls == [128] * 300
    assert np.all(ci_t[:, 0] <= ci_t[:, 1])
    se = lambda draws, diag: draws.std(axis=1) / np.sqrt(diag["ess"])
    bound = 4.0 * np.sqrt(se(draws_t, diag_t) ** 2 + se(draws_j, diag_j) ** 2)
    assert np.all(np.abs(adrf_t - adrf_j) <= bound), (adrf_t, adrf_j, bound)


@pytest.mark.parametrize("use_bnn,burn_in", [(True, 30), (False, 50)])
def test_window_flag_runs_per_step_where_jax_does(tmp_path, use_bnn, burn_in):
    """burn_in not a multiple of 50, or plain nets (no window kernel): the
    burn-in stays per step, as in the JAX package."""
    model = tcb.CausalBGM(_params(tmp_path, mh_window_kernel=True, use_bnn=use_bnn),
                          random_seed=0, device="cpu")
    name = "bnn_hosteps_paired" if use_bnn else "plain"
    calls, _ = _count_calls(model, name)
    if use_bnn:
        k5_calls, _ = _count_calls(model, "bnn_mh_window")
    adrf, ci = model.predict(_data(n=16), x_values=[0.5, 1.5], burn_in=burn_in, n_mcmc=10)
    assert np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])
    # paired K1 once per step; plain K4 once up front and once per step
    assert len(calls) == burn_in + 10 + (0 if use_bnn else 1)
    if use_bnn:
        assert k5_calls == []
    else:
        assert "bnn_mh_window" not in model.kernels


def test_antithetic_eps_predict(tmp_path):
    """params['antithetic_eps'] gives the paired halves eps_1 = -eps_0."""
    model = tcb.CausalBGM(_params(tmp_path, antithetic_eps=True), random_seed=0, device="cpu")
    adrf, ci = model.predict(_data(n=16), x_values=[0.5, 1.5], burn_in=10, n_mcmc=20)
    assert np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])


def test_binary_predict_shapes(tmp_path):
    model = tcb.CausalBGM(_params(tmp_path, binary_treatment=True), random_seed=0, device="cpu")
    data = _data(n=24, binary=True)
    ite, ci, diag = model.predict(data, burn_in=10, n_mcmc=20, return_diagnostics=True)
    assert ite.shape == (24,) and ci.shape == (24, 2) and np.all(ci[:, 0] <= ci[:, 1])
    assert diag["ess"].shape == (24,) and 0.0 <= diag["accept_rate"] <= 1.0


def test_cuda_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the constructor does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        tcb.CausalBGM(_params(tmp_path), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tcb.CausalBGM(_params(tmp_path))  # cuda is the default


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_unported_predict_options_raise(tmp_path, kw):
    model = tcb.CausalBGM(_params(tmp_path), random_seed=0, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):  # a mesh must be a parallel.Mesh
        model.predict(_data(n=8), x_values=[1.0], burn_in=1, n_mcmc=1, **kw)


def test_unknown_sampler_raises(tmp_path):
    model = tcb.CausalBGM(_params(tmp_path), random_seed=0, device="cpu")
    with pytest.raises(ValueError, match="sampler"):
        model.predict(_data(n=8), x_values=[1.0], burn_in=1, n_mcmc=1, sampler="hmc")


@pytest.mark.parametrize("binary", [False, True])
def test_bnn_mala_predict_through_k2_wrapper(tmp_path, binary):
    """BNN MALA on the kernel path: two K2 evaluations per step (both sides
    of the accept ratio with fresh noise, none cached), through K2's wrapper
    (its plain version on the CPU); finite effects, ordered intervals."""
    model = tcb.CausalBGM(_params(tmp_path, binary_treatment=binary, use_pallas_latent=True),
                          random_seed=0, device="cpu")
    calls = []
    fused = model.kernels["bnn_hosteps_grad"]
    model.kernels["bnn_hosteps_grad"] = lambda *a: calls.append(a[0].shape[0]) or fused(*a)
    data = _data(n=24, binary=binary)
    eff, ci, diag = model.predict(data, x_values=None if binary else [0.5, 1.5], burn_in=10,
                                  n_mcmc=15, sampler="mala", return_diagnostics=True)
    assert calls == [24] * 2 * 25 and fused.launches == 0
    assert eff.shape == ((24,) if binary else (2,)) and np.all(np.isfinite(eff))
    assert np.all(ci[:, 0] <= ci[:, 1]) and 0.0 < diag["accept_rate"] <= 1.0


def test_bnn_mala_predict_matches_jax_within_monte_carlo_error(jax_weights, tmp_path):
    """BNN MALA (fresh noise on both sides each step) from the same bridged
    weights lands within Monte-Carlo error of JAX's BNN MALA."""
    jmodel, path = jax_weights
    data = _data()
    kw = dict(x_values=np.linspace(0, 3, 5), alpha=0.05, burn_in=100, n_mcmc=200,
              sampler="mala", return_diagnostics=True, return_draws=True)
    adrf_j, _, diag_j, draws_j = jmodel.predict(data, **kw)
    tmodel = tcb.CausalBGM(_params(tmp_path), random_seed=3, device="cpu").load_weights(path)
    adrf_t, _, diag_t, draws_t = tmodel.predict(data, **kw)
    se = lambda draws, diag: draws.std(axis=1) / np.sqrt(diag["ess"])
    bound = 4.0 * np.sqrt(se(draws_t, diag_t) ** 2 + se(draws_j, diag_j) ** 2)
    assert np.all(np.abs(adrf_t - adrf_j) <= bound), (adrf_t, adrf_j, bound)


@pytest.mark.parametrize("bnn,binary,bs,n", [(True, False, None, 300), (True, True, None, 300),
                                             (True, False, 50, 300), (True, False, 500, 300),
                                             (False, False, None, 300), (False, True, None, 300),
                                             (False, False, 50, 300)])
def test_resolve_predict_bs_matches_jax(bnn, binary, bs, n):
    cfg = dict(v_dim=6, z_dims=(1, 1, 1, 2), binary_treatment=binary, use_bnn=bnn,
               kl_weight=1e-4, sigma_v=None, sigma_x=None, sigma_y=None, use_z_rec=1.0,
               lr=2e-4, lr_theta=1e-4, lr_z=1e-4, g_d_freq=5)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = jcb._resolve_predict_bs(jcb.CBGMConfig(**cfg), bs, n)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = tcb._resolve_predict_bs(tcb.CBGMConfig(**cfg), bs, n)
    assert got == want and len(wt) == len(wj)


def test_config_and_summary(tmp_path, capsys):
    model = tcb.CausalBGM(_params(tmp_path), random_seed=0, device="cpu")
    assert model.get_config()["params"]["v_dim"] == 6
    model.initialize_nets(print_summary=True)
    assert "g_net:" in capsys.readouterr().out
    assert set(model.kernels) == {"bnn_hosteps", "bnn_hosteps_paired", "bnn_hosteps_grad",
                                  "bnn_mh_window"}


def test_port_cpu_predict_never_imports_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import bayesgm_torch
        from bayesgm_torch import CausalBGM, Sim_Hirano_Imbens_sampler
        x, y, v = Sim_Hirano_Imbens_sampler(batch_size=32, N=32, v_dim=6, seed=0).load_all()
        m = CausalBGM(dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False,
                           dataset="t", output_dir={str(tmp_path)!r}, save_res=False,
                           g_units=[8], e_units=[8], h_units=[8], f_units=[8],
                           dz_units=[8], lr_decay="cosine"),
                      random_seed=0, device="cpu")
        m.fit((x, y, v), epochs=1, epochs_per_eval=1, batch_size=16, egm_n_iter=3,
              egm_batches_per_eval=2, verbose=0)
        m.save_weights({str(tmp_path / "w.npz")!r})
        adrf, ci = m.predict((x, y, v), x_values=[0.5, 1.0], burn_in=5, n_mcmc=5)
        assert adrf.shape == (2,)
        adrf, ci = m.predict((x, y, v), x_values=[0.5, 1.0], burn_in=5, n_mcmc=5,
                             sampler="mala")
        assert adrf.shape == (2,)
        m.params["mh_window_kernel"] = True
        adrf, ci = m.predict((x, y, v), x_values=[0.5, 1.0], burn_in=50, n_mcmc=5)
        assert adrf.shape == (2,)
        p = CausalBGM(dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False,
                           dataset="t", output_dir={str(tmp_path)!r}, save_res=False,
                           use_bnn=False, g_units=[8], e_units=[8], h_units=[8],
                           f_units=[8], dz_units=[8], use_pallas_latent=True),
                      random_seed=0, device="cpu")
        p.fit((x, y, v), epochs=1, epochs_per_eval=1, batch_size=16, egm_n_iter=3,
              egm_batches_per_eval=2, verbose=0)
        for sampler in ("mh", "mala"):
            adrf, ci = p.predict((x, y, v), x_values=[0.5, 1.0], burn_in=5, n_mcmc=5,
                                 sampler=sampler)
            assert adrf.shape == (2,)
        # the rest of the surface: checkpoints and the metrics log, DR and
        # ESS-gated predict, the sampler API, and the entry points' modules
        from bayesgm_torch import Sim_Colangelo_sampler, Sim_Sun_sampler, get_ADRF
        from bayesgm_torch import main as driver, parse_file_triplet
        from bayesgm_torch.cli import cli
        from bayesgm_torch.utils import config_io, profiling
        s = CausalBGM(dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False,
                           dataset="t", output_dir={str(tmp_path)!r}, save_res=False,
                           save_model=True, metrics_path={str(tmp_path / "m.jsonl")!r},
                           use_bnn=False, g_units=[8], e_units=[8], h_units=[8],
                           f_units=[8], dz_units=[8]), random_seed=0, device="cpu")
        s.fit((x, y, v), epochs=1, epochs_per_eval=1, batch_size=16, use_egm_init=False,
              verbose=0)
        for kw in (dict(estimator="dr"), dict(ess_target=5.0)):
            adrf, ci = s.predict((x, y, v), x_values=[0.5, 1.0], burn_in=5, n_mcmc=5, **kw)
        z = s.metropolis_hastings_sampler((x, y, v), burn_in=5, n_keep=3)
        assert s.infer_from_latent_posterior(z, x_values=[1.0]).shape == (1, 3)
        config_io.load("configs/Sim_Sun.yaml")
        Sim_Sun_sampler(N=8, v_dim=6).load_all(), Sim_Colangelo_sampler(N=8, v_dim=6)
        bad = [m for m in ("yaml", "pandas", "sklearn", "bayesgm_tpu") if m in sys.modules]
        print("OTHERS_IMPORTED", bad)
        print("JAX_IMPORTED", "jax" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_IMPORTED False" in out.stdout
    assert "OTHERS_IMPORTED []" in out.stdout


def test_effect_draws_are_chain_diagnosable(tmp_path):
    """The port's predict draws feed its own diagnostics (ESS in [1, n])."""
    model = tcb.CausalBGM(_params(tmp_path), random_seed=0, device="cpu")
    _, _, diag, draws = model.predict(_data(n=16), x_values=[0.0, 2.0], burn_in=10,
                                      n_mcmc=40, return_diagnostics=True, return_draws=True)
    assert draws.shape == (2, 40)
    ess = tmcmc.effective_sample_size(draws, axis=1)
    np.testing.assert_array_equal(ess, diag["ess"])
    assert np.all((ess >= 1) & (ess <= 40))
