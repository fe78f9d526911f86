"""The FullMCMC stage split's hand-over to the JAX package: the fitted state
that ``tools/fullmcmc_stage_split.py`` saves loads into JAX's
``FullMCMCCausalBGM.load_weights`` with the same log posterior under one
weight triple, and ``tests/_jax_fullmcmc_reference.py`` runs JAX's weight
HMC and predict from it end to end, with the port tool's stage keys and the
same HMC targets at the fitted weights; so does the flagship recipe
(``--flagship``), in float32 and with bf16 operands in every dense layer
(``--matmul bf16``)."""

import contextlib
import importlib.util
import io
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesgm_tpu.models import fullmcmc as jfm  # noqa: E402
from bayesgm_torch.benchmarks import binary_ate as ba  # noqa: E402
from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N, V_DIM, SEED = 120, 8, 789
TINY = ["--device", "cpu", "--n", str(N), "--v_dim", str(V_DIM), "--egm", "4", "--epochs", "1",
        "--n_mcmc", "6", "--burn_in", "6", "--seed", str(SEED)]
HMC_CUT = {"num_samples": 20, "num_burnin": 10}
# f32 sums over up to 120 rows x 8 columns in another order than XLA's
VAL_TOL = dict(rtol=1e-5, atol=1e-4)
B_KEYS = {"stage", "net", "hmc_s", "accept", "step_size", "loglik_fit", "loglik_mean",
          "loglik_first_half", "loglik_second_half", "loglik_ess", "loglik_rhat", "w_ess_min",
          "w_ess_median", "n_weights", "seed"}
C_KEYS = {"stage", "predict", "predict_seed", "n", "ate_true", "ate_est", "d_ate", "pehe",
          "ite_coverage", "iv_width_mean", "predict_s", "latent_accept", "latent_q_sd", "seed"}
FLAGSHIP_C_KEYS = {"stage", "predict", "predict_seed", "rmse", "mape", "iv_width_mean",
                   "coverage", "predict_s", "latent_accept", "latent_q_sd", "seed"}
FLAGSHIP_TINY = ["--flagship", "--device", "cpu", "--n", str(N), "--v_dim", str(V_DIM),
                 "--egm", "4", "--epochs", "1", "--n_mcmc", "6", "--burn_in", "6",
                 "--seed", str(SEED)]
# bf16 keeps 8 bits of each operand: the rounding of a dense layer's product
# is ~2e-3 of its size, and a log-likelihood over 120 x 8 entries moves by a
# few parts in a thousand
BF16_TOL = dict(rtol=2e-2)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _port_split(out, flags):
    """The port tool at a tiny size (weight HMC 10 + 20 steps a net), its
    weight samples saved: its JSON lines."""
    run = FullMCMCCausalBGM.run_mcmc_training
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FullMCMCCausalBGM, "run_mcmc_training",
                   lambda self, data, **kw: run(self, data, **{**HMC_CUT, **kw}))
        tool = _load("tools/fullmcmc_stage_split.py", "_tool_fullmcmc_stage_split")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tool.main(flags + ["--out", str(out), "--output_dir", str(out / "model"),
                               "--save_samples"])
    return _json_lines(buf.getvalue())


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """binary_ate's recipe through the port tool: ``(out folder, lines)``."""
    out = tmp_path_factory.mktemp("split")
    return out, _port_split(out, TINY)


@pytest.fixture(scope="module")
def flagship_split(tmp_path_factory):
    """The flagship recipe through the port tool: ``(out folder, lines)``."""
    out = tmp_path_factory.mktemp("flagship_split")
    return out, _port_split(out, FLAGSHIP_TINY)


def test_saved_state_loads_into_jax_with_the_same_log_posterior(split, tmp_path):
    out, _ = split
    x, y, v, _ = ba.make_data(n=N, v_dim=V_DIM)
    params = dict(v_dim=V_DIM, z_dims=[3, 6, 3, 6], binary_treatment=True, dataset="binary_ate",
                  output_dir=str(tmp_path), use_bnn=True, save_res=False, save_model=False)
    jmodel = jfm.FullMCMCCausalBGM(params, random_seed=0).load_weights(str(out / "fitted.npz"))
    pmodel = FullMCMCCausalBGM(params, random_seed=1, device="cpu").load_weights(
        str(out / "fitted.npz"))
    np.testing.assert_array_equal(np.asarray(jmodel.data_z), pmodel.data_z.numpy())
    with np.load(out / "samples.npz") as f:
        triple = [np.asarray(f[k][-1]) for k in "ghf"]
    assert [t.shape[0] for t in triple] == [
        sum(p.numel() for p in pmodel.nets[k].parameters()) for k in "ghf"]
    want = np.asarray(jmodel.get_log_posterior(x, y, v, jmodel.data_z, *triple))
    got = pmodel.get_log_posterior(x, y, v, pmodel.data_z, *triple).numpy()
    assert want.shape == got.shape == (N,)
    np.testing.assert_allclose(got, want, **VAL_TOL)


def test_jax_reference_runs_from_the_saved_state(split, capsys):
    out, port_lines = split
    ref = _load("tests/_jax_fullmcmc_reference.py", "_jax_fullmcmc_reference")
    sizes = ["--seed", str(SEED), "--n", str(N), "--v_dim", str(V_DIM), "--n_mcmc", "6",
             "--burn_in", "6", "--state", str(out / "fitted.npz")]
    ref.main(sizes + ["--hmc_samples", "20", "--hmc_burnin", "10"])
    lines = _json_lines(capsys.readouterr().out)
    ref.main(sizes + ["--samples", str(out / "samples.npz")])
    from_samples = _json_lines(capsys.readouterr().out)
    assert [(line["stage"], line.get("net"), line.get("predict")) for line in lines] == [
        ("B", "g", None), ("B", "h", None), ("B", "f", None), ("C", None, 1), ("C", None, 2)]
    assert [line["predict"] for line in from_samples] == [1, 2]
    port_b = [line for line in port_lines if line["stage"] == "B"]
    port_c = [line for line in port_lines if line["stage"] == "C"]
    for jax_line, port_line in zip(lines[:3], port_b):
        assert B_KEYS <= set(jax_line) and B_KEYS <= set(port_line)
        # the same HMC target at the same fitted weights
        np.testing.assert_allclose(jax_line["loglik_fit"], port_line["loglik_fit"], rtol=1e-5)
        assert jax_line["n_weights"] == port_line["n_weights"]
        assert 0.0 <= jax_line["accept"] <= 1.0
    for line in lines[3:] + from_samples + port_c:
        assert C_KEYS <= set(line)
        assert 0.0 < line["latent_accept"] < 1.0 and np.isfinite(line["d_ate"])
        assert line["ate_true"] == port_c[0]["ate_true"]


@pytest.mark.parametrize("matmul", ["f32", "bf16"])
def test_jax_reference_runs_the_flagship_from_the_saved_state(flagship_split, capsys, matmul,
                                                               tmp_path):
    """``--flagship``: the stage-C lines hold the flagship runner's scores;
    the HMC targets at the fitted weights are the port's (float32), or
    round as bf16 operands do (``--matmul bf16``), and the samples land in
    ``--save_samples``; the dense layer is JAX's own again afterwards."""
    out, port_lines = flagship_split
    ref = _load("tests/_jax_fullmcmc_reference.py", "_jax_fullmcmc_reference")
    dense = ref.nn.dense_apply
    ref.main(["--flagship", "--seed", str(SEED), "--n", str(N), "--v_dim", str(V_DIM),
              "--n_mcmc", "6", "--burn_in", "6", "--state", str(out / "fitted.npz"),
              "--hmc_samples", "20", "--hmc_burnin", "10", "--matmul", matmul,
              "--predicts", "1", "--save_samples", str(tmp_path)])
    assert ref.nn.dense_apply is dense
    lines = _json_lines(capsys.readouterr().out)
    assert [(line["stage"], line.get("net"), line.get("predict")) for line in lines] == [
        ("B", "g", None), ("B", "h", None), ("B", "f", None), ("C", None, 1)]
    port_b = [line for line in port_lines if line["stage"] == "B"]
    port_c = [line for line in port_lines if line["stage"] == "C"]
    assert len(port_b) == 3 and len(port_c) == 2
    for line in lines + port_c:
        assert line.get("matmul", "f32") in ("f32", matmul)
    for jax_line, port_line in zip(lines[:3], port_b):
        assert B_KEYS <= set(jax_line)
        assert jax_line["n_weights"] == port_line["n_weights"]
        if matmul == "f32":
            np.testing.assert_allclose(jax_line["loglik_fit"], port_line["loglik_fit"],
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(jax_line["loglik_fit"], port_line["loglik_fit"],
                                       **BF16_TOL)
            assert jax_line["loglik_fit"] != port_line["loglik_fit"]
    for line in lines[3:] + port_c:
        assert FLAGSHIP_C_KEYS <= set(line)
        assert np.isfinite(line["rmse"]) and line["iv_width_mean"] > 0
        assert 0.0 <= line["coverage"] <= 1.0 and 0.0 < line["latent_accept"] < 1.0
    with np.load(tmp_path / "samples.npz") as f:
        assert [f[k].shape for k in "ghf"] == [(20, line["n_weights"]) for line in port_b]


def test_stage_split_tool_imports_no_jax(tmp_path):
    code = textwrap.dedent(f"""
        import importlib.util, sys
        for name in ("jax", "jaxlib", "bayesgm_tpu"):
            sys.modules[name] = None  # any import of them raises
        spec = importlib.util.spec_from_file_location(
            "split", {str(REPO / "tools" / "fullmcmc_stage_split.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print("IMPORTED", sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib", "bayesgm_tpu")
                                 and sys.modules[m] is not None))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout
