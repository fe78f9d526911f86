"""The gate runners: ``bayesgm_torch.benchmarks.binary_ate``,
``sun_colangelo_ivae`` and ``mnist_inpaint`` against the JAX runners of the
same names in ``benchmarks/``.

(a) Both packages' runners drive recorder stubs patched over the model
classes (and the samplers); the constructor's ``params`` and
``random_seed`` and every call's arguments and data must be equal, and so
must the printed metrics.  (b) The data generators are bit-equal to the
JAX runners'.  (c) Tiny end-to-end runs on the CPU print JAX's keys.  (d)
The runners import neither ``jax`` nor ``bayesgm_tpu``.  (e) ``--device
cuda`` raises where CUDA is absent.  (f) A binary_ate run done twice on
one ``--state_dir`` resumes the fit bit for bit, and an ensemble whose
members were fitted apart resumes them and predicts as one run."""

import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bayesgm_tpu.datasets as jax_datasets  # noqa: E402
import bayesgm_tpu.models.causalbgm as jax_causalbgm  # noqa: E402
import bayesgm_tpu.models.ensemble as jax_ensemble  # noqa: E402
import bayesgm_tpu.models.fullmcmc as jax_fullmcmc  # noqa: E402
import bayesgm_tpu.models.identifiable as jax_identifiable  # noqa: E402
import bayesgm_tpu.models.mnist as jax_mnist  # noqa: E402

from bayesgm_torch.benchmarks import binary_ate as ba  # noqa: E402
from bayesgm_torch.benchmarks import mnist_inpaint as mi  # noqa: E402
from bayesgm_torch.benchmarks import sun_colangelo_ivae as sc  # noqa: E402
from bayesgm_torch.datasets.images import make_ellipse_images  # noqa: E402
from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TIMES = ("fit_s", "predict_s")
BINARY_TINY = ["--device", "cpu", "--n", "120", "--v_dim", "8", "--egm", "4", "--epochs", "1",
               "--n_mcmc", "6", "--burn_in", "6"]
SUN_TINY = ["--device", "cpu", "--n", "120", "--egm", "4", "--epochs", "1", "--n_mcmc", "6",
            "--burn_in", "6"]
MNIST_TINY = ["--device", "cpu", "--n", "32", "--n_test", "4", "--egm", "2", "--epochs", "1",
              "--n_mcmc", "3", "--burn_in", "3"]
BINARY_KEYS = {"n", "engine", "seed", "data_seed", "ate_true", "ate_est", "d_ate", "pehe",
               "ite_coverage", "fit_s", "predict_s", "bars"}
MNIST_KEYS = {"inpaint_l1", "inpaint_accuracy", "majority_baseline", "mse_reconstruction",
              "fit_s", "predict_s"}


def _jax_runner(name):
    path = REPO / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(a):
    return tuple(_host(b) for b in a) if isinstance(a, tuple) else np.asarray(a)


def _recorder(calls, kind):
    """A model class that records its constructor and calls into ``calls``
    and returns outputs of the right shapes, computed from the data."""

    class Recorder:
        def __init__(self, params, timestamp=None, random_seed=None, device=None):
            calls.append(("init", dict(params), random_seed))

        def _record(self, name, data, kwargs):
            calls.append((name, _host(data), dict(kwargs)))

        def fit(self, data, **kwargs):
            self._record("fit", data, kwargs)

        def run_mcmc_training(self, data, **kwargs):
            self._record("run_mcmc_training", data, kwargs)

        def evaluate(self, data, **kwargs):
            self._record("evaluate", data, kwargs)
            return 0.00125

        def predict(self, data, **kwargs):
            self._record("predict", data, kwargs)
            if kind == "mnist":  # the upper half mirrored into the lower
                return np.where(np.isnan(data), np.nan_to_num(data[:, ::-1]), data), None
            if kind == "binary":
                _, y, v = data
                ite = 1.0 + 0.45 * np.sin(v[:, 0]) + 0.05 * np.tanh(y[:, 0])
                half = 0.02 + 0.05 * np.abs(np.cos(v[:, 1]))
                return ite, np.stack([ite - half, ite + half], 1)
            grid = np.asarray(kwargs["x_values"])
            adrf = 1.1 * grid + 0.4 + 0.02 * np.sin(5 * grid)
            return adrf, np.stack([adrf - 0.05, adrf + 0.05], 1)

    return Recorder


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    return a == b


def _assert_same_calls(jax_calls, port_calls):
    assert [c[0] for c in port_calls] == [c[0] for c in jax_calls]
    for want, got in zip(jax_calls, port_calls):
        assert _same(want, got), (want[0], want[1:], got[1:])


def _assert_same_metrics(want, got, skip=TIMES):
    assert set(want) <= set(got)
    for k in set(want) - set(skip):
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-12), k
        else:
            assert want[k] == got[k], k


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _scratch_in_tmp(monkeypatch):
    # The port's scratch folders are the temporary directory's (where the
    # JAX runners name /tmp); with state_dir unset neither runner writes there.
    monkeypatch.setattr(tempfile, "tempdir", "/tmp")


BINARY_CASES = {
    "base": ["--seed", "456"],
    "identifiable": ["--engine", "identifiable", "--seed", "123"],
    "identifiable_alias": ["--identifiable"],
    "fullmcmc": ["--engine", "fullmcmc", "--seed", "789"],
    "ensemble": ["--engine", "ensemble", "--n_members", "2"],
    "quick": ["--quick", "--data_seed", "11"],
}


@pytest.mark.parametrize("case", list(BINARY_CASES))
def test_binary_ate_recipe_is_the_jax_runners(monkeypatch, capsys, case):
    flags = BINARY_CASES[case]
    jax_calls, port_calls = [], []
    jax_cls = _recorder(jax_calls, "binary")
    for mod, name in ((jax_causalbgm, "CausalBGM"), (jax_ensemble, "EnsembleCausalBGM"),
                      (jax_fullmcmc, "FullMCMCCausalBGM"),
                      (jax_identifiable, "IdentifiableCausalBGM")):
        monkeypatch.setattr(mod, name, jax_cls)
    port_cls = _recorder(port_calls, "binary")
    for name in ("CausalBGM", "EnsembleCausalBGM", "FullMCMCCausalBGM", "IdentifiableCausalBGM"):
        monkeypatch.setattr(ba, name, port_cls)
    monkeypatch.delenv("BAYESGM_FORCE_CPU", raising=False)

    monkeypatch.setattr(sys, "argv", ["binary_ate.py", *flags])
    _jax_runner("binary_ate").main()
    jax_out = capsys.readouterr().out
    _scratch_in_tmp(monkeypatch)
    ba.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out

    names = ["init", "fit", "predict"]
    if case == "fullmcmc":
        names.insert(2, "run_mcmc_training")
    assert [c[0] for c in jax_calls] == names
    _assert_same_calls(jax_calls, port_calls)
    init = port_calls[0][1]
    assert init["use_bnn"] is (case != "quick")
    assert ("n_members" in init) is (case == "ensemble")
    (want,), (got,) = _json_lines(jax_out), _json_lines(port_out)
    assert 0.0 < want["ite_coverage"] < 1.0 and want["d_ate"] > 0
    _assert_same_metrics(want, got)
    assert got["iv_width_mean"] > 0 and got["launches_fit"] == {} == got["launches_predict"]


def _recording_sampler(calls, cls):
    def make(**kwargs):
        calls.append((cls.__name__, kwargs))
        return cls(**kwargs)
    return make


@pytest.mark.parametrize("processes", [1, 2])
def test_sun_colangelo_ivae_recipe_is_the_jax_runners(monkeypatch, capsys, processes):
    """JAX's file runs both recipes at import: it is loaded with its
    samplers and its class patched; the port runs both in one process or
    one per process (``--runs``)."""
    jax_calls, port_calls, jax_data, port_data = [], [], [], []
    monkeypatch.setattr(jax_identifiable, "IdentifiableCausalBGM", _recorder(jax_calls, "adrf"))
    for name in ("Sim_Sun_sampler", "Sim_Colangelo_sampler"):
        monkeypatch.setattr(jax_datasets, name,
                            _recording_sampler(jax_data, getattr(jax_datasets, name)))
    monkeypatch.setattr(sc, "IdentifiableCausalBGM", _recorder(port_calls, "adrf"))
    monkeypatch.setattr(sc, "RUNS", {k: (_recording_sampler(port_data, v[0]), *v[1:])
                                     for k, v in sc.RUNS.items()})
    _jax_runner("sun_colangelo_ivae")
    jax_out = capsys.readouterr().out
    _scratch_in_tmp(monkeypatch)
    if processes == 1:
        sc.main(["--device", "cpu"])
    else:
        for run in ("SUN", "COLANGELO"):
            sc.main(["--device", "cpu", "--runs", run])
    port_out = capsys.readouterr().out

    assert jax_data == [("Sim_Sun_sampler", {"N": 20000, "v_dim": 200}),
                        ("Sim_Colangelo_sampler", {"N": 20000, "v_dim": 100})]
    assert port_data == jax_data
    assert [c[0] for c in jax_calls] == ["init", "fit", "predict"] * 2
    _assert_same_calls(jax_calls, port_calls)

    def results(text):
        return [re.sub(r" \(fit .*", "", line) for line in text.splitlines()
                if line.startswith("RESULT ")]

    assert results(jax_out) == results(port_out)
    assert len(results(jax_out)) == 2
    lines = _json_lines(port_out)
    assert [line["run"] for line in lines] == ["SUN", "COLANGELO"]
    for result, line in zip(results(jax_out), lines):
        rmse, mape = map(float, re.findall(r"RMSE (\S+) MAPE (\S+)", result)[0])
        assert round(line["rmse"], 4) == rmse and round(line["mape"], 4) == mape
        assert 0.0 <= line["coverage"] < 1.0 and line["iv_width_mean"] == pytest.approx(0.1)


@pytest.mark.parametrize("flags", [[], ["--lr_decay", "cosine", "--seed", "7"]],
                         ids=["defaults", "cosine"])
def test_mnist_inpaint_recipe_is_the_jax_runners(monkeypatch, capsys, flags):
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_mnist, "MNISTBGM", _recorder(jax_calls, "mnist"))
    monkeypatch.setattr(mi, "MNISTBGM", _recorder(port_calls, "mnist"))
    monkeypatch.setattr(sys, "argv", ["mnist_inpaint.py", *flags])
    _jax_runner("mnist_inpaint").main()
    jax_out = capsys.readouterr().out
    _scratch_in_tmp(monkeypatch)
    mi.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out

    assert [c[0] for c in jax_calls] == ["init", "fit", "evaluate", "predict"]
    _assert_same_calls(jax_calls, port_calls)
    assert jax_calls[2][1].shape == (2048, 28, 28, 1)
    masked = port_calls[3][1]
    assert masked.shape == (64, 28, 28, 1) and np.isnan(masked[:, 14:]).all()
    assert not np.isnan(masked[:, :14]).any()
    (want,), (got,) = _json_lines(jax_out), _json_lines(port_out)
    assert 0.5 < want["inpaint_accuracy"] < 1.0
    _assert_same_metrics(want, got)


@pytest.mark.parametrize("n,v_dim,data_seed", [(10000, 100, 7), (257, 12, 11)])
def test_make_data_is_the_jax_runners(n, v_dim, data_seed):
    want = _jax_runner("binary_ate").make_data(n=n, v_dim=v_dim, data_seed=data_seed)
    got = ba.make_data(n=n, v_dim=v_dim, data_seed=data_seed)
    for name, a, b in zip(("x", "y", "v", "tau"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("n,seed", [(300, 42), (17, 0)])
def test_make_ellipse_images_is_the_jax_runners(n, seed):
    want = _jax_runner("mnist_inpaint").make_ellipse_images(n, seed=seed)
    got = make_ellipse_images(n, seed=seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, 28, 28, 1)
    np.testing.assert_array_equal(got, want)


def test_binary_ate_tiny_run_prints_jax_keys(capsys, tmp_path):
    ba.main(BINARY_TINY + ["--output_dir", str(tmp_path)])
    (line,) = _json_lines(capsys.readouterr().out)
    assert BINARY_KEYS <= set(line) and "card" not in line
    assert line["n"] == 120 and line["engine"] == "base"
    assert np.isfinite(line["pehe"]) and 0.0 <= line["ite_coverage"] <= 1.0
    assert line["iv_width_mean"] > 0 and line["egm_s"] > 0
    assert set(line["launches_fit"]) == {"bnn_hosteps", "bnn_hosteps_paired",
                                         "bnn_hosteps_grad", "bnn_mh_window"}


def test_sun_colangelo_ivae_tiny_run_prints_both_runs(capsys):
    sc.main(SUN_TINY)
    out = capsys.readouterr().out
    assert [line.split()[1] for line in out.splitlines() if line.startswith("RESULT ")] == \
        ["SUN", "COLANGELO"]
    lines = _json_lines(out)
    assert [line["run"] for line in lines] == ["SUN", "COLANGELO"]
    for line in lines:
        assert np.isfinite(line["rmse"]) and 0.0 <= line["coverage"] <= 1.0
        assert line["iv_width_mean"] > 0 and line["egm_s"] > 0 and "card" not in line
        assert not any(line["launches_fit"].values())
        assert not any(line["launches_predict"].values())


def test_mnist_inpaint_tiny_run_prints_jax_keys(capsys):
    mi.main(MNIST_TINY)
    (line,) = _json_lines(capsys.readouterr().out)
    assert MNIST_KEYS <= set(line) and "card" not in line
    assert 0.0 <= line["inpaint_accuracy"] <= 1.0 and np.isfinite(line["inpaint_l1"])
    assert 0.5 <= line["majority_baseline"] <= 1.0 and line["mse_reconstruction"] > 0


def test_binary_ate_state_dir_resumes_bit_for_bit(capsys, tmp_path):
    """A second run on the same ``--state_dir`` restores the last eval
    epoch's full state, trains on from there without the EGM and predicts
    what the first, uninterrupted run predicted."""
    flags = BINARY_TINY + ["--seed", "5", "--state_dir", str(tmp_path / "state")]
    ba.main(flags)
    first, = _json_lines(capsys.readouterr().out)
    ckpt_dir = tmp_path / "state" / "checkpoints" / "binary_ate" / "base_seed5"
    assert [p.name for p in ckpt_dir.glob("ckpt-*.npz")] == ["ckpt-0.npz"]
    ba.main(flags)
    out = capsys.readouterr().out
    second, = _json_lines(out)
    assert "Resuming training from checkpoint at epoch 0." in out
    assert "egm_s" in first and "egm_s" not in second
    for k in ("ate_est", "d_ate", "pehe", "ite_coverage", "iv_width_mean"):
        assert first[k] == second[k], k
    records = [json.loads(line) for line in
               (tmp_path / "state" / "metrics_base_seed5.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0]


def test_binary_ate_fullmcmc_counts_the_weight_hmc_apart(capsys, tmp_path):
    ba.main(BINARY_TINY + ["--engine", "fullmcmc", "--output_dir", str(tmp_path)])
    (line,) = _json_lines(capsys.readouterr().out)
    assert line["engine"] == "fullmcmc" and np.isfinite(line["pehe"])
    assert set(line["launches_fit"]) == set(line["launches_hmc"]) == \
        set(line["launches_predict"]) == {"plain", "plain_grad"}


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fullmcmc_stage_split_ends_with_binary_ates_line(monkeypatch, capsys, tmp_path):
    """The stage split sees the runner's generator sequence (fit, weight
    HMC, predict): its first stage-C line is ``binary_ate --engine
    fullmcmc``'s line, key for key, at the same seed (times aside); the
    weight HMC is cut to 10 + 20 steps a net in both."""
    run = FullMCMCCausalBGM.run_mcmc_training
    monkeypatch.setattr(FullMCMCCausalBGM, "run_mcmc_training", lambda self, data, **kw: run(
        self, data, **{"num_samples": 20, "num_burnin": 10, **kw}))
    flags = BINARY_TINY + ["--seed", "789"]
    ba.main(flags + ["--engine", "fullmcmc", "--output_dir", str(tmp_path / "runner")])
    (want,) = _json_lines(capsys.readouterr().out)
    _load_tool("fullmcmc_stage_split").main(
        flags + ["--out", str(tmp_path / "split"), "--output_dir", str(tmp_path / "tool")])
    lines = _json_lines(capsys.readouterr().out)
    assert [(line["stage"], line.get("net"), line.get("predict")) for line in lines] == [
        ("fit", None, None), ("B", "g", None), ("B", "h", None), ("B", "f", None),
        ("C", None, 1), ("C", None, 2), ("A", None, None)]
    first = lines[4]
    _assert_same_metrics(want, first, skip=TIMES + ("egm_s",))
    assert set(want) - set(TIMES) - {"egm_s"} <= set(first)
    assert first["launches_hmc"] == want["launches_hmc"] == {"plain": 0, "plain_grad": 0}
    assert (tmp_path / "split" / "fitted.npz").exists()
    for line in lines[1:4]:
        assert 0.0 <= line["accept"] <= 1.0 and line["step_size"] > 0
        assert np.isfinite(line["loglik_fit"]) and line["w_ess_min"] >= 1.0
    for line in lines[4:]:
        assert 0.0 < line["latent_accept"] < 1.0 and np.isfinite(line["d_ate"])


def test_binary_ate_ensemble_members_fit_apart_then_resume(capsys, tmp_path):
    """Each member fitted alone (``--member``) into one state folder, then
    the ensemble command on that folder: every member resumes after its
    last epoch (no EGM, no step, no kernel launch in fit) and the ensemble
    predicts what an uninterrupted ensemble run predicts, bit for bit."""
    flags = BINARY_TINY + ["--engine", "ensemble", "--n_members", "2", "--seed", "5",
                           "--epochs", "0"]  # the last epoch is an eval epoch, as at 100
    ba.main(flags + ["--state_dir", str(tmp_path / "whole")])
    whole, = _json_lines(capsys.readouterr().out)
    apart = flags + ["--state_dir", str(tmp_path / "apart")]
    members = []
    for i in (1, 0):
        ba.main(apart + ["--member", str(i)])
        members += _json_lines(capsys.readouterr().out)
    assert [(m["member"], m["engine"], "egm_s" in m) for m in members] == \
        [(1, "ensemble", True), (0, "ensemble", True)]
    ba.main(apart)
    out = capsys.readouterr().out
    resumed, = _json_lines(out)
    assert out.count("Resuming training from checkpoint at epoch 0.") == 2
    assert "EGM Initialization Starts" not in out
    for k in ("ate_est", "d_ate", "pehe", "ite_coverage", "iv_width_mean"):
        assert resumed[k] == whole[k], k
    assert not any(resumed["launches_fit"].values())
    assert [m["fit"] for m in resumed["launches_members"]] == [
        {k: 0 for k in whole["launches_fit"]}] * 2
    assert [m["predict"] for m in resumed["launches_members"]] == \
        [m["predict"] for m in whole["launches_members"]]
    assert [m["launches_fit"] for m in members[::-1]] == \
        [m["fit"] for m in whole["launches_members"]]
    with pytest.raises(SystemExit):
        ba.main(BINARY_TINY + ["--member", "0", "--state_dir", str(tmp_path / "base")])


RUNNERS = {"binary_ate": BINARY_TINY, "sun_colangelo_ivae": SUN_TINY + ["--runs", "SUN"],
           "mnist_inpaint": MNIST_TINY}


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_runner_imports_no_jax(runner, tmp_path):
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "bayesgm_tpu"):
            sys.modules[name] = None  # any import of them raises
        import torch
        torch.set_num_threads(2)
        from bayesgm_torch.benchmarks import {runner}
        {runner}.main({RUNNERS[runner]!r})
        print("IMPORTED", sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib", "bayesgm_tpu")
                                 and sys.modules[m] is not None))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout
    assert len(_json_lines(out.stdout)) == 1


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_runner_cuda_without_cuda_raises(runner):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    mod = {"binary_ate": ba, "sun_colangelo_ivae": sc, "mnist_inpaint": mi}[runner]
    argv = list(RUNNERS[runner])
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv)
