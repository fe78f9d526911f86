"""The accuracy protocols' runners: ``bayesgm_torch.benchmarks.hi_protocol``
and ``bgm_impute`` against the JAX runners ``benchmarks/hi_protocol.py``
and ``benchmarks/bgm_impute.py``.

(a) Both packages' runners drive a recorder stub patched over the model
class; the constructor's ``params`` and ``random_seed`` and every call's
arguments and data must be equal, and so must the printed results.
(b) Tiny end-to-end runs on the CPU print JAX's keys and the summary.
(c) The runners import neither ``jax`` nor ``bayesgm_tpu``.  (d) ``--device
cuda`` raises where CUDA is absent.  A runner run twice on one
``--state_dir`` resumes the fit bit for bit."""

import importlib.util
import json
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bayesgm_tpu.models.bgm as jax_bgm  # noqa: E402
import bayesgm_tpu.models.causalbgm as jax_causalbgm  # noqa: E402
import bayesgm_tpu.models.ensemble as jax_ensemble  # noqa: E402
import bayesgm_tpu.models.fullmcmc as jax_fullmcmc  # noqa: E402
import bayesgm_tpu.models.identifiable as jax_identifiable  # noqa: E402

from bayesgm_torch.benchmarks import bgm_impute as bi  # noqa: E402
from bayesgm_torch.benchmarks import hi_protocol as hp  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
JAX_KEYS = {"seed", "best_epoch", "fit_s", "rmse", "mape", "iv_width_mean", "coverage",
            "predict_s"}
TIMES = ("fit_s", "predict_s")
HI_TINY = ["--device", "cpu", "--n", "200", "--v_dim", "10", "--z_dims", "1", "1", "1", "2",
           "--egm", "10", "--epochs", "1", "--n_mcmc", "10", "--burn_in", "10"]
BGM_TINY = ["--device", "cpu", "--n", "300", "--n_test", "50", "--egm", "10", "--epochs", "1",
            "--n_mcmc", "10", "--burn_in", "10", "--bs", "50"]


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
    and returns outputs of the right shapes."""

    class Recorder:
        def __init__(self, params, timestamp=None, random_seed=None, device=None):
            calls.append(("init", dict(params), random_seed))
            self.best_epoch = 7

        def _record(self, name, data, kwargs):
            calls.append((name, _host(data), dict(kwargs)))

        def fit(self, data, **kwargs):
            self._record("fit", data, kwargs)

        def run_mcmc_training(self, data, **kwargs):
            self._record("run_mcmc_training", data, kwargs)

        def evaluate(self, data, **kwargs):
            self._record("evaluate", data, kwargs)
            return 0.25

        def predict(self, data, **kwargs):
            self._record("predict", data, kwargs)
            if kind == "bgm":
                n = data.shape[0]
                iv = np.stack([np.full(n, -0.5), np.full(n, 0.5)], 1)[:, None, :]
                imputed = np.nan_to_num(data)
                imputed[:, 0] = 0.5 * data[:, 1]  # a column the runner scores against the truth
                return imputed, iv
            grid = np.asarray(kwargs["x_values"])
            adrf = grid + 2.0 / (1.0 + grid) ** 3 + 0.01 * np.sin(7 * grid)
            scale = 0.02 if kwargs.get("use_swa_nets") else 0.01
            return adrf, np.stack([adrf - scale, adrf + scale], 1)

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


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _summary(text):
    lines = [line for line in text.splitlines() if line.startswith("SUMMARY ")]
    assert len(lines) == 1, text
    return json.loads(lines[0][len("SUMMARY "):])


HI_CASES = {
    "defaults": ["--seeds", "123", "456"],
    "cosine": ["--seeds", "123", "--lr_decay", "cosine"],
    "identifiable": ["--seeds", "123", "--identifiable"],
    "fullmcmc": ["--seeds", "123", "--fullmcmc"],
    "ensemble2": ["--seeds", "123", "--ensemble", "2"],
    "best_swa_curves": ["--seeds", "123", "--lr_decay", "cosine", "--also_best", "--also_swa"],
}


@pytest.mark.parametrize("case", list(HI_CASES))
def test_hi_protocol_recipe_is_the_jax_runners(monkeypatch, capsys, tmp_path, case):
    flags = HI_CASES[case] + ["--output_dir", str(tmp_path / "out")]
    if case == "best_swa_curves":
        flags += ["--dump_curves", str(tmp_path / "curves")]
    jax_calls, port_calls = [], []
    jax_cls = _recorder(jax_calls, "causal")
    for mod, name in ((jax_causalbgm, "CausalBGM"), (jax_ensemble, "EnsembleCausalBGM"),
                      (jax_fullmcmc, "FullMCMCCausalBGM"),
                      (jax_identifiable, "IdentifiableCausalBGM")):
        monkeypatch.setattr(mod, name, jax_cls)
    port_cls = _recorder(port_calls, "causal")
    for name in ("CausalBGM", "EnsembleCausalBGM", "FullMCMCCausalBGM", "IdentifiableCausalBGM"):
        monkeypatch.setattr(hp, name, port_cls)

    monkeypatch.setattr(sys, "argv", ["hi_protocol.py", *flags])
    _jax_runner("hi_protocol").main()
    jax_out = capsys.readouterr().out
    if case == "best_swa_curves":
        jax_curves = dict(np.load(tmp_path / "curves" / "curves_seed123.npz"))
    hp.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out

    assert [c[0] for c in jax_calls] == [c[0] for c in port_calls]
    assert jax_calls[0][0] == "init" and len(jax_calls) >= 3
    for want, got in zip(jax_calls, port_calls):
        assert _same(want, got), (want[0], want[1:], got[1:])
    jax_lines, port_lines = _json_lines(jax_out), _json_lines(port_out)
    assert len(jax_lines) == len(port_lines) == (2 if case == "defaults" else 1)
    for want, got in zip(jax_lines, port_lines):
        assert set(want) - set(TIMES) <= set(got)
        for k in set(want) - set(TIMES):
            assert want[k] == pytest.approx(got[k], rel=1e-6, abs=1e-12), k
    want, got = _summary(jax_out), _summary(port_out)
    for k in set(want) - {"bar"}:
        assert _same(want[k], got[k]), k
    assert got["jax_band"] == [0.0185, 0.0288] and got["jax_median"] == 0.02
    if case == "best_swa_curves":
        port_curves = dict(np.load(tmp_path / "curves" / "curves_seed123.npz"))
        assert _same(jax_curves, port_curves)


def test_bgm_impute_recipe_is_the_jax_runners(monkeypatch, capsys):
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_bgm, "BGM", _recorder(jax_calls, "bgm"))
    monkeypatch.setattr(bi, "BGM", _recorder(port_calls, "bgm"))
    flags = ["--lr_decay", "cosine"]
    monkeypatch.setattr(sys, "argv", ["bgm_impute.py", *flags])
    _jax_runner("bgm_impute").main()
    jax_out = capsys.readouterr().out
    # The port's scratch folder is the temporary directory's (where the JAX
    # runner names /tmp); neither runner writes there.
    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    bi.main(flags + ["--device", "cpu"])
    port_out = capsys.readouterr().out

    assert [c[0] for c in jax_calls] == ["init", "fit", "evaluate", "predict"]
    assert [c[0] for c in port_calls] == [c[0] for c in jax_calls]
    for want, got in zip(jax_calls, port_calls):
        assert _same(want, got), (want[0], want[1:], got[1:])
    (want,), (got,) = _json_lines(jax_out), _json_lines(port_out)
    assert np.isfinite(want["corr"]) and want == got


def test_hi_protocol_tiny_run_prints_jax_keys_and_band(capsys, tmp_path):
    hp.main(HI_TINY + ["--seeds", "1", "2", "--output_dir", str(tmp_path)])
    out = capsys.readouterr().out
    lines = _json_lines(out)
    assert [line["seed"] for line in lines] == [1, 2]
    for line in lines:
        assert JAX_KEYS <= set(line) and "card" not in line
        assert np.isfinite(line["rmse"]) and 0.0 <= line["coverage"] <= 1.0
        assert line["iv_width_mean"] > 0 and line["egm_s"] > 0
        assert set(line["launches_fit"]) == {"bnn_hosteps", "bnn_hosteps_paired",
                                             "bnn_hosteps_grad", "bnn_mh_window"}
    summary = _summary(out)
    assert summary["rmses"] == sorted(line["rmse"] for line in lines)
    assert summary["median_rmse"] == pytest.approx(np.median(summary["rmses"]))
    assert summary["jax_band"] == [0.0185, 0.0288] and summary["jax_median"] == 0.02
    assert summary["reference_median"] == 0.0289 and "bar" not in summary


def test_bgm_impute_tiny_run_prints_jax_keys(capsys):
    bi.main(BGM_TINY)
    (line,) = _json_lines(capsys.readouterr().out)
    assert set(line) == {"imputation_rmse", "corr", "coverage", "nominal",
                         "mse_reconstruction", "fit_s", "predict_s"}
    assert np.isfinite(line["imputation_rmse"]) and 0.0 <= line["coverage"] <= 1.0
    assert line["nominal"] == 0.95


def test_hi_protocol_state_dir_resumes_bit_for_bit(capsys, tmp_path):
    """A second run on the same ``--state_dir`` restores the last eval
    epoch's full state, trains on from there without the EGM and predicts
    what the first, uninterrupted run predicted."""
    flags = HI_TINY + ["--seeds", "3", "--state_dir", str(tmp_path / "state")]
    hp.main(flags)
    first, = _json_lines(capsys.readouterr().out)
    ckpt_dir = tmp_path / "state" / "checkpoints" / "HI_protocol" / "seed3"
    assert [p.name for p in ckpt_dir.glob("ckpt-*.npz")] == ["ckpt-0.npz"]
    hp.main(flags)
    out = capsys.readouterr().out
    second, = _json_lines(out)
    assert "Resuming training from checkpoint at epoch 0." in out
    assert "egm_s" in first and "egm_s" not in second
    for k in ("rmse", "mape", "iv_width_mean", "coverage", "best_epoch"):
        assert first[k] == second[k], k
    records = [json.loads(line) for line in
               (tmp_path / "state" / "metrics_seed3.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0]


RUNNERS = {"hi_protocol": HI_TINY + ["--seeds", "1"], "bgm_impute": BGM_TINY}


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_runner_imports_no_jax(runner, tmp_path):
    argv = list(RUNNERS[runner])
    if runner == "hi_protocol":
        argv += ["--output_dir", str(tmp_path)]
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "bayesgm_tpu"):
            sys.modules[name] = None  # any import of them raises
        from bayesgm_torch.benchmarks import {runner}
        {runner}.main({argv!r})
        print("IMPORTED", sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "jaxlib", "bayesgm_tpu")
                                 and sys.modules[m] is not None))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout
    assert len(_json_lines(out.stdout)) == 1


@pytest.mark.parametrize("runner", list(RUNNERS))
def test_runner_cuda_without_cuda_raises(runner):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    mod = {"hi_protocol": hp, "bgm_impute": bi}[runner]
    argv = list(RUNNERS[runner])
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv)
