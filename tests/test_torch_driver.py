"""The port's entry points and their numpy-only pieces against the JAX
package: ``get_ADRF``, ``parse_file`` / ``parse_file_triplet``, the
samplers, the config reader against ``yaml.safe_load``, the driver's
override checks and ``run_causal`` end to end on the CPU, and the CLI as
``tests/test_cli.py`` drives the JAX one.  None of these modules imports
yaml, pandas, sklearn, jax or the JAX package."""

import glob
import os
import subprocess
import sys
import textwrap
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import main as jax_driver  # noqa: E402
from bayesgm_tpu.cli import cli as jcli  # noqa: E402
from bayesgm_tpu.datasets import base_sampler as jbase  # noqa: E402
from bayesgm_tpu.datasets import causal_samplers as jcs  # noqa: E402
from bayesgm_tpu.utils import data_io as jio  # noqa: E402
from bayesgm_tpu.utils import helpers as jhelpers  # noqa: E402
from bayesgm_torch import main as driver  # noqa: E402
from bayesgm_torch.cli import cli  # noqa: E402
from bayesgm_torch.datasets import base_sampler as tbase  # noqa: E402
from bayesgm_torch.datasets import causal_samplers as tcs  # noqa: E402
from bayesgm_torch.models.causalbgm import CausalBGM  # noqa: E402
from bayesgm_torch.models.ensemble import EnsembleCausalBGM  # noqa: E402
from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM  # noqa: E402
from bayesgm_torch.models.identifiable import IdentifiableCausalBGM  # noqa: E402
from bayesgm_torch.utils import config_io  # noqa: E402
from bayesgm_torch.utils import data_io as tio  # noqa: E402
from bayesgm_torch.utils import helpers as thelpers  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


# -- numpy-only pieces -------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(x_values=[0.0, 0.5, 3.0], dataset="Imbens"),
    dict(x_values=np.linspace(-1, 2, 7), dataset="Sun"),
    dict(x_min=-1.0, x_max=1.5, nb_intervals=9, dataset="Lee"),
])
def test_get_adrf_equals_jax(kw):
    got, want = thelpers.get_ADRF(**kw), jhelpers.get_ADRF(**kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw,match", [(dict(x_values=[1.0], dataset="Other"), "oracle"),
                                      (dict(x_values=1.0), "list"),
                                      (dict(x_min=1.0, x_max=0.0, nb_intervals=3), "Empty"),
                                      (dict(), "Specify")])
def test_get_adrf_refusals(kw, match):
    for fn in (thelpers.get_ADRF, jhelpers.get_ADRF):
        with pytest.raises(ValueError, match=match):
            fn(**kw)


@pytest.fixture
def tables(tmp_path):
    """One (x, y, v) table written as .npz (both layouts), tab-separated
    .txt and .csv with a header row, and a comma-separated .csv."""
    rng = np.random.RandomState(3)
    data = np.round(rng.randn(25, 6) * 3, 6).astype(np.float32)
    paths = {}
    paths["npz"] = str(tmp_path / "t.npz")
    np.savez(paths["npz"], x=data[:, :1], y=data[:, 1:2], v=data[:, 2:])
    paths["data_npz"] = str(tmp_path / "d.npz")
    np.savez(paths["data_npz"], data=data)
    paths["txt"] = str(tmp_path / "t.txt")
    np.savetxt(paths["txt"], data, fmt="%.6f", delimiter="\t")
    paths["csv"] = str(tmp_path / "t.csv")
    np.savetxt(paths["csv"], data, fmt="%.6f", delimiter="\t",
               header="\t".join(f"c{i}" for i in range(6)), comments="")
    paths["comma_csv"] = str(tmp_path / "c.csv")
    np.savetxt(paths["comma_csv"], data, fmt="%.6f", delimiter=",",
               header=",".join(f"c{i}" for i in range(6)), comments="")
    return paths


@pytest.mark.parametrize("kind", ["npz", "txt", "csv", "comma_csv"])
@pytest.mark.parametrize("normalize", [True, False])
def test_parse_file_triplet_equals_jax(tables, kind, normalize):
    sep = "," if kind == "comma_csv" else "\t"
    got = tio.parse_file_triplet(tables[kind], sep=sep, normalize=normalize)
    want = jio.parse_file_triplet(tables[kind], sep=sep, normalize=normalize)
    for name, a, b in zip("xyv", got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind", ["data_npz", "txt", "csv", "comma_csv"])
def test_parse_file_equals_jax(tables, kind):
    sep = "," if kind == "comma_csv" else "\t"
    got, want = tio.parse_file(tables[kind], sep=sep), jio.parse_file(tables[kind], sep=sep)
    assert got.dtype == want.dtype and got.shape == want.shape == (25, 6)
    np.testing.assert_array_equal(got, want)
    raw = tio.parse_file(tables[kind], sep=sep, header=None if kind == "txt" else 0,
                         normalize=False)
    np.testing.assert_array_equal(raw, jio.parse_file(tables[kind], sep=sep, normalize=False))


def test_parse_refuses_other_extensions(tmp_path):
    path = tmp_path / "t.parquet"
    path.write_text("")
    for fn in (tio.parse_file, tio.parse_file_triplet):
        with pytest.raises(SystemExit, match="Unsupported"):
            fn(str(path))


@pytest.mark.parametrize("name,kw", [
    ("Sim_Hirano_Imbens_sampler", dict(N=300, v_dim=12, seed=3)),
    ("Sim_Sun_sampler", dict(N=300, v_dim=12, seed=3)),
    ("Sim_Sun_sampler", dict(N=64, v_dim=200, seed=0)),
    ("Sim_Colangelo_sampler", dict(N=300, v_dim=12, seed=3)),
    ("Sim_Colangelo_sampler", dict(N=64, v_dim=100, seed=0)),
])
def test_samplers_equal_jax(name, kw):
    """The same arrays for the same seed, and the same batches from
    next_batch, through the wraparound."""
    got, want = getattr(tcs, name)(batch_size=70, **kw), getattr(jcs, name)(batch_size=70, **kw)
    for a, b in zip(got.load_all(), want.load_all()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for _ in range(6):
        for a, b in zip(got.next_batch(), want.next_batch()):
            np.testing.assert_array_equal(a, b)


def test_base_sampler_equals_jax():
    rng = np.random.RandomState(0)
    x, y, v = rng.randn(50), rng.randn(50), rng.randn(50, 7) * 4 + 1
    got = tbase.Base_sampler(x, y, v, batch_size=16, normalize=True, random_seed=5)
    want = jbase.Base_sampler(x, y, v, batch_size=16, normalize=True, random_seed=5)
    for _ in range(8):
        for a, b in zip(got.next_batch(), want.next_batch()):
            np.testing.assert_array_equal(a, b)


# -- the config reader --------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_io_equals_yaml(path):
    got = config_io.load(path)
    want = yaml.safe_load(open(path))
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",
    "a: |\n  two\n  lines\n",
    "a: >\n  folded\n",
    "a: [[1, 2], [3]]\n",
    "a:\n  - 1\n  - 2\n",
    "a:\n  b:\n    c: 1\n",
    "a: {b: 1}\n",
    "a: !!str 1\n",
    "a: yes\n",
    "a: 010\n",
    "a: 'open\n",
    "a: 1\na: 2\n",
], ids=["anchor", "literal", "folded", "nested-list", "block-list", "deep-map", "flow-map",
        "tag", "yes", "octal", "unterminated", "duplicate"])
def test_config_io_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        config_io.loads(text)


def test_config_io_reads_its_subset():
    text = textwrap.dedent("""\
        # a comment
        a: 1   # trailing
        b: 0.0001
        c: 1e-4
        d: -2.5e3
        e: cosine
        f: 'it''s # not a comment'
        g: "x y"
        h: [64, 32, 8]
        i: []
        j: ~
        k:
        m: True
        predict:
          burn_in: 1000
          ess_target: 400
        """)
    assert config_io.loads(text) == dict(
        a=1, b=1e-4, c=1e-4, d=-2500.0, e="cosine", f="it's # not a comment", g="x y",
        h=[64, 32, 8], i=[], j=None, k=None, m=True,
        predict=dict(burn_in=1000, ess_target=400))


# -- the driver ----------------------------------------------------------------


def test_predict_overrides_block():
    """As tests/test_configs.py pins JAX's: pops the block, checks its keys,
    takes its absence."""
    for mod in (driver, jax_driver):
        params = {"dataset": "Sim_Hirano_Imbens", "predict": {"burn_in": 1000, "ess_target": 400}}
        assert mod._predict_overrides(params) == {"burn_in": 1000, "ess_target": 400}
        assert "predict" not in params
        assert mod._predict_overrides({"dataset": "x"}) == {}
        with pytest.raises(ValueError, match="Unknown predict override"):
            mod._predict_overrides({"predict": {"burnin": 1}})


class _NoEss:
    def fit(self, data, epochs=1):
        pass

    def predict(self, data, burn_in=1):
        pass


class _Forwarding:
    def fit(self, data, **kwargs):
        pass

    def predict(self, data, **kwargs):
        pass


def test_override_checks_follow_the_engines_signatures():
    """A predict override the engine's predict lacks fails before the fit;
    a **kwargs predict takes anything; fit overrides are checked against
    the allowed set and the engine's fit."""
    for mod in (driver, jax_driver):
        mod._check_overrides_against_engine(CausalBGM, "causalbgm",
                                            {"ess_target": 400, "burn_in": 1000})
        mod._check_overrides_against_engine(_Forwarding, "fwd", {"ess_target": 400})
        with pytest.raises(ValueError, match="not supported by model 'noess'"):
            mod._check_overrides_against_engine(_NoEss, "noess", {"ess_target": 400})
        params = {"dataset": "x", "fit": {"egm_batch_size": 128, "egm_n_iter": 7500}}
        assert mod._fit_overrides(params, CausalBGM, "causalbgm") == {
            "egm_batch_size": 128, "egm_n_iter": 7500}
        assert "fit" not in params
        assert mod._fit_overrides({"dataset": "x"}, CausalBGM, "causalbgm") == {}
        assert mod._fit_overrides({"fit": {"startoff": 2}}, _Forwarding, "fwd") == {"startoff": 2}
        with pytest.raises(ValueError, match="Unknown fit override"):
            mod._fit_overrides({"fit": {"egm_bs": 1}}, CausalBGM, "causalbgm")
        with pytest.raises(ValueError, match="not supported by model 'noess'"):
            mod._fit_overrides({"fit": {"startoff": 1}}, _NoEss, "noess")


def test_override_checks_of_the_variant_engines():
    """tests/test_configs.py's checks: fullmcmc's predict takes no
    ess_target and is refused before the fit (by the driver too), the
    ensemble forwards **kwargs and takes any override in the allowed set;
    identifiable takes the configs' overrides.  The driver refuses
    Sim_Sun.yaml's ess_target under model: fullmcmc before it builds the
    model, and an unknown engine by name."""
    for mod in (driver, jax_driver):
        mod._check_overrides_against_engine(EnsembleCausalBGM, "ensemble",
                                            {"ess_target": 400, "burn_in": 1000})
        mod._check_overrides_against_engine(IdentifiableCausalBGM, "identifiable",
                                            {"ess_target": 400, "burn_in": 1000})
        with pytest.raises(ValueError, match="not supported by model 'fullmcmc'"):
            mod._check_overrides_against_engine(FullMCMCCausalBGM, "fullmcmc",
                                                {"ess_target": 400})
        assert mod._fit_overrides({"fit": {"egm_batch_size": 128}}, EnsembleCausalBGM,
                                  "ensemble") == {"egm_batch_size": 128}
        assert mod._fit_overrides({"fit": {"startoff": 2}}, IdentifiableCausalBGM,
                                  "identifiable") == {"startoff": 2}
    params = config_io.load(os.path.join(REPO, "configs", "Sim_Sun.yaml"))
    params["model"] = "fullmcmc"
    built = mock.MagicMock(side_effect=AssertionError("built"))
    with mock.patch.object(driver, "_load_causal_dataset",
                           return_value=(*np.zeros((3, 4, 1)), None)), \
            mock.patch.object(FullMCMCCausalBGM, "__init__", built), \
            pytest.raises(ValueError, match="not supported by model 'fullmcmc'"):
        driver.run_causal(dict(params), epochs=0, egm_iters=0, device="cpu")
    built.assert_not_called()
    with pytest.raises(ValueError, match="Unknown model 'bgm'"):
        driver.run_causal(dict(params, model="bgm"), epochs=0, egm_iters=0, device="cpu")


@pytest.mark.parametrize("params,match", [
    (dict(dataset="Semi_acic"), "BAYESGM_DATA"),
    (dict(dataset="Semi_Twins"), "BAYESGM_DATA"),
])
def test_unported_datasets_name_their_item(params, match, tmp_path, monkeypatch):
    """The semi-synthetic datasets are ported; without their CSVs the driver
    raises ``FileNotFoundError`` naming the ``$BAYESGM_DATA`` hook."""
    monkeypatch.setenv("BAYESGM_DATA", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=match):
        driver.run_causal(dict(params), epochs=0, egm_iters=0, device="cpu")


@pytest.mark.parametrize("config,match", [
    # BGM and MNISTBGM are ported: the configs now run, cut by the monkeypatches below
    pytest.param("Sim_heteroskedastic.yaml", None, id="Sim_heteroskedastic.yaml-item 9"),
    pytest.param("Mnist.yaml", None, id="Mnist.yaml-item 10")])
def test_main_names_the_item_of_unported_models(config, match, monkeypatch, tmp_path, capsys):
    if config == "Mnist.yaml":
        return _cut_mnist_run(monkeypatch, tmp_path, capsys)
    load = config_io.load

    def cut_config(path):  # narrow nets, results under tmp_path, a shallow predict
        return dict(load(path), output_dir=str(tmp_path), g_units=[8], e_units=[8],
                    dz_units=[8], dx_units=[8], predict=dict(burn_in=5, n_mcmc=10))

    X, Y = np.random.RandomState(0).randn(80, 99), np.random.RandomState(1).randn(80)
    small = (np.hstack([X[:64], Y[:64, None]]).astype("float32"), X[64:], Y[64:])
    monkeypatch.setattr(config_io, "load", cut_config)
    monkeypatch.setattr(driver, "_load_bgm_dataset", lambda params: small)
    y_mean, intervals = driver.main(["-c", os.path.join(REPO, "configs", config), "-e", "0",
                                     "-b", "2", "--device", "cpu"])
    assert y_mean.shape == (16,) and np.all(np.isfinite(y_mean))
    assert intervals.shape == (16, 1, 2)
    assert "Pearson corr (posterior mean)" in capsys.readouterr().out


def _cut_mnist_run(monkeypatch, tmp_path, capsys):
    """configs/Mnist.yaml through main(): fit on 32 images (EGM 2 + 1
    iterations, epoch 0) at narrow widths, then the four masks on 4 images
    with 3 + 3 HMC steps; results and checkpoints under tmp_path."""
    from bayesgm_torch.datasets.images import make_ellipse_images
    from bayesgm_torch.models import mnist as tmn

    load = config_io.load
    monkeypatch.setattr(config_io, "load", lambda path: dict(
        load(path), output_dir=str(tmp_path), predict=dict(burn_in=3, n_mcmc=3)))
    monkeypatch.setattr(driver, "_load_mnist_images", lambda: make_ellipse_images(32, seed=1))
    monkeypatch.setattr(driver, "MNIST_TEST_IMAGES", 4)
    for name, width in (("GEN_FILTERS", 4), ("ENC_FILTERS", 4), ("DISC_FILTERS", 8),
                        ("GEN_SAMPLES", 8)):
        monkeypatch.setattr(tmn, name, width)
    results = driver.main(["-c", os.path.join(REPO, "configs", "Mnist.yaml"), "-e", "0", "-b", "2",
                           "--device", "cpu"])
    assert list(results) == [m["mode"] for m in driver.MNIST_MODES]
    for err, acc in results.values():
        assert 0.0 <= err <= 1.0 and 0.0 <= acc <= 1.0
    printed = capsys.readouterr().out
    assert printed.count("Inpainting [") == 4 and "HMC Acceptance Rate" in printed
    res, = glob.glob(os.path.join(str(tmp_path), "results", "MNIST", "*"))
    with np.load(os.path.join(res, "data_pred_mnist_hole.npz"), allow_pickle=True) as f:
        assert f["imputed"].shape == (4, 28, 28, 1) and np.asarray(f["pred_interval"]).shape == (4, 25, 2)
    assert os.path.exists(os.path.join(res, "init_data_gen_at_2.npz"))
    assert glob.glob(os.path.join(str(tmp_path), "checkpoints", "MNIST", "*", "ckpt-0.npz"))


def test_run_mnist_checks_its_overrides_before_the_fit():
    params = config_io.load(os.path.join(REPO, "configs", "Mnist.yaml"))
    with mock.patch.object(driver, "_load_mnist_images") as load:
        with pytest.raises(ValueError, match="not supported by model 'mnist'"):
            driver.run_mnist(dict(params, predict=dict(q_sd=1.0)), epochs=0, egm_iters=0,
                             device="cpu")
        with pytest.raises(ValueError, match="not supported by model 'mnist'"):
            driver.run_mnist(dict(params, fit=dict(startoff=1)), epochs=0, egm_iters=0,
                             device="cpu")
    load.assert_not_called()


def _small_sim_sun(monkeypatch, tmp_path, **overrides):
    """configs/Sim_Sun.yaml as config_io reads it, cut in the test alone: a
    200-row Sim_Sun of 12 covariates, narrow units, depth through the
    predict: block (the driver's own code keeps n=20000)."""
    params = config_io.load(os.path.join(REPO, "configs", "Sim_Sun.yaml"))
    params.update(output_dir=str(tmp_path), v_dim=12, g_units=[16], e_units=[16],
                  f_units=[8], h_units=[8], dz_units=[8], prior_units=[8], **overrides)
    params["predict"].update(burn_in=10, n_mcmc=20)
    small = tcs.Sim_Sun_sampler(N=200, v_dim=12, seed=0).load_all()
    truth = lambda g: thelpers.get_ADRF(x_values=g, dataset="Sun")
    monkeypatch.setattr(driver, "_load_causal_dataset", lambda name: (*small, truth))
    return params


def _check_driver_run(adrf, ci, out, tmp_path, dataset="Sim_Sun"):
    assert adrf.shape == (20,) and np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])
    assert len([line for line in out.splitlines() if line.startswith("ADRF RMSE:")]) == 1
    return glob.glob(os.path.join(str(tmp_path), "checkpoints", dataset, "*", "ckpt-0.npz"))


def test_run_causal_on_sim_sun_end_to_end(monkeypatch, tmp_path, capsys):
    """Sim_Sun.yaml as shipped selects the identifiable engine
    (model: identifiable), which runs: U drawn, fit, a checkpoint holding
    the prior net and U, the ESS-gated predict and the RMSE line."""
    built = []
    init = IdentifiableCausalBGM.__init__
    monkeypatch.setattr(IdentifiableCausalBGM, "__init__",
                        lambda self, *a, **k: built.append(self) or init(self, *a, **k))
    params = _small_sim_sun(monkeypatch, tmp_path)
    assert params["model"] == "identifiable"
    adrf, ci = driver.run_causal(params, epochs=1, egm_iters=3, device="cpu")
    out = capsys.readouterr().out
    assert "Generating auxiliary variable U for 10 segments." in out
    assert len(built) == 1 and built[0].data_u.shape == (200, 10)
    (ckpt,) = _check_driver_run(adrf, ci, out, tmp_path)
    with np.load(ckpt) as f:
        assert "['data_u']" in f.files and any(k.startswith("['prior_net']") for k in f.files)


@pytest.mark.parametrize("engine", ["identifiable", "ensemble", "fullmcmc"])
def test_run_causal_runs_each_variant_engine(monkeypatch, tmp_path, capsys, engine):
    """model: identifiable | ensemble | fullmcmc on the cut Sim_Sun, each
    through run_causal as the causalbgm engine runs (fullmcmc without the
    config's ess_target, which its predict lacks; its weight-space HMC runs
    between fit and predict, cut to 10 + 10 steps here)."""
    params = _small_sim_sun(monkeypatch, tmp_path, model=engine, n_members=2)
    hmc_calls = []
    if engine == "fullmcmc":
        params["predict"].pop("ess_target")
        run = FullMCMCCausalBGM.run_mcmc_training
        monkeypatch.setattr(FullMCMCCausalBGM, "run_mcmc_training",
                            lambda self, data: hmc_calls.append(len(data[0]))
                            or run(self, data, num_samples=10, num_burnin=10))
    adrf, ci = driver.run_causal(params, epochs=1, egm_iters=3, device="cpu")
    out = capsys.readouterr().out
    datasets = ["Sim_Sun_member0", "Sim_Sun_member1"] if engine == "ensemble" else ["Sim_Sun"]
    for name in datasets:
        assert len(_check_driver_run(adrf, ci, out, tmp_path, dataset=name)) == 1
    assert hmc_calls == ([200] if engine == "fullmcmc" else [])
    if engine == "fullmcmc":
        assert "HMC for f_net finished." in out


# -- the CLI -----------------------------------------------------------------------


@pytest.fixture
def triplet(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2, (30, 1)).astype("float32")
    y = rng.randn(30, 1).astype("float32")
    v = rng.randn(30, 4).astype("float32")
    path = str(tmp_path / "t.npz")
    np.savez(path, x=x, y=y, v=v)
    return path, (x, y, v)


def _mocked_run(argv, tmp_path, entry=None, n_out=30):
    fake = mock.MagicMock()
    fake.save_dir = str(tmp_path)
    fake.predict.return_value = (np.zeros(n_out), np.zeros((n_out, 2)))
    with mock.patch("bayesgm_torch.models.causalbgm.CausalBGM", return_value=fake) as M, \
            mock.patch("bayesgm_torch.utils.data_io.save_data") as S:
        (entry or cli.main)(argv)
    return M, fake, S


def test_causalbgm_binary_branch(triplet, tmp_path):
    path, _ = triplet
    M, fake, S = _mocked_run(["causalbgm", "-o", str(tmp_path), "-i", path, "-B", "-E", "3",
                              "-M", "7", "--burn_in", "11", "-q", "0.5"], tmp_path)
    params = M.call_args.kwargs["params"]
    assert params["v_dim"] == 4 and params["binary_treatment"] is True
    assert M.call_args.kwargs["device"] == "cuda" and "device" not in params
    assert M.call_args.kwargs["random_seed"] == 123
    fit_kwargs = fake.fit.call_args.kwargs
    assert fit_kwargs["epochs"] == 3 and fit_kwargs["egm_n_iter"] == 30000
    pred_kwargs = fake.predict.call_args.kwargs
    assert (pred_kwargs["n_mcmc"], pred_kwargs["burn_in"], pred_kwargs["q_sd"]) == (7, 11, 0.5)
    assert "x_values" not in pred_kwargs
    paths = [c.args[0] for c in S.call_args_list]
    assert any("causal_effect_point_estimate" in p for p in paths)
    assert any("causal_effect_posterior_interval" in p for p in paths)


def test_causalbgm_continuous_branch_and_device(triplet, tmp_path):
    path, _ = triplet
    M, fake, _ = _mocked_run(["causalbgm", "-o", str(tmp_path), "-i", path, "--device", "cpu",
                              "--no-binary_treatment", "--x_values", "0.5", "1.0", "1.5"],
                             tmp_path, n_out=3)
    assert fake.predict.call_args.kwargs["x_values"] == [0.5, 1.0, 1.5]
    assert M.call_args.kwargs["device"] == "cpu"


def test_flags_are_jaxs_plus_device():
    def flags(build):
        parser = jcli.argparse.ArgumentParser()
        sub = parser.add_subparsers()
        p = build(sub)
        return {a.dest: (a.option_strings, a.default) for a in p._actions if a.dest != "help"}

    port, jax_flags = flags(cli._build_causalbgm_parser), flags(jcli._build_causalbgm_parser)
    assert port.pop("device") == (["--device"], "cuda")
    assert port == jax_flags


def test_version_help_and_no_bgm_subcommand(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--version"])
    assert "0.1.0" in capsys.readouterr().out
    cli.main([])  # no subcommand -> help, listing both subcommands now that BGM is ported
    assert "{causalbgm,bgm}" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # the bgm subcommand parses its flags: -i is required
        cli.main(["bgm", "-o", "x"])
    assert "the following arguments are required: -i/--input" in capsys.readouterr().err


def test_legacy_causalbgm_entry(triplet, tmp_path):
    path, _ = triplet
    _, fake, _ = _mocked_run(["-o", str(tmp_path), "-i", path, "-E", "2"], tmp_path,
                             entry=cli.main_causalbgm)
    assert fake.fit.call_args.kwargs["epochs"] == 2


def test_cli_end_to_end_in_a_new_process(triplet, tmp_path):
    """python -m bayesgm_torch causalbgm on the CPU: parse -> fit (with
    checkpoints) -> predict -> the two result files; the run imports none of
    yaml, pandas, sklearn, jax or the JAX package."""
    path, _ = triplet
    out = str(tmp_path / "e2e")
    code = textwrap.dedent(f"""
        import sys, runpy
        sys.argv = ["bayesgm_torch", "causalbgm", "-o", {out!r}, "-i", {path!r}, "-d", "e2e",
                    "--device", "cpu", "--no-use_bnn", "-save_model", "-Z", "1", "1", "1", "2",
                    "--g_units", "8", "--e_units", "8", "--f_units", "8", "--h_units", "8",
                    "--dz_units", "8", "-N", "3", "--batches_per_eval", "2", "-E", "1",
                    "--epochs_per_eval", "1", "-M", "5", "--burn_in", "5", "--alpha", "0.1"]
        runpy.run_module("bayesgm_torch", run_name="__main__")
        bad = [m for m in ("yaml", "pandas", "sklearn", "jax", "bayesgm_tpu") if m in sys.modules]
        print("IMPORTED", bad)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "IMPORTED []" in res.stdout
    dirs = glob.glob(os.path.join(out, "results", "e2e", "*"))
    assert len(dirs) == 1
    est = np.loadtxt(os.path.join(dirs[0], "causal_effect_point_estimate.txt"))
    iv = np.loadtxt(os.path.join(dirs[0], "causal_effect_posterior_interval.txt"))
    assert est.shape == (30,) and iv.shape == (30, 2)
    assert np.all(np.isfinite(est)) and np.all(iv[:, 0] <= iv[:, 1])
    assert len(glob.glob(os.path.join(out, "checkpoints", "e2e", "*", "ckpt-1.npz"))) == 1
