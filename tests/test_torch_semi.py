"""The port's semi-synthetic loaders (``Semi_acic_sampler``,
``Semi_Twins_sampler``, ``resolve_data_path``) and their CSV reader against
the JAX package's, which read with pandas, on fabricated fixtures with the
real files' schema (as ``tests/test_datasets.py`` builds them), written by
pandas' ``to_csv`` and with ``%.17g``; the ``$BAYESGM_DATA`` hook and the
``FileNotFoundError``; and the config driver on both shipped configs on the
CPU at tiny depth.

The reader parses each decimal string correctly rounded; pandas' default
parser does not always (it keeps 17 digits counting the zeros after the
point and builds the value in double arithmetic), so the raw float64
values agree within a relative 1e-12 (measured: up to 9.96e-13 for
``%.17g`` strings of magnitude 1e-4).  The loaders cast to float32 before
anything else, so ``x``, ``y`` and ``v`` are bit-equal unless a value sits
within 1e-12 of a float32 rounding boundary (none of these fixtures has
one); ``auxiliary_constant`` is a float64 mean of the raw values: within a
relative 1e-12."""

import contextlib
import io
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from bayesgm_tpu.datasets import causal_samplers as jcs  # noqa: E402
from bayesgm_torch import main as driver  # noqa: E402
from bayesgm_torch.datasets import causal_samplers as tcs  # noqa: E402
from bayesgm_torch.utils.data_io import read_csv_table  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_RTOL = 1e-12  # pandas' parser against a correctly rounded one (module docstring)
TWINS_FILES = {p: f"twin_pairs_{p}_3years_samesex.csv" for p in "XTY"}


def _write(df, path, writer):
    """``df`` as a CSV: by pandas (``to_csv``, its shortest round-trip
    strings, NaN as an empty field) or with ``%.17g`` (NaN as an empty
    field, integers as integers)."""
    if writer == "to_csv":
        df.to_csv(path, index=False)
        return
    with open(path, "w") as f:
        f.write(",".join(df.columns) + "\n")
        for row in df.itertuples(index=False):
            f.write(",".join("" if isinstance(a, float) and np.isnan(a)
                             else (a if isinstance(a, str) else
                                   str(a) if isinstance(a, (int, np.integer)) else f"{a:.17g}")
                             for a in row) + "\n")


def write_acic(root, n_x, n_sim, p, writer, seed=0, ufid="u1"):
    """``x.csv`` (``sample_id`` + p covariates, rows in a shuffled id order)
    and ``scaling/factuals/<ufid>.csv`` (``sample_id,z,y`` for n_sim of
    those ids in another order, binary z)."""
    rng = np.random.RandomState(seed)
    ids = np.array([f"id{i:05d}" for i in rng.permutation(n_x)])
    cov = rng.randn(n_x, p) * 10.0 ** rng.randint(-4, 3, size=p)
    x_df = pd.DataFrame(cov, columns=[f"x_{i}" for i in range(p)])
    x_df.insert(0, "sample_id", ids)
    os.makedirs(os.path.join(root, "scaling", "factuals"), exist_ok=True)
    _write(x_df, os.path.join(root, "x.csv"), writer)
    sim_ids = rng.choice(ids, size=n_sim, replace=False)
    sim_df = pd.DataFrame({"sample_id": sim_ids, "z": rng.randint(0, 2, n_sim),
                           "y": rng.randn(n_sim) * 3.0 + 1.0})
    _write(sim_df, os.path.join(root, "scaling", "factuals", f"{ufid}.csv"), writer)


def write_twins(root, n, v_dim, writer, seed=1, nan_rows=(3,), heavy_rows=(5,)):
    """The Twins trio: X with two leading columns, ``v_dim`` covariates and
    the two infant-id columns (NaN covariates in ``nan_rows``), T with an
    index column and ``dbirwt_0``/``dbirwt_1`` (first twins of
    ``heavy_rows`` at 2400 g), Y with an index column and two outcomes."""
    rng = np.random.RandomState(seed)
    cov = rng.randn(n, v_dim) * 10.0 ** rng.randint(-3, 2, size=v_dim)
    for r in nan_rows:
        cov[r, rng.randint(v_dim)] = np.nan
    cov_df = pd.DataFrame(cov, columns=[f"cov{i}" for i in range(v_dim)])
    cov_df.insert(0, "Unnamed: 0", np.arange(n))
    cov_df.insert(1, "idx", np.arange(n))
    cov_df["infant_id_0"] = np.arange(n)
    cov_df["infant_id_1"] = np.arange(n) + n
    w0 = rng.randint(800, 1900, size=n).astype(float)
    w1 = rng.randint(800, 1900, size=n).astype(float)
    w1[list(heavy_rows)] = 2400.0
    t_df = pd.DataFrame({"Unnamed: 0": np.arange(n), "dbirwt_0": w0, "dbirwt_1": w1})
    y_df = pd.DataFrame({"Unnamed: 0": np.arange(n), "mort_0": rng.randint(0, 2, n),
                         "mort_1": rng.randint(0, 2, n)})
    os.makedirs(root, exist_ok=True)
    for part, df in zip("XTY", (cov_df, t_df, y_df)):
        _write(df, os.path.join(root, TWINS_FILES[part]), writer)


def _assert_samplers_equal(port, jax_sampler):
    for got, want in zip(port.load_all(), jax_sampler.load_all()):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    batch_p, batch_j = port.next_batch(), jax_sampler.next_batch()
    for got, want in zip(batch_p, batch_j):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["to_csv", "%.17g"])
def test_read_csv_table_against_pandas(tmp_path, writer):
    """Names, keys and values as ``pd.read_csv`` gives them, empty fields as
    NaN (the first and last columns too), values within ``RAW_RTOL``."""
    rng = np.random.RandomState(2)
    a = rng.randn(40, 5) * 10.0 ** rng.randint(-5, 5, size=5)
    a[3, 0] = a[7, 4] = a[8, 2] = np.nan
    df = pd.DataFrame(a, columns=list("abcde"))
    df.insert(2, "sample_id", [f"s{i}" for i in range(40)])
    path = str(tmp_path / "t.csv")
    _write(df, path, writer)
    names, keys, values = read_csv_table(path, key="sample_id")
    want = pd.read_csv(path, index_col="sample_id")
    assert names == list(want.columns) and list(keys) == list(want.index)
    np.testing.assert_array_equal(np.isnan(values), np.isnan(want.values))
    np.testing.assert_allclose(values, want.values, rtol=RAW_RTOL, atol=0)
    np.testing.assert_array_equal(values, a)  # correctly rounded: the doubles written
    df.drop(columns="sample_id").to_csv(tmp_path / "n.csv", index=False)
    names, keys, values = read_csv_table(str(tmp_path / "n.csv"))
    assert keys is None and names == list("abcde")
    np.testing.assert_array_equal(values, a)
    with pytest.raises(ValueError, match="no column named"):
        read_csv_table(path, key="id")


@pytest.mark.parametrize("writer", ["to_csv", "%.17g"])
def test_semi_acic_matches_jax(tmp_path, writer):
    """The inner join keeps x.csv's row order; x, y and v (column-major, as
    pandas' ``.values``) equal the JAX loader's bit for bit, and so do the
    sampler's batches."""
    write_acic(str(tmp_path), n_x=120, n_sim=70, p=9, writer=writer)
    port = tcs.Semi_acic_sampler(batch_size=8, path=str(tmp_path), ufid="u1")
    jax_sampler = jcs.Semi_acic_sampler(batch_size=8, path=str(tmp_path), ufid="u1")
    _assert_samplers_equal(port, jax_sampler)
    x, _, v = port.load_all()
    assert x.shape == (70, 1) and v.shape == (70, 9) and set(np.unique(x)) <= {0.0, 1.0}
    order = pd.read_csv(tmp_path / "x.csv")["sample_id"]
    kept = set(pd.read_csv(tmp_path / "scaling" / "factuals" / "u1.csv")["sample_id"])
    joined = pd.read_csv(tmp_path / "x.csv", index_col="sample_id").join(
        pd.read_csv(tmp_path / "scaling" / "factuals" / "u1.csv", index_col="sample_id"),
        how="inner")
    assert list(joined.index) == [i for i in order if i in kept]


@pytest.mark.parametrize("writer", ["to_csv", "%.17g"])
def test_semi_twins_matches_jax(tmp_path, writer):
    """Every filter (NaN covariate rows, heavy first twins), both twins
    stacked, the same eps and gamma draws: x, y and v bit-equal,
    ``auxiliary_constant`` within ``RAW_RTOL``."""
    write_twins(str(tmp_path), n=60, v_dim=7, writer=writer, nan_rows=(3, 17), heavy_rows=(5, 9))
    for seed in (0, 4):
        port = tcs.Semi_Twins_sampler(batch_size=4, seed=seed, path=str(tmp_path))
        jax_sampler = jcs.Semi_Twins_sampler(batch_size=4, seed=seed, path=str(tmp_path))
        _assert_samplers_equal(port, jax_sampler)
        np.testing.assert_allclose(port.auxiliary_constant, jax_sampler.auxiliary_constant,
                                   rtol=RAW_RTOL)
    x, _, v = port.load_all()
    assert x.shape == (2 * (60 - 4), 1) and v.shape == (2 * (60 - 4), 7)


def test_data_hook_and_missing_files(tmp_path, monkeypatch):
    """``$BAYESGM_DATA`` resolves both datasets with no path; a missing
    dataset raises ``FileNotFoundError`` naming the hook, as JAX's does."""
    write_acic(str(tmp_path / "ACIC_2018"), n_x=30, n_sim=20, p=3, writer="to_csv")
    monkeypatch.setenv("BAYESGM_DATA", str(tmp_path))
    s = tcs.Semi_acic_sampler(batch_size=4, ufid="u1")
    assert s.next_batch()[2].shape == (4, 3)
    for loader in (tcs.Semi_Twins_sampler, jcs.Semi_Twins_sampler):
        with pytest.raises(FileNotFoundError, match="BAYESGM_DATA"):
            loader(batch_size=4)
    write_twins(str(tmp_path / "Twins"), n=20, v_dim=3, writer="to_csv")
    assert tcs.Semi_Twins_sampler(batch_size=4).load_all()[2].shape == (2 * 18, 3)
    assert tcs.resolve_data_path(None, "Twins", TWINS_FILES["T"]) == str(tmp_path / "Twins")
    os.remove(tmp_path / "Twins" / TWINS_FILES["Y"])
    with pytest.raises(FileNotFoundError):
        tcs.Semi_Twins_sampler(batch_size=4)
    monkeypatch.delenv("BAYESGM_DATA")
    assert tcs.resolve_data_path(str(tmp_path / "ACIC_2018"), "ACIC_2018", "x.csv") == str(
        tmp_path / "ACIC_2018")


@pytest.mark.parametrize("config", ["Semi_acic", "Semi_Twins"])
def test_driver_runs_the_shipped_config(tmp_path, monkeypatch, config):
    """``configs/Semi_*.yaml`` through the driver on the CPU, on fixtures
    with the real schema (ACIC: 177 covariates; Twins: 50 after the drops),
    cut to 2 EGM iterations, one pass and 20 + 20 MH steps: the ATE (ACIC)
    or the ADRF with its RMSE line (Twins), finite with ordered
    intervals."""
    if config == "Semi_acic":
        write_acic(str(tmp_path / "data" / "ACIC_2018"), n_x=260, n_sim=200, p=177,
                   writer="to_csv", ufid=driver.ACIC_UFID)
    else:
        write_twins(str(tmp_path / "data" / "Twins"), n=110, v_dim=50, writer="to_csv")
    monkeypatch.setenv("BAYESGM_DATA", str(tmp_path / "data"))
    text = open(os.path.join(REPO, "configs", f"{config}.yaml")).read()
    text = text.replace("output_dir: '.'", f"output_dir: '{tmp_path / 'out'}'")
    text = text.replace("predict:\n  burn_in: 1000\n", "")
    cfg = tmp_path / f"{config}.yaml"
    cfg.write_text(text + "predict:\n  burn_in: 20\n  n_mcmc: 20\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        est, ci = driver.main(["-c", str(cfg), "-e", "0", "-b", "2", "--device", "cpu"])
    printed = out.getvalue()
    assert np.all(np.isfinite(est)) and np.all(ci[:, 0] <= ci[:, 1])
    if config == "Semi_acic":
        assert est.shape == (200,) and "ATE estimate:" in printed
    else:
        assert est.shape == (20,) and "ADRF RMSE:" in printed


@pytest.mark.parametrize("use_bnn", [True, False], ids=["bnn", "plain"])
def test_kernels_take_row_major_rows_of_a_column_major_table(tmp_path, monkeypatch, use_bnn):
    """Port fault F2 (ROADMAP Queue 3): ``v`` as the loaders and
    ``parse_file_triplet`` give it is column-major, as pandas' ``.values``
    is; predict's subject batch of it reached K1 (K4) as a non-contiguous
    tensor, which the CUDA wrappers refuse.  Every tensor handed to a
    kernel wrapper in fit, predict and the sampler API is now row-major."""
    import torch

    from bayesgm_torch.datasets.causal_samplers import Sim_Hirano_Imbens_sampler
    from bayesgm_torch.models.causalbgm import CausalBGM
    from bayesgm_torch.ops import _pk_bnn_hosteps as hk
    from bayesgm_torch.ops import _pk_plain as pk

    seen = []
    for cls in (hk.FusedCausalLogpBnnHosteps, hk.FusedCausalLogpAndGradBnnHosteps,
                pk.FusedCausalLogp, pk.FusedCausalLogpAndGrad):
        def spy(self, *args, _call=cls.__call__, **kw):
            tensors = [t for a in args for t in (a if isinstance(a, (list, tuple)) else [a])
                       if torch.is_tensor(t)]
            seen.append(all(t.is_contiguous() for t in tensors))
            return _call(self, *args, **kw)
        monkeypatch.setattr(cls, "__call__", spy)
    x, y, v = Sim_Hirano_Imbens_sampler(N=96, v_dim=6, seed=0).load_all()
    v = np.asfortranarray(v)
    assert not v.flags["C_CONTIGUOUS"] and not v[:50].flags["C_CONTIGUOUS"]
    m = CausalBGM(dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="t",
                       output_dir=str(tmp_path), save_res=False, use_bnn=use_bnn,
                       use_pallas_latent=True, g_units=[8], e_units=[8], h_units=[8],
                       f_units=[8], dz_units=[8]), random_seed=0, device="cpu")
    m.fit((x, y, v), epochs=0, epochs_per_eval=1, egm_n_iter=2, egm_batches_per_eval=2,
          verbose=0)
    m.predict((x, y, v), x_values=[0.5, 1.0], burn_in=3, n_mcmc=3, bs=50)
    m.metropolis_hastings_sampler((x, y, v), burn_in=2, n_keep=2)
    assert len(seen) > 10 and all(seen)
