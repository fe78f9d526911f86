"""K8, the probe's variants of K6's evaluation: the port's plain versions
against the JAX probe's kernels (``benchmarks/mxu_probe.py``) in interpret
mode, with the TPU PRNG replaced by a counter hash whose draws are replayed
into the port in each variant's order; the wrappers, nets, bounds and the
probe's command line on the CPU."""

import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from bayesgm_torch.benchmarks import mxu_probe as tp  # noqa: E402
from bayesgm_torch.ops import _pk_bnn_inkernel as tk  # noqa: E402
from _torch_parity import ProbeReplayedDraws, ReplayedDraws  # noqa: E402
from _torch_parity import stub_prng as _stub_prng  # noqa: E402

torch.set_num_threads(2)

# As K6's test, bf16 included: XLA and the port round the same operands to
# bf16 here (largest gap measured 1.5e-5, 1.7e-7 relative).
TOL = dict(rtol=2e-5, atol=2e-5)
CFG = SimpleNamespace(z_dims=[1, 1, 1, 2], v_dim=6, sigma_v=None, sigma_x=None, sigma_y=None,
                      binary_treatment=False)
DIMS = ([5, 8, 8, 7], [2, 8, 2], [3, 8, 2])
N, BLOCK = 32, 16  # two row blocks
SEED0 = torch.zeros(2, dtype=torch.int32)


def _jax_probe():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "mxu_probe.py"
    spec = importlib.util.spec_from_file_location("_jax_mxu_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed=0):
    """Numpy data of N rows and flat nets with sigma around 0.3, where the
    perturbation moves the loss by far more than the tolerance."""
    rng = np.random.default_rng(seed)
    data = [rng.normal(size=(N, d)).astype(np.float32) for d in (5, 1, 1, 6)]
    flats = []
    for d in DIMS:
        f = [1.0 + 0.1 * rng.normal(size=d[0]), 0.1 * rng.normal(size=d[0])]
        for n_in, n_out in zip(d[:-1], d[1:]):
            f += [rng.normal(size=(n_in, n_out)) / np.sqrt(n_in),
                  rng.uniform(0.2, 0.4, size=(n_in, n_out)), 0.1 * rng.normal(size=n_out)]
        flats.append([a.astype(np.float32) for a in f])
    return data, flats


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _jax_values(monkeypatch, variant, data, flats):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    _stub_prng(monkeypatch)
    fn = _jax_probe().make_probe_kernel(variant, CFG, *DIMS, block_rows=BLOCK)
    return np.asarray(fn(*data, jnp.zeros((2,), jnp.int32), *flats))


def _port_values(variant, data, flats, draws):
    return tp.probe_plain(variant, CFG, *(_t(a) for a in data), SEED0,
                          *[[_t(a) for a in f] for f in flats], BLOCK, draws=draws).numpy()


@pytest.mark.parametrize("variant", tp.KERNEL_VARIANTS)
def test_plain_matches_jax_probe_interpret(monkeypatch, variant):
    data, flats = _inputs()
    want = _jax_values(monkeypatch, variant, data, flats)
    got = _port_values(variant, data, flats, ProbeReplayedDraws(variant, DIMS, BLOCK))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", ["noeps", "epsref", "nosigns", "blockdiag"])
def test_a_wrong_draw_order_is_caught(monkeypatch, variant):
    """K6's draw order in place of the variant's own moves the values far
    outside the tolerance: the sigma of the parity test makes it see the
    noise."""
    data, flats = _inputs()
    want = _jax_values(monkeypatch, variant, data, flats)
    got = _port_values(variant, data, flats, ReplayedDraws(DIMS, BLOCK))
    assert not np.allclose(got, want, **TOL)


def _port_inputs(n=40, seed=1):
    data, flats = _inputs(seed)
    gen = torch.Generator().manual_seed(seed)
    data = [torch.randn((n, a.shape[1]), generator=gen) for a in data]
    return data, [[_t(a) for a in f] for f in flats]


def test_base_and_prod_are_k6_and_xorsign_and_blockdiag_base():
    """With the Philox draws, base and prod compute K6's plain version, and
    xorsign and blockdiag compute base's function."""
    data, flats = _port_inputs()
    seed = torch.tensor([5, -9], dtype=torch.int32)
    k6 = tk.logp_plain(CFG, *data, seed, *flats, 16)
    for variant in ("prod", "base", "xorsign", "blockdiag"):
        assert torch.equal(tp.probe_plain(variant, CFG, *data, seed, *flats, 16), k6)
    nopert = tp.probe_plain("nopert", CFG, *data, seed, *flats, 16)
    assert not torch.allclose(nopert, k6)


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    data, flats = _port_inputs(n=20)
    seed = torch.tensor([1, 2], dtype=torch.int32)
    before, before_k6 = dict(tp.LAUNCHES), dict(tk.LAUNCHES)
    for variant in tp.VARIANTS:
        fn = tp.make_probe_kernel(variant, CFG, *DIMS, block_rows=16)
        assert fn.block_rows == 16
        got = fn(*data, seed, *flats)
        assert got.shape == (20,) and bool(torch.isfinite(got).all())
        assert torch.equal(got, tp.probe_plain(variant, CFG, *data, seed, *flats, 16))
        assert fn.launches == 0
    assert tp.LAUNCHES == before and tk.LAUNCHES == before_k6
    meta = torch.empty((4, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tp.make_probe_kernel("base", CFG, *DIMS)(meta, meta, meta, meta, meta, [], [], [])


@pytest.mark.parametrize("kw", [dict(binary_treatment=True), dict(sigma_v=0.5),
                                dict(sigma_x=0.7), dict(sigma_y=0.3)])
def test_binary_or_fixed_sigma_raises(kw):
    cfg = SimpleNamespace(**{**vars(CFG), **kw})
    data, flats = _port_inputs(n=8)
    with pytest.raises(ValueError, match="continuous treatment"):
        tp.make_probe_kernel("base", cfg, *DIMS)
    with pytest.raises(ValueError, match="continuous treatment"):
        tp.probe_plain("nopert", cfg, *data, SEED0, *flats, 16)


def test_unknown_variant_raises():
    data, flats = _port_inputs(n=8)
    with pytest.raises(ValueError, match="unknown probe variant"):
        tp.make_probe_kernel("mxu", CFG, *DIMS)
    with pytest.raises(ValueError, match="unknown probe variant"):
        tp.probe_plain("fast", CFG, *data, SEED0, *flats, 16)


def test_build_nets_has_the_documented_layout():
    flats = tp._build_nets(torch.Generator().manual_seed(0), [[10, 64, 201], [2, 8, 2]])
    assert [len(f) for f in flats] == [8, 8]
    g = flats[0]
    assert torch.equal(g[0], torch.ones(10)) and torch.equal(g[1], torch.zeros(10))
    assert [tuple(t.shape) for t in g[2:]] == [(10, 64), (10, 64), (64,), (64, 201),
                                               (64, 201), (201,)]
    assert torch.equal(g[3], torch.full((10, 64), 0.0067)) and not bool(g[4].any())
    # loc ~ N(0, 1) / sqrt(fan_in)
    assert abs(float(g[5].std()) * 8.0 - 1.0) < 0.05


def test_probe_inputs_and_bounds_at_the_flagship_shape():
    cfg, dims, data, flats = tp.probe_inputs(8, 200, torch.device("cpu"))
    assert dims[0] == [10, 64, 64, 64, 64, 64, 201] and cfg.z_dims == (1, 1, 1, 7)
    assert [tuple(a.shape) for a in data] == [(16, 10), (16, 1), (16, 1), (16, 200)]
    macs = 34848  # per row, the three chains' dense layers
    assert sum(a * b for d in dims for a, b in zip(d[:-1], d[1:])) == macs
    b = {v: tp.bound(v, dims, 40000, 512, 200, flats) for v in tp.VARIANTS}
    eps_ops = 79 * macs * 14  # 79 logical blocks of 512 rows
    assert b["base"][1] == "operations"
    assert b["base"][0] == pytest.approx(1e3 * (40000 * 4 * macs + eps_ops) / 67e12)
    assert b["nopert"][0] == pytest.approx(1e3 * 40000 * 2 * macs / 67e12)
    assert b["noprng"][0] == pytest.approx(1e3 * 40000 * 4 * macs / 67e12)
    # bf16's products at the tensor-core rate: its bytes bind
    weights = sum(t.numel() for f in flats for t in f)
    assert 1e3 * (40000 * 4 * macs / 989e12 + eps_ops / 67e12) < b["bf16"][0]
    assert b["bf16"] == (pytest.approx(1e3 * 4 * (40000 * 213 + weights) / 3.35e12), "bytes")
    assert b["prod"] == b["base"] == b["xorsign"] == b["blockdiag"] == b["nosigns"]


def test_main_runs_the_plain_versions_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "probe.jsonl"
    tp.main(["--device", "cpu", "--n", "8", "--v_dim", "4", "--short", "1", "--long", "2",
             "--variants", "base", "nopert", "--out", str(out)])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["variant"] for d in lines] == ["base", "nopert"]
    assert out.read_text().splitlines() == [json.dumps(d) for d in lines]
    for d in lines:
        assert d["timer"] == "host_clock" and d["device"] == "cpu" and d["launches"] == 0
        assert d["rows"] == 16 and len(d["reps_ms"]) == 3 and d["bound_by"] == "bytes"
    assert lines[0]["speedup_vs_base"] == pytest.approx(1.0)
    assert lines[1]["speedup_vs_base"] == pytest.approx(lines[0]["ms_per_eval"]
                                                        / lines[1]["ms_per_eval"])


def test_main_raises_without_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tp.main(["--variants", "base"])
    with pytest.raises(SystemExit):
        tp.main(["--device", "cpu", "--short", "5", "--long", "5"])


def test_probe_never_imports_jax(tmp_path):
    code = ("import sys, torch\n"
            "torch.set_num_threads(2)\n"
            "from bayesgm_torch.benchmarks import mxu_probe\n"
            "mxu_probe.main(['--device', 'cpu', '--n', '4', '--v_dim', '3', '--short', '1',\n"
            "                '--long', '2', '--variants', 'blockdiag', 'bf16'])\n"
            "print('JAX_IMPORTED', 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "JAX_IMPORTED False"
    assert [json.loads(s)["variant"] for s in out.stdout.splitlines()[:-1]] == ["blockdiag", "bf16"]
