"""``tests/_jax_hmc_trajectory.py`` end to end at a tiny size: both
packages' FullMCMC weight HMC from one saved state, stepped side by side in
float64 on the same draws through the adaptation's end, never part, and the
float32 targets at the fitted weights round where the float64 ones agree."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesgm_torch.models.fullmcmc import FullMCMCCausalBGM  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N, V_DIM, BURN_IN, KEEP = 120, 8, 100, 20
# the closing bar of the float64 comparison: states equal to 1e-9 of their size
F64_REL = 1e-9


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """A binary_ate FullMCMC state as the stage split saves it: the model's
    initial nets and a seeded latent table."""
    out = tmp_path_factory.mktemp("trajectory")
    model = FullMCMCCausalBGM(dict(v_dim=V_DIM, z_dims=[3, 6, 3, 6], binary_treatment=True,
                                   dataset="binary_ate", output_dir=str(out / "m"), use_bnn=True,
                                   save_res=False, save_model=False),
                              random_seed=5, device="cpu")
    model.data_z = torch.as_tensor(
        np.random.default_rng(1).normal(size=(N, 18)).astype(np.float32))
    model.save_weights(str(out / "fitted.npz"))
    return out


def test_f64_trajectories_never_part(state):
    log = state / "steps.jsonl"
    out = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_jax_hmc_trajectory.py"), "--precision", "f64",
         "--state", str(state / "fitted.npz"), "--n", str(N), "--v_dim", str(V_DIM),
         "--hmc_burnin", str(BURN_IN), "--hmc_samples", str(KEEP), "--log", str(log)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    rounding = [x for x in lines if x["stage"] == "rounding"]
    summary = [x for x in lines if x["stage"] == "summary"]
    assert [x["net"] for x in rounding] == [x["net"] for x in summary] == list("ghf")
    for x in rounding:
        assert abs(x["f64_port_minus_jax"]) <= F64_REL * abs(x["logp_f64_jax"]), x
        assert x["err_f32_jax"] > 0 and x["err_f32_port"] > 0, x
    for x in summary:
        assert x["precision"] == "f64" and x["steps"] == BURN_IN + KEEP
        assert x["n_partings"] == 0 and x["first_parting"] is None, x
        assert x["max_rel_diff_agreeing"] <= F64_REL, x
        assert x["accept_port"] == x["accept_jax"] and x["step_port"] == x["step_jax"], x
    steps = [json.loads(x) for x in log.read_text().splitlines()]
    assert len(steps) == 3 * (BURN_IN + KEEP)
    for net in "ghf":
        mine = [x for x in steps if x["net"] == net]
        sizes = [x["step_jax"] for x in mine]
        # the step size moved over the adapting steps and stayed after them
        assert len(set(sizes[:int(0.8 * BURN_IN)])) > 1
        assert len(set(sizes[int(0.8 * BURN_IN) - 1:])) == 1
        assert all(x["accept_jax"] == x["accept_port"] for x in mine)
    # some steps rejected somewhere, so the decisions were tested both ways
    assert not all(x["accept_jax"] for x in steps)


def test_chain_compare_reads_each_runs_first_predict(tmp_path):
    """``tools/chain_compare.py`` takes each log's first stage-C line, splits
    the runs by package, and gives the means, the difference with its
    standard error and the Mann-Whitney p-value."""
    import importlib.util

    from scipy.stats import mannwhitneyu

    spec = importlib.util.spec_from_file_location("chain_compare",
                                                  REPO / "tools" / "chain_compare.py")
    cc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cc)
    port, jax_ = [0.201, 0.203, 0.204], [0.189, 0.192, 0.198, 0.190]
    paths = []
    for i, v in enumerate(port + jax_):
        extra = {"package": "jax"} if i >= len(port) else {}
        lines = ["Running HMC for g_net...", json.dumps({"stage": "B", "net": "g"}),
                 json.dumps({"stage": "C", "predict": 1, "d_ate": v, "seed": i, **extra}),
                 json.dumps({"stage": "C", "predict": 2, "d_ate": 9.0, "seed": i, **extra})]
        paths.append(tmp_path / f"run{i}.log")
        paths[-1].write_text("\n".join(lines) + "\n")
    out = cc.compare([str(p) for p in paths])
    assert [c["value"] for c in out["port"]["chains"]] == port
    assert [c["value"] for c in out["jax"]["chains"]] == jax_
    np.testing.assert_allclose(out["mean_diff"], np.mean(port) - np.mean(jax_))
    se = np.sqrt(np.var(port, ddof=1) / 3 + np.var(jax_, ddof=1) / 4)
    np.testing.assert_allclose(out["se_diff"], se)
    assert out["mann_whitney_p"] == mannwhitneyu(port, jax_, alternative="two-sided").pvalue
