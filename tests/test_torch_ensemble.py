"""The port's ``EnsembleCausalBGM`` (the lifecycle of
``tests/test_variants.py`` and the pooled-quantile check of
``tests/test_predict_batching.py``), and the device contract of the three
CausalBGM variants: CUDA by default, raising without it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesgm_torch import (  # noqa: E402
    CausalBGM,
    EnsembleCausalBGM,
    FullMCMCCausalBGM,
    IdentifiableCausalBGM,
)
from bayesgm_torch.ops import mcmc as tmcmc  # noqa: E402

torch.set_num_threads(2)


def _data(n=64, v_dim=4):
    rng = np.random.RandomState(0)
    v = rng.randn(n, v_dim).astype("float32")
    x = rng.rand(n, 1).astype("float32")
    return x, (x + v[:, :1]).astype("float32"), v


def _params(tmp_path, **kw):
    p = dict(v_dim=4, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="ens",
             output_dir=str(tmp_path), use_bnn=False, n_members=2, g_units=[8], e_units=[8],
             f_units=[8], h_units=[8], dz_units=[8], save_res=False, save_model=False)
    p.update(kw)
    return p


def test_ensemble_lifecycle(tmp_path):
    """tests/test_variants.py::test_ensemble_causalbgm_lifecycle: K members
    from distinct seeds and datasets, fitted, predicted and evaluated."""
    x, y, v = _data()
    m = EnsembleCausalBGM(_params(tmp_path), random_seed=5, device="cpu")
    assert len(m.members) == 2 and all(isinstance(k, CausalBGM) for k in m.members)
    assert [k.seed for k in m.members] == [5 + 7919, 5 + 2 * 7919]
    assert [k.params["dataset"] for k in m.members] == ["ens_member0", "ens_member1"]
    assert m.get_config()["params"]["n_members"] == 2 and "n_members" not in m.members[0].params
    a, b = (k.nets["g"].w[0].detach() for k in m.members)
    assert float((a - b).abs().max()) > 1e-4
    m.fit((x, y, v), epochs=2, epochs_per_eval=2, batch_size=16, use_egm_init=False, verbose=0)
    adrf, ci = m.predict((x, y, v), alpha=0.2, n_mcmc=10, burn_in=20, x_values=[0.5, 1.0])
    assert adrf.shape == (2,) and ci.shape == (2, 2)
    assert np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])
    causal, mse_x, mse_y, mse_v = m.evaluate((x, y, v))
    assert causal.shape == (200,) and np.isfinite(mse_y)


@pytest.mark.parametrize("binary", [False, True], ids=["continuous", "binary"])
def test_ensemble_pools_member_draws(tmp_path, binary):
    """tests/test_predict_batching.py::test_ensemble_pools_member_draws: the
    point and interval are the mean and quantiles of the POOLED member draws
    (each member's own draws, concatenated along the draw axis), and the
    diagnostics are the members' elementwise min ESS and max split-R̂."""
    x, y, v = _data(n=30)
    if binary:
        x = (x > 0.5).astype("float32")
    ens = EnsembleCausalBGM(_params(tmp_path, binary_treatment=binary), random_seed=9,
                            device="cpu")
    ens.fit((x, y, v), epochs=1, epochs_per_eval=1, batch_size=15, use_egm_init=False, verbose=0)
    member_draws, member_diags = [], []
    for m in ens.members:
        state = m._gen.get_state(), m._host_gen.get_state()
        out = m.predict((x, y, v), alpha=0.2, n_mcmc=60, burn_in=60, q_sd=1.0,
                        x_values=None if binary else [0.5, 1.5], return_diagnostics=True,
                        return_draws=True)
        member_draws.append(out[-1])
        member_diags.append(out[2])
        m._gen.set_state(state[0])
        m._host_gen.set_state(state[1])
    pt, iv, diag, pooled = ens.predict((x, y, v), alpha=0.2, n_mcmc=60, burn_in=60, q_sd=1.0,
                                       x_values=None if binary else [0.5, 1.5],
                                       return_diagnostics=True, return_draws=True)
    axis = 0 if binary else 1
    np.testing.assert_array_equal(pooled, np.concatenate(member_draws, axis=axis))
    assert pooled.shape == ((120, 30) if binary else (2, 120))
    np.testing.assert_allclose(pt, pooled.mean(axis=axis), rtol=1e-6)
    np.testing.assert_allclose(iv[:, 0], np.quantile(pooled, 0.1, axis=axis), rtol=1e-6)
    np.testing.assert_allclose(iv[:, 1], np.quantile(pooled, 0.9, axis=axis), rtol=1e-6)
    np.testing.assert_array_equal(diag["ess"], np.min([d["ess"] for d in member_diags], axis=0))
    np.testing.assert_array_equal(diag["rhat"], np.max([d["rhat"] for d in member_diags], axis=0))
    assert diag["accept_rate"] == pytest.approx(np.mean([d["accept_rate"] for d in member_diags]))
    assert tmcmc.effective_sample_size(pooled, axis=axis).shape == pt.shape


def test_ensemble_forwards_member_keywords(tmp_path, monkeypatch):
    """predict's extra keywords (ess_target among them) reach every member."""
    ens = EnsembleCausalBGM(_params(tmp_path), random_seed=1, device="cpu")
    seen = []

    def fake_predict(self, data, **kw):
        seen.append(kw)
        return np.zeros(2), np.zeros((2, 2)), np.zeros((2, 5))

    monkeypatch.setattr(CausalBGM, "predict", fake_predict)
    ens.predict(_data(n=8), x_values=[0.5, 1.0], ess_target=400, sampler="mh")
    assert len(seen) == 2 and all(k["ess_target"] == 400 and k["return_draws"] for k in seen)


@pytest.mark.parametrize("cls", [IdentifiableCausalBGM, FullMCMCCausalBGM, EnsembleCausalBGM],
                         ids=["identifiable", "fullmcmc", "ensemble"])
def test_variants_run_on_cuda_unless_told_otherwise(tmp_path, cls):
    """device="cuda" is the default: without CUDA the constructor raises;
    device="cpu" (by name) builds the model on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(_params(tmp_path), random_seed=0)
    m = cls(_params(tmp_path), random_seed=0, device="cpu")
    members = m.members if cls is EnsembleCausalBGM else [m]
    assert all(k.device.type == "cpu" for k in members)
