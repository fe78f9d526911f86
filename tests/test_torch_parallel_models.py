"""Every ``mesh=`` path of the port's models in gloo worlds on the CPU, case
for case with ``tests/test_parallel.py``: each case runs in a world of one,
which must equal ``mesh=None`` bit for bit, and in a world of four, held
against ``mesh=None`` at ``tests/test_parallel.py``'s tolerances (1e-3 /
1e-4 where the JAX test checks only shapes).  Every rank must return the
same arrays.  Also: an ensemble, a checkpoint written by rank 0 and resumed
bit-equal, the early-stop gate, and the full-batch step against JAX's
``make_sharded_causal_train_step`` on the 8-device CPU mesh.  One spawn per
world runs every case (``tests/_torch_dist_workers.py``)."""

import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist_workers as W  # noqa: E402
from bayesgm_torch.utils import checkpoint as tckpt  # noqa: E402

WORLD = 4
NAMES = ["fit_predict", "egm_kernel_fit", "resume", "early_stop", "identifiable", "fullmcmc",
         "bgm_predict", "mnist_predict", "ensemble", "jax_parity_step"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOSE = dict(rtol=1e-3, atol=1e-4)  # test_parallel.py's predict tolerance


def _graft_entry():
    spec = importlib.util.spec_from_file_location("graft_entry",
                                                  os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh4"))
    cfg, nets, (x, y, v), z = _graft_entry()._tiny_setup()
    np.savez(os.path.join(out, "jax_tiny.npz"), **tckpt.flatten(
        {"nets": jax.tree.map(np.asarray, nets), "x": x, "y": y, "v": v, "z": z}))
    for world in (1, WORLD):
        W.spawn(world, NAMES, out, timeout=400)
    return out


def _result(runs, name, world):
    """Rank 0's arrays, after checking that every rank returned the same."""
    first = W.load(runs, name, world)
    for r in range(1, world):
        other = W.load(runs, name, world, r)
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=f"rank {r}: {k}")
    return first


def _check(runs, name, world, close):
    """World 1 bit-equal to ``mesh=None``; past it, each key of ``close``
    (a key prefix -> tolerances) within its tolerances."""
    got, ref = _result(runs, name, world), W.load_ref(runs, name)
    assert set(got) == set(ref)
    if world == 1:
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        return got, ref
    for k in ref:
        tol = next((t for prefix, t in close.items() if k.startswith(prefix)), None)
        if tol is not None:
            np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)
    return got, ref


NETS = dict(rtol=2e-3, atol=2e-6)
TABLE = dict(rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("world", [1, WORLD])
def test_public_fit_predict_mesh_matches_single_device(runs, world):
    """Plain and flipout nets: the table and the nets; plain nets' ADRF and
    intervals; binary treatment by MALA.  Flipout predict runs K1's wrapper,
    whose signs come from a rank-mixed seed: past one rank it agrees in law."""
    close = {"plain.data_z": TABLE, "bnn.data_z": TABLE, "plain.adrf": CLOSE, "plain.ci": CLOSE,
             "mala.": CLOSE}
    close.update({f"{t}.{k}": NETS for t in ("plain", "bnn") for k in "ghf"})
    got, _ = _check(runs, "fit_predict", world, close)
    assert got["bnn.adrf"].shape == (2,) and np.all(np.isfinite(got["bnn.adrf"]))
    assert got["mala.ite"].shape == (64,) and np.all(got["mala.ci"][:, 0] <= got["mala.ci"][:, 1])


@pytest.mark.parametrize("world", [1, WORLD])
def test_fit_through_kernel_wrappers_and_checkpoint(runs, world):
    """EGM, K3 replicated and K4 per rank: the predict and every leaf of the
    checkpoint written at the eval epoch (the table and its moments
    gathered; the generator states the same on every rank)."""
    got, ref = _check(runs, "egm_kernel_fit", world, {"adrf": CLOSE, "ci": CLOSE,
                                                       "data_z": TABLE, "ckpt.": CLOSE})
    for k in ref:
        if "gen" in k:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("world", [1, WORLD])
def test_checkpoint_written_once_and_resumed_bit_equal(runs, world):
    got, _ = _check(runs, "resume", world, {"full_z": TABLE, "resumed_z": TABLE})
    assert list(got["files"]) == ["ckpt-0.npz", "ckpt-1.npz"]
    np.testing.assert_array_equal(got["resumed_z"], got["full_z"])
    for k in got:
        if k.startswith("full."):
            np.testing.assert_array_equal(got["resumed." + k[5:]], got[k], err_msg=k)


@pytest.mark.parametrize("world", [1, WORLD])
def test_early_stop_gate_stops_at_the_same_step_on_every_rank(runs, world):
    got, ref = _check(runs, "early_stop", world, {"ite": CLOSE, "ci": CLOSE, "draws": CLOSE})
    assert int(got["n_draws"]) == int(ref["n_draws"]) == 1000  # stopped at the first gate


@pytest.mark.parametrize("world", [1, WORLD])
def test_identifiable_fit_predict_mesh(runs, world):
    _check(runs, "identifiable", world, {"adrf": CLOSE, "ci": CLOSE, "data_z": TABLE,
                                         "data_u": dict(rtol=0, atol=0), "prior": NETS})


@pytest.mark.parametrize("world", [1, WORLD])
def test_fullmcmc_mesh_predict_matches_single_device(runs, world):
    w = dict(rtol=2e-3, atol=2e-4)
    _check(runs, "fullmcmc", world, {"g": w, "h": w, "f": w, "adrf": dict(rtol=2e-3, atol=2e-3),
                                     "ci": dict(rtol=2e-3, atol=2e-3), "draws": TABLE})


@pytest.mark.parametrize("world", [1, WORLD])
def test_public_bgm_predict_mesh(runs, world):
    got, _ = _check(runs, "bgm_predict", world, {"plain.": CLOSE, "bnn.": CLOSE})
    for tag in ("plain", "bnn"):
        assert got[f"{tag}.imputed"].shape == (16, 4)
        assert not np.any(np.isnan(got[f"{tag}.imputed"]))
        assert got[f"{tag}.intervals"].shape == (16, 1, 2)


@pytest.mark.parametrize("world", [1, WORLD])
def test_public_mnist_predict_mesh(runs, world):
    """The chains of the subject batch share channel BatchNorm's statistics
    over every rank's rows."""
    got, _ = _check(runs, "mnist_predict", world, {"imputed": CLOSE, "intervals": CLOSE,
                                                   "data_z": TABLE})
    assert got["imputed"].shape == (8, 28, 28, 1) and got["intervals"].shape == (8, 64, 2)
    filled = got["imputed"][:, 10:18, 10:18, :]
    assert np.all((filled >= 0.0) & (filled <= 1.0))


@pytest.mark.parametrize("world", [1, WORLD])
def test_ensemble_members_take_the_mesh(runs, world):
    _check(runs, "ensemble", world, {"adrf": CLOSE, "ci": CLOSE})


def test_sharded_train_step_matches_jax(runs):
    """The port's full-batch step in a world of four against JAX's
    ``make_sharded_causal_train_step`` on the 8-device CPU mesh, from
    ``__graft_entry__._tiny_setup``'s nets and data."""
    from bayesgm_tpu.ops import optim as joptim
    from bayesgm_tpu.parallel import make_mesh, replicate, shard_rows
    from bayesgm_tpu.parallel.sharded import make_sharded_causal_train_step

    cfg, nets, (x, y, v), z = _graft_entry()._tiny_setup()
    mesh = make_mesh(8)
    opts = replicate({k: joptim.adam_init(nets[k]) for k in ("g", "f", "h")}, mesh)
    z_opt = joptim.TableAdamState(m=shard_rows(np.zeros_like(z), mesh),
                                  v=shard_rows(np.zeros_like(z), mesh),
                                  t=replicate(jnp.zeros((), jnp.int32), mesh))
    step = make_sharded_causal_train_step(cfg, mesh)
    nets2, _, z2, z_opt2, losses = step(replicate(nets, mesh), opts, shard_rows(z, mesh), z_opt,
                                        tuple(shard_rows(a, mesh) for a in (x, y, v)),
                                        jax.random.PRNGKey(1))
    got = _result(runs, "jax_parity_step", WORLD)
    tol = dict(rtol=1e-4, atol=1e-5)
    for k, val in losses.items():
        np.testing.assert_allclose(got[f"loss.{k}"], np.asarray(val), err_msg=k, **tol)
    for k, want in (("z", z2), ("m", z_opt2.m), ("v", z_opt2.v)):
        np.testing.assert_allclose(got[k], np.asarray(want), err_msg=k, **tol)
    want_nets = tckpt.flatten({"nets": jax.tree.map(np.asarray, nets2)})
    assert set(want_nets) <= set(got)
    for k, want in want_nets.items():
        np.testing.assert_allclose(got[k], want, err_msg=k, **tol)
