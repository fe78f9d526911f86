"""The port's mesh helpers and per-rank kernel paths in gloo worlds on the
CPU, case for case with ``tests/test_parallel.py``: each case runs in a
world of one, which must equal the path without a mesh bit for bit, and in
a world of eight (JAX's mesh size), held against the path without a mesh
at ``tests/test_parallel.py``'s tolerances.  n = 5 over eight ranks leaves
ranks without rows; n = 37 splits unevenly.  One spawn per world runs every
case (``tests/_torch_dist_workers.py``)."""

import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_dist_workers as W  # noqa: E402

WORLD = 8
NAMES = ["helpers", "train_step", "sharded_mh", "param_logp", "bnn_paired_rho20", "latent_vg"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh8"))
    for world in (1, WORLD):
        W.spawn(world, NAMES, out, timeout=300)
    return out


def _ranks(runs, name, world):
    return [W.load(runs, name, world, r) for r in range(world)]


def _same_on_every_rank(runs, name, world, keys=None):
    first, *rest = _ranks(runs, name, world)
    for other in rest:
        for k in keys or first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    return first


def _bit_equal(got, ref, keys=None):
    for k in keys or ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("world", [1, WORLD])
def test_mesh_and_sharding_helpers(runs, world):
    for r, got in enumerate(_ranks(runs, "helpers", world)):
        assert int(got["raised"]) == 1 and int(got["size"]) == world
        c = -(-16 // world)
        lo, hi = min(r * c, 16), min((r + 1) * c, 16)
        assert list(got["lo_hi"]) == [lo, hi]
        arr = np.arange(64, dtype=np.float32).reshape(16, 4)
        np.testing.assert_array_equal(got["local"], arr[lo:hi])
        np.testing.assert_array_equal(got["gathered"], arr)
        c5 = -(-5 // world)
        assert list(got["five_lo_hi"]) == [min(r * c5, 5), min((r + 1) * c5, 5)]
        t5 = np.arange(15, dtype=np.float32).reshape(5, 3)
        np.testing.assert_array_equal(got["five_gathered"], t5)
        np.testing.assert_array_equal(got["batch5"], t5[[4, 0, 2]])
        np.testing.assert_array_equal(got["batch5b"], t5[[1, 3]])
        assert float(got["total"][0]) == 5.0
        assert list(got["spec"]) == ["data", "None", "None"]
        assert bool(got["replicated"]) and bool(got["same_fn"])
        # rowwise_shard_map pads 5 rows to a multiple of the world; each
        # row's seed word carries the rank that held it
        holder = np.arange(5) // c5
        np.testing.assert_array_equal(got["mapped"], t5 * 2 + (11 + holder)[:, None])
    if world == WORLD:
        assert list(_ranks(runs, "helpers", world)[7]["five_lo_hi"]) == [5, 5]  # empty rank


@pytest.mark.parametrize("world", [1, WORLD])
def test_sharded_train_step_matches_single_device(runs, world):
    got = _same_on_every_rank(runs, "train_step", world)
    ref = W.load_ref(runs, "train_step")
    if world == 1:
        _bit_equal(got, ref)
        return
    for pre in ("", "deconf."):  # without and with deconf_weight
        for k in ref:
            if k.startswith(pre + "loss."):
                np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(got[pre + "z"], ref[pre + "z"], rtol=2e-3, atol=2e-5)
        for k in ref:
            if k.startswith(pre) and k[len(pre)] in "ghf" and "." in k[len(pre):]:
                np.testing.assert_allclose(got[k], ref[k], rtol=2e-3, atol=2e-6, err_msg=k)
            if k.startswith(pre + "opt."):  # Adam's first moments: 0.1 x each gradient
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", [1, WORLD])
def test_sharded_mh_predict(runs, world):
    got = _same_on_every_rank(runs, "sharded_mh", world)
    ref = W.load_ref(runs, "sharded_mh")
    assert got["effects"].shape == (20, 3) and np.all(np.isfinite(got["effects"]))
    assert 0.0 <= float(got["rate"]) <= 1.0
    if world == 1:
        _bit_equal(got, ref)
    else:
        np.testing.assert_allclose(got["effects"], ref["effects"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("world", [1, WORLD])
def test_mesh_param_logp_runs_fused_kernel_per_shard(runs, world):
    """K4's and K1's wrappers per rank on n = 37 rows.  K4 is deterministic:
    every world gives the one-device value.  K1's signs are drawn per rank
    from a rank-mixed seed, so past one rank it agrees in law only (its
    deterministic limit is the next test)."""
    got = _same_on_every_rank(runs, "param_logp", world)
    ref = W.load_ref(runs, "param_logp")
    assert not bool(got["bnn.multi_step"]) and bool(ref["bnn.multi_step"])
    assert got["plain.lp"].shape == (37,) and got["bnn.plp"].shape == (2, 37)
    if world == 1:
        _bit_equal(got, ref, ["plain.lp", "bnn.lp", "bnn.plp"])
        return
    np.testing.assert_allclose(got["plain.lp"], ref["plain.lp"], rtol=2e-4, atol=2e-4)
    assert np.all(np.isfinite(got["bnn.lp"])) and np.all(np.isfinite(got["bnn.plp"]))


@pytest.mark.parametrize("world", [1, WORLD])
def test_mesh_fused_latent_vg_replicated(runs, world):
    """The latent value-and-gradient (K3's wrapper) replicated: every rank's
    output is the one-device output, bit for bit."""
    ref = W.load_ref(runs, "latent_vg")
    for got in _ranks(runs, "latent_vg", world):
        _bit_equal(got, ref)


@pytest.mark.parametrize("world", [1, WORLD])
def test_mesh_bnn_paired_fused_path_matches_composite(runs, world):
    """K1 paired and unpaired per rank at rho = -20, where the weight noise
    vanishes: every rank's half-stacks give the composite's value."""
    got = _same_on_every_rank(runs, "bnn_paired_rho20", world)
    for k, want in (("prop", "want_prop"), ("cur", "want_cur"), ("lp", "want_prop")):
        np.testing.assert_allclose(got[k], got[want], rtol=2e-4, atol=2e-4, err_msg=k)
    if world == 1:
        _bit_equal(got, W.load_ref(runs, "bnn_paired_rho20"))
