"""The port restores the nets of a JAX checkpoint in ``CausalBGM.__init__``,
as the JAX package does: a JAX fit with ``save_model=True`` writes
``ckpt-*.npz``, and a port model built on the same folder holds that
checkpoint's nets, whatever its own seed, and gives JAX's log posterior.
Also the numpy-only checkpoint helpers and the bridge's key parser."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bayesgm_tpu.datasets import Sim_Hirano_Imbens_sampler  # noqa: E402
from bayesgm_tpu.models import causalbgm as jcb  # noqa: E402
from bayesgm_tpu.utils import checkpoint as jckpt  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from bayesgm_torch.utils import checkpoint as tckpt  # noqa: E402
from _torch_parity import FlipoutDraws  # noqa: E402

torch.set_num_threads(2)

# f32 forward values summed in another order than XLA's (dots 5 to 16 wide),
# as tests/test_torch_fit.py
VAL_TOL = dict(rtol=1e-5, atol=1e-5)
TIMESTAMP = "ckpt_test"


def _params(tmp_path, use_bnn, **kw):
    p = dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="t",
             output_dir=str(tmp_path), save_res=False, use_bnn=use_bnn, g_units=[16, 16],
             e_units=[16], h_units=[8], f_units=[8], dz_units=[8], lr=1e-2, lr_theta=1e-2,
             lr_z=1e-2)
    p.update(kw)
    return p


def _data(n):
    return Sim_Hirano_Imbens_sampler(batch_size=32, N=n, v_dim=6, seed=0).load_all()


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module", params=[True, False], ids=["bnn", "plain"])
def jax_checkpoint(request, tmp_path_factory):
    """A JAX model fitted 2 epochs with save_model=True, its folder and the
    JAX model restored from that folder with another seed."""
    use_bnn = request.param
    tmp = tmp_path_factory.mktemp("bnn" if use_bnn else "plain")
    jm = jcb.CausalBGM(_params(tmp, use_bnn, save_model=True), timestamp=TIMESTAMP,
                       random_seed=0)
    jm.fit(_data(64), epochs=2, epochs_per_eval=1, batch_size=32, use_egm_init=False,
           verbose=0)
    restored = jcb.CausalBGM(_params(tmp, use_bnn), timestamp=TIMESTAMP, random_seed=99)
    return dict(tmp=tmp, use_bnn=use_bnn, path=jckpt.latest_checkpoint(jm.checkpoint_path),
                restored=restored)


def test_init_restores_the_latest_checkpoints_nets(jax_checkpoint, capsys):
    ck = jax_checkpoint
    tm = tcb.CausalBGM(_params(ck["tmp"], ck["use_bnn"]), timestamp=TIMESTAMP,
                       random_seed=99, device="cpu")
    assert "Latest checkpoint restored!!" in capsys.readouterr().out
    assert tckpt.latest_checkpoint(tm.checkpoint_path) == ck["path"]
    want = tckpt.read_nets(ck["path"])
    for k in tcb.NET_NAMES:
        got_leaves = _leaves(bridge.net_to_numpy(tm.nets[k]))
        want_leaves = _leaves(want[k])
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, a), (_, b) in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(a, b, err_msg=f"{k}{jax.tree_util.keystr(path)}")
    # the JAX model restored from the same folder holds the same nets
    for k in tcb.NET_NAMES:
        for (_, a), (_, b) in zip(_leaves(ck["restored"].nets[k]),
                                  _leaves(want[k])):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_restored_log_posterior_matches_jax(jax_checkpoint, monkeypatch):
    ck = jax_checkpoint
    tm = tcb.CausalBGM(_params(ck["tmp"], ck["use_bnn"]), timestamp=TIMESTAMP,
                       random_seed=99, device="cpu")
    x, y, v = _data(20)
    z = np.random.default_rng(2).normal(size=(20, 5)).astype(np.float32)
    draws = FlipoutDraws(monkeypatch)
    want = ck["restored"].get_log_posterior(x, y, v, z, key=jax.random.PRNGKey(6))
    got = tm.get_log_posterior(x, y, v, z)
    assert draws.jax_calls == draws.port_calls == (3 if ck["use_bnn"] else 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL_TOL)


def test_fit_still_refuses_to_resume(jax_checkpoint):
    ck = jax_checkpoint
    tm = tcb.CausalBGM(_params(ck["tmp"], ck["use_bnn"]), timestamp=TIMESTAMP,
                       random_seed=99, device="cpu")
    with pytest.raises(NotImplementedError, match="resuming"):
        tm.fit(_data(8), epochs=1, egm_n_iter=1)


def test_load_npz_reads_a_full_state_checkpoint(jax_checkpoint):
    """Every group of the JAX bundle parses, the Adam NamedTuples' fields
    (.m, .v, .t) included, and the nets come out as port nets."""
    path = jax_checkpoint["path"]
    tree = bridge.npz_tree(path)
    assert {"nets", "opts", "opt_d", "opt_ge"} <= set(tree)
    assert {"m", "v", "t"} <= set(tree["opt_d"])
    with np.load(path) as data:
        assert np.array_equal(tree["opt_d"]["m"]["layers"][0]["w"],
                              data["['opt_d'].m['layers'][0]['w']"])
    bundle = bridge.load_npz(path)
    assert set(bundle["nets"]) == set(tcb.NET_NAMES)
    assert tckpt.has_group(path, "opt_d") and not tckpt.has_group(path, "no_such_group")


@pytest.mark.parametrize("key,parts", [
    ("['opt_d'].m['bn'][0]['beta']", ["opt_d", "m", "bn", 0, "beta"]),
    ("['opts']['g'].v['layers'][3]['rho']", ["opts", "g", "v", "layers", 3, "rho"]),
    ("['opt_ge'].t", ["opt_ge", "t"]),
    ("['nets']['g']['layers'][0]['loc']", ["nets", "g", "layers", 0, "loc"]),
])
def test_key_parser_reads_attribute_parts(key, parts):
    assert bridge._parse_key(key) == parts


@pytest.mark.parametrize("key", ["['a'].", "['a']..m", "['a'].0", "m['a']", "['a'"])
def test_key_parser_rejects_malformed_keys(key):
    with pytest.raises(ValueError, match="unparseable"):
        bridge._parse_key(key)


def test_latest_checkpoint_picks_the_highest_step(tmp_path):
    for name in ("ckpt-2.npz", "ckpt-10.npz", "ckpt-9.npz", "ckpt-11.npz.tmp", "other.npz"):
        open(tmp_path / name, "wb").close()
    path = tckpt.latest_checkpoint(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "ckpt-10.npz")
    assert tckpt.checkpoint_step(path) == 10
    assert path == jckpt.latest_checkpoint(str(tmp_path))
    with pytest.raises(ValueError):
        tckpt.checkpoint_step(str(tmp_path / "other.npz"))


@pytest.mark.parametrize("state", ["missing", "empty", "other_files"])
def test_no_restore_without_a_checkpoint(tmp_path, capsys, state):
    params = _params(tmp_path, True)
    folder = os.path.join(str(tmp_path), "checkpoints", "t", TIMESTAMP)
    if state != "missing":
        os.makedirs(folder)
    if state == "other_files":
        open(os.path.join(folder, "ckpt-x.npz"), "wb").close()
    assert tckpt.latest_checkpoint(folder) is None
    a = tcb.CausalBGM(params, timestamp=TIMESTAMP, random_seed=3, device="cpu")
    b = tcb.CausalBGM(params, timestamp=TIMESTAMP, random_seed=3, device="cpu")
    assert "restored" not in capsys.readouterr().out
    fresh = tcb.CausalBGM(params, timestamp="elsewhere", random_seed=3, device="cpu")
    for k in tcb.NET_NAMES:
        for p, q, r in zip(a.nets[k].parameters(), b.nets[k].parameters(),
                           fresh.nets[k].parameters()):
            assert torch.equal(p, q) and torch.equal(p, r)
