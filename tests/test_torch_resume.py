"""Full-state checkpoints, exact resume and the metrics log of the port's
``CausalBGM``, held against JAX's ``tests/test_resume.py`` and against the
JAX package's own files:

- fit 4 epochs, against fit 2 and a new instance resuming to 4 (plain and
  BNN nets, continuous and binary), and with ``lr_decay`` a run killed in an
  evaluation and resumed: the nets, the latent table and its Adam state,
  both generators, the best and SWA snapshots are equal bit for bit;
- the file has the keys of a JAX full-state checkpoint of the same config,
  with the two generator states in place of JAX's key, and JAX reads every
  leaf; JAX's ``__init__`` restores the nets from the port's folder;
- each package's fit on the other's full-state file, and the port's on a
  ``save_weights`` file, falls back to the nets restored in ``__init__``;
- the metrics log has JAX's records."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bayesgm_tpu.models import causalbgm as jcb  # noqa: E402
from bayesgm_tpu.utils import checkpoint as jckpt  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from bayesgm_torch.ops import optim as toptim  # noqa: E402
from bayesgm_torch.utils import checkpoint as tckpt  # noqa: E402
from bayesgm_torch.utils.profiling import MetricsLogger  # noqa: E402
from _torch_parity import FlipoutDraws  # noqa: E402

torch.set_num_threads(2)

FIT_KW = dict(batch_size=16, epochs_per_eval=1, use_egm_init=False, verbose=0)
# f32 forward values summed in another order than XLA's, as tests/test_torch_fit.py
VAL_TOL = dict(rtol=1e-5, atol=1e-5)


def _data(n=64, v_dim=4, binary=False, seed=0):
    """The data of JAX's tests/test_resume.py."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, v_dim).astype("float32")
    x = ((rng.rand(n, 1) < 0.5) if binary else rng.rand(n, 1)).astype("float32")
    y = (x + v[:, :1] + 0.1 * rng.randn(n, 1)).astype("float32")
    return x, y, v


def _params(tmpdir, **kw):
    p = dict(v_dim=4, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="resume",
             output_dir=str(tmpdir), use_bnn=False, g_units=[8], e_units=[8], f_units=[8],
             h_units=[8], dz_units=[8], save_res=False, save_model=True)
    p.update(kw)
    return p


def _port(tmpdir, seed=7, **kw):
    return tcb.CausalBGM(_params(tmpdir, **kw), timestamp="ts", random_seed=seed, device="cpu")


def _file(model, epoch):
    return os.path.join(model.checkpoint_path, f"ckpt-{epoch}.npz")


def _assert_files_equal(path_a, path_b, skip=()):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if not k.startswith(skip):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_models_equal(a, b, swa=True):
    for k in tcb.NET_NAMES:
        for p, q in zip(a.nets[k].parameters(), b.nets[k].parameters()):
            assert torch.equal(p, q), k
        for p, q in zip(a.best_nets[k].parameters(), b.best_nets[k].parameters()):
            assert torch.equal(p, q), k
        if swa:
            for p, q in zip(a.swa_nets[k].parameters(), b.swa_nets[k].parameters()):
                assert torch.equal(p, q), k
    assert torch.equal(a.data_z, b.data_z)
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    assert torch.equal(a._host_gen.get_state(), b._host_gen.get_state())
    assert a.best_epoch == b.best_epoch
    np.testing.assert_array_equal(a.best_causal_pre, b.best_causal_pre)


@pytest.mark.parametrize("use_bnn,binary", [(False, False), (True, False), (False, True)],
                         ids=["plain", "bnn", "plain-binary"])
def test_resume_is_exact(tmp_path, use_bnn, binary):
    """JAX's test_causalbgm_resume_exact: 4 epochs against 2 + a resumed 2.
    The last files (z_opt and every Adam state too) are equal but for the
    SWA snapshot, whose tail half starts at epoch epochs // 2 of each call."""
    data = _data(binary=binary)
    kw = dict(use_bnn=use_bnn, binary_treatment=binary)
    ma = _port(tmp_path / "a", **kw)
    ma.fit(data, epochs=4, **FIT_KW)
    mb1 = _port(tmp_path / "b", **kw)
    mb1.fit(data, epochs=2, **FIT_KW)
    mb2 = _port(tmp_path / "b", **kw)
    mb2.fit(data, epochs=4, **FIT_KW)
    _assert_models_equal(ma, mb2, swa=False)
    _assert_files_equal(_file(ma, 4), _file(mb2, 4), skip=("['swa_nets']", "['swa_count']"))


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "bnn"])
def test_resume_after_a_kill_with_lr_decay(tmp_path, monkeypatch, use_bnn):
    """JAX's test_causalbgm_resume_with_lr_decay_and_swa: the schedule runs
    over the call's epochs, so the interruption is a kill in the evaluate of
    epoch 3; the resumed run replays the uninterrupted one, SWA included."""
    data = _data()
    kw = dict(use_bnn=use_bnn, lr_decay="cosine")
    ma = _port(tmp_path / "a", **kw)
    ma.fit(data, epochs=4, **FIT_KW)

    mb1 = _port(tmp_path / "b", **kw)
    calls, orig = [0], tcb.CausalBGM.evaluate

    def dying_evaluate(self, *a, **k):
        calls[0] += 1
        if calls[0] > 3:  # epochs 0..2 evaluated and checkpointed, die at 3
            raise RuntimeError("simulated kill")
        return orig(self, *a, **k)

    monkeypatch.setattr(tcb.CausalBGM, "evaluate", dying_evaluate)
    with pytest.raises(RuntimeError, match="simulated kill"):
        mb1.fit(data, epochs=4, **FIT_KW)
    monkeypatch.undo()
    assert sorted(os.listdir(mb1.checkpoint_path)) == [f"ckpt-{e}.npz" for e in range(3)]

    mb2 = _port(tmp_path / "b", **kw)
    mb2.fit(data, epochs=4, **FIT_KW)
    assert ma._swa_count == mb2._swa_count > 0
    _assert_models_equal(ma, mb2)
    _assert_files_equal(_file(ma, 4), _file(mb2, 4))


def test_resume_skips_the_egm_and_prints_where_it_resumes(tmp_path, capsys):
    data = _data()
    m1 = _port(tmp_path, use_bnn=True)
    m1.fit(data, epochs=1, epochs_per_eval=1, batch_size=16, egm_n_iter=3,
           egm_batches_per_eval=2, verbose=0)
    capsys.readouterr()
    m2 = _port(tmp_path, use_bnn=True)
    m2.fit(data, epochs=2, epochs_per_eval=1, batch_size=16, egm_n_iter=3,
           egm_batches_per_eval=2, verbose=0)
    out = capsys.readouterr().out
    assert "Latest checkpoint restored!!" in out
    assert "Resuming training from checkpoint at epoch 1." in out
    assert "EGM Initialization" not in out and m2.egm_losses is None
    assert tckpt.checkpoint_step(tckpt.latest_checkpoint(m2.checkpoint_path)) == 2


def _jax(tmpdir, seed=7, **kw):
    return jcb.CausalBGM(_params(tmpdir, **kw), timestamp="ts", random_seed=seed)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "bnn"])
def both_files(request, tmp_path_factory):
    """A port and a JAX fit of the same config (2 epochs, save_model), each
    in its own folder."""
    tmp = tmp_path_factory.mktemp("files")
    data = _data()
    tm = _port(tmp / "port", use_bnn=request.param)
    tm.fit(data, epochs=2, **FIT_KW)
    jm = _jax(tmp / "jax", use_bnn=request.param)
    jm.fit(data, epochs=2, **FIT_KW)
    return dict(tmp=tmp, use_bnn=request.param, data=data, port=tm, jax=jm,
                port_file=_file(tm, 2), jax_file=jckpt.latest_checkpoint(jm.checkpoint_path))


def test_port_file_has_the_jax_keys(both_files):
    with np.load(both_files["port_file"]) as p, np.load(both_files["jax_file"]) as j:
        port_keys, jax_keys = set(p.files), set(j.files)
    assert port_keys == (jax_keys - {"['key']"}) | {"['gen']", "['host_gen']"}


def test_jax_restore_reads_every_port_leaf(both_files):
    """JAX restore_checkpoint with its full-state template less the key
    reads every leaf of the port's file at the template's shapes; the
    restored values are the port's."""
    jm = both_files["jax"]
    template = jm._full_state_template(64)
    del template["key"]
    state = jckpt.restore_checkpoint(both_files["port_file"], template)
    tm = both_files["port"]
    with np.load(both_files["port_file"]) as f:
        for path, leaf in jax.tree_util.tree_leaves_with_path(state):
            key = jax.tree_util.keystr(path)
            np.testing.assert_array_equal(np.asarray(leaf), f[key].reshape(np.shape(leaf)))
    np.testing.assert_array_equal(np.asarray(state["data_z"]), tm.data_z.numpy())
    assert int(state["epoch"]) == 2 and int(state["opt_ge"].t) == 0
    assert int(state["z_opt"].t) == int(state["opts"]["g"].t) == 3 * 4  # epochs 0..2 x 4 batches
    for k in ("g", "f", "h"):
        got = bridge.params_to_tree(tm.nets[k], tm.opts[k].m)
        for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                    jax.tree_util.tree_leaves_with_path(state["opts"][k].m)):
            assert pa == pb
            np.testing.assert_array_equal(a, np.asarray(b))


def test_jax_init_restores_the_port_nets(both_files, monkeypatch):
    """JAX CausalBGM.__init__ on the port's folder holds the port's nets and
    gives the port's log posterior (f32 tolerance, the same injected
    flipout draws)."""
    tm = both_files["port"]
    jm = jcb.CausalBGM(_params(both_files["tmp"] / "port", use_bnn=both_files["use_bnn"]),
                       timestamp="ts", random_seed=99)
    for k in tcb.NET_NAMES:
        want = bridge.net_to_numpy(tm.nets[k])
        for a, b in zip(jax.tree.leaves(jm.nets[k]), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)
    x, y, v = _data(n=20)
    z = np.random.default_rng(2).normal(size=(20, 5)).astype(np.float32)
    draws = FlipoutDraws(monkeypatch)
    want = jm.get_log_posterior(x, y, v, z, key=jax.random.PRNGKey(6))
    got = tm.get_log_posterior(x, y, v, z)
    assert draws.jax_calls == draws.port_calls == (3 if both_files["use_bnn"] else 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL_TOL)


def test_each_package_falls_back_on_the_others_file(both_files, tmp_path, capsys):
    """A JAX full-state file has no ['gen'], a port file no ['key']: each
    package's fit prints why it cannot resume, keeps the nets its __init__
    restored and trains from epoch 0."""
    for src, make in (("jax_file", _port), ("port_file", _jax)):
        folder = tmp_path / src
        model_dir = os.path.join(str(folder), "checkpoints", "resume", "ts")
        os.makedirs(model_dir)
        shutil.copy(both_files[src], os.path.join(model_dir, "ckpt-2.npz"))
        m = make(folder, seed=3, use_bnn=both_files["use_bnn"])
        capsys.readouterr()
        m.fit(both_files["data"], epochs=1, **FIT_KW)
        out = capsys.readouterr().out
        assert "Full-state resume unavailable (" in out, src
        assert "Resuming" not in out and "Random initialization" in out, src
        assert sorted(os.listdir(model_dir)) == ["ckpt-0.npz", "ckpt-1.npz", "ckpt-2.npz"]


def test_weights_files_take_the_fallback_or_return_early(tmp_path, capsys):
    """A save_weights file of a fitted model (nets and data_z, no optimizer
    states) named ckpt-*.npz takes the fallback; one without data_z (an
    unfitted model) returns at once, silently."""
    data = _data()
    src = _port(tmp_path / "src", use_bnn=True)
    src.fit(data, epochs=0, **FIT_KW)
    for fitted in (True, False):
        folder = tmp_path / f"w{fitted}"
        model_dir = os.path.join(str(folder), "checkpoints", "resume", "ts")
        os.makedirs(model_dir)
        if not fitted:
            src.data_z = None
        src.save_weights(os.path.join(model_dir, "ckpt-5.npz"))
        m = _port(folder, seed=3, use_bnn=True)
        for k in tcb.NET_NAMES:
            for p, q in zip(m.nets[k].parameters(), src.nets[k].parameters()):
                assert torch.equal(p, q)
        capsys.readouterr()
        m.fit(data, epochs=0, **FIT_KW)
        out = capsys.readouterr().out
        assert ("Full-state resume unavailable" in out) == fitted
        assert "Random initialization" in out


def test_save_checkpoint_keeps_the_newest_five_and_restores_namedtuples(tmp_path):
    d = str(tmp_path)
    state = toptim.TableAdamState(m=torch.ones((3, 2)), v=np.zeros((3, 2), np.float32),
                                  t=np.int32(4))
    tree = {"a": [np.arange(3.0), {"b": np.int32(7)}], "z": state}
    for step in (3, 11, 1, 7, 9, 5, 2):
        path = tckpt.save_checkpoint(d, step, tree)
        assert path == os.path.join(d, f"ckpt-{step}.npz") and not os.path.exists(path + ".tmp")
    kept = sorted(tckpt.checkpoint_step(f) for f in os.listdir(d))
    assert kept == [3, 5, 7, 9, 11]
    assert sorted(kept) == sorted(jckpt.checkpoint_step(f) for f in os.listdir(d))
    path = os.path.join(d, "ckpt-11.npz")
    with np.load(path) as f:
        assert set(f.files) == {"['a'][0]", "['a'][1]['b']", "['z'].m", "['z'].v", "['z'].t"}
    template = {"a": [np.zeros(3), {"b": np.int32(0)}],
                "z": toptim.TableAdamState(m=np.zeros((3, 2), np.float32),
                                           v=np.zeros((3, 2), np.float32), t=np.int32(0))}
    back = tckpt.restore_checkpoint(path, template)
    assert isinstance(back["z"], toptim.TableAdamState) and int(back["z"].t) == 4
    np.testing.assert_array_equal(back["z"].m, np.ones((3, 2)))
    assert back["a"][1]["b"].dtype == np.int32
    with pytest.raises(KeyError, match=r"\['c'\]"):
        tckpt.restore_checkpoint(path, {"c": np.zeros(1)})


@pytest.mark.parametrize("use_bnn", [False, True], ids=["plain", "bnn"])
def test_metrics_log_matches_jax(tmp_path, use_bnn):
    """The same fit in both packages logs the same (event, epoch) records
    with the same keys; every value is finite."""
    data = _data()
    logs = {}
    for name, make in (("port", _port), ("jax", _jax)):
        path = str(tmp_path / name / "m.jsonl")
        m = make(tmp_path / name, use_bnn=use_bnn, save_model=False, metrics_path=path)
        m.fit(data, epochs=3, **dict(FIT_KW, epochs_per_eval=2))
        logs[name] = MetricsLogger(path).read()
    shape = {k: [(r["event"], r["epoch"], sorted(r)) for r in recs] for k, recs in logs.items()}
    assert shape["port"] == shape["jax"] == [
        ("eval", 0.0, ["epoch", "event", "mse_v", "mse_x", "mse_y", "time"]),
        ("eval", 2.0, ["epoch", "event", "mse_v", "mse_x", "mse_y", "time"])]
    assert all(np.isfinite(r[k]) for r in logs["port"] for k in ("mse_x", "mse_y", "mse_v"))


def test_step_timer_and_trace(tmp_path):
    """StepTimer leaves out the warm-up steps; trace writes a Chrome trace
    of the block (the CPU's activity here)."""
    from bayesgm_torch.utils.profiling import StepTimer, trace

    timer = StepTimer(warmup=2)
    assert np.isnan(timer.steps_per_sec)
    for _ in range(5):
        timer.step(n=3)
    assert timer._timed == 9 and timer.steps_per_sec > 0
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
