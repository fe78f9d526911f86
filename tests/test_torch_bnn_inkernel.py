"""K6 (the flipout-BNN log-posterior with in-kernel eps), K7 (K6 plus its
z-gradient) and K5 (n_steps MH steps in one launch): the port's plain
versions against the JAX kernels in interpret mode, with the TPU PRNG
replaced by a counter hash whose draws are replayed into the port, and the
port's Philox draws and row-block sizing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import _pk_bnn_inkernel as jk  # noqa: E402
from bayesgm_tpu.ops import _pk_util as jpk  # noqa: E402
from bayesgm_torch.ops import _pk_bnn_inkernel as tk  # noqa: E402
from bayesgm_torch.ops import _pk_traced_common as ttc  # noqa: E402
from bayesgm_torch.ops import _pk_util as tpk  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from _torch_parity import ReplayedDraws  # noqa: E402
from _torch_parity import stub_prng as _stub_prng  # noqa: E402
from test_torch_bnn_hosteps import _cfgs, _data, _jax_nets, _t  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)  # as the JAX kernel's own mirror test
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)  # the JAX mirror test of its hand-written backward


def _flats(nets):
    """Numpy ``(loc, sigma, b)`` flats per chain and the layer dims, from the
    JAX flatten."""
    flats = [[np.asarray(a) for a in jpk.flatten_flipout_params(nets[k])] for k in "ghf"]
    dims = [jpk.flipout_mlp_layer_dims(nets[k]) for k in "ghf"]
    return flats, dims


def _tflats(flats):
    return [[_t(a) for a in f] for f in flats]


def _variant(variant):
    jcfg, tcfg = _cfgs(binary=variant == "binary",
                       sigma_v=0.5 if variant in ("fixed_sigma_v", "fixed_sigmas") else None)
    if variant == "fixed_sigmas":
        jcfg, tcfg = (c._replace(sigma_x=0.7, sigma_y=0.3) for c in (jcfg, tcfg))
    return jcfg, tcfg


SEED0 = torch.zeros(2, dtype=torch.int32)


@pytest.mark.parametrize("variant", ["continuous", "binary", "fixed_sigma_v"])
def test_k6_plain_matches_jax_kernel_interpret(monkeypatch, variant):
    jcfg, tcfg = _variant(variant)
    flats, dims = _flats(_jax_nets(jcfg))
    n, block = 32, 16  # two row blocks
    z, x, y, v = _data(jcfg, n, binary=variant == "binary")

    _stub_prng(monkeypatch)
    fused = jk.make_fused_causal_logp_bnn(jcfg, *dims, block_rows=block, interpret=True)
    want = np.asarray(fused(z, x, y, v, jnp.zeros((2,), jnp.int32), *flats))

    got = tk.logp_plain(tcfg, _t(z), _t(x), _t(y), _t(v), SEED0, *_tflats(flats), block,
                        draws=ReplayedDraws(dims, block)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", ["continuous", "binary", "fixed_sigmas"])
def test_k7_plain_matches_jax_kernel_interpret(monkeypatch, variant):
    """K7's plain version (autograd of K6's) against the JAX K7 in interpret
    mode under the same draws: values at 2e-5, gradients at 5e-4 / 5e-5."""
    jcfg, tcfg = _variant(variant)
    flats, dims = _flats(_jax_nets(jcfg))
    n, block = 32, 16
    z, x, y, v = _data(jcfg, n, binary=variant == "binary", seed=4)

    _stub_prng(monkeypatch)
    fused = jk.make_fused_causal_logp_and_grad_bnn(jcfg, *dims, block_rows=block,
                                                   interpret=True)
    neg_j, grad_j = (np.asarray(a) for a in
                     fused(z, x, y, v, jnp.zeros((2,), jnp.int32), *flats))

    args = (tcfg, _t(z), _t(x), _t(y), _t(v), SEED0, *_tflats(flats), block)
    neg_t, grad_t = tk.logp_and_grad_plain(*args, draws=ReplayedDraws(dims, block))
    assert grad_t.shape == (n, sum(tcfg.z_dims))
    np.testing.assert_allclose(neg_t.numpy(), neg_j, **TOL)
    np.testing.assert_allclose(grad_t.numpy(), grad_j, **GRAD_TOL)
    # K7's value is K6's on the same inputs and draws
    k6 = tk.logp_plain(*args, draws=ReplayedDraws(dims, block))
    np.testing.assert_array_equal(neg_t.numpy(), k6.numpy())


@pytest.mark.parametrize("n_steps", [1, 3])
def test_k5_plain_matches_jax_kernel_interpret(monkeypatch, n_steps):
    """K5's plain version against the JAX K5 in interpret mode: 24 rows in
    blocks of 16 (the JAX kernel pads to 32, and the padding must not
    count), the same draws at every step (the JAX loop body is traced once).
    Counts exactly, z and logp at 2e-5."""
    jcfg, tcfg = _cfgs()
    flats, dims = _flats(_jax_nets(jcfg))
    n, block = 24, 16
    z, x, y, v = _data(jcfg, n, seed=6)
    q_sd = 0.7

    stream = _stub_prng(monkeypatch)
    fused = jk.make_fused_mh_steps_bnn(jcfg, *dims, n_steps=n_steps, block_rows=block,
                                       interpret=True)
    z_j, lp_j, c_j = (np.asarray(a) for a in fused(
        z, x, y, v, jnp.zeros((2,), jnp.int32), jnp.float32(q_sd), *flats))
    assert stream.counter == 37  # 2 + 2 x 17 + 1 draws, whatever n_steps

    z_t, lp_t, c_t = tk.mh_steps_plain(
        tcfg, _t(z), _t(x), _t(y), _t(v), SEED0, torch.tensor(q_sd), *_tflats(flats),
        n_steps, block, draws=ReplayedDraws(dims, block, mh_window=True))
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    assert 0 < c_j.sum() < n * n_steps  # some rows moved, some did not
    np.testing.assert_allclose(z_t.numpy(), z_j, **TOL)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, **TOL)


def _port_inputs(tcfg, n, seed=0):
    flats, dims = _flats(_jax_nets(tcfg))
    z, x, y, v = (_t(a) for a in _data(tcfg, n, seed=seed))
    return (z, x, y, v), _tflats(flats), dims


def test_k5_steps_use_their_own_draws_and_step_zero_is_k6():
    """With Philox draws, step 0's proposed side is K6's evaluation (ev 0) of
    the proposal; the accepted rows carry that value; later steps draw anew."""
    _, tcfg = _cfgs()
    (z, x, y, v), flats, _ = _port_inputs(tcfg, 40)
    seed, q = torch.tensor([17, -3], dtype=torch.int32), torch.tensor(0.4)
    draws = ttc.PhiloxDraws(seed)
    z1, lp1, c1 = tk.mh_steps_plain(tcfg, z, x, y, v, seed, q, *flats, 1, 32)
    u1, u2 = draws.proposal_words(40, 3, 0)
    prop = z + q * ttc._kernel_normal(u1, u2, 5)
    lp_prop = -tk.logp_plain(tcfg, prop, x, y, v, seed, *flats, 32, ev=0)
    lp_cur = -tk.logp_plain(tcfg, z, x, y, v, seed, *flats, 32, ev=1)
    acc = (z1 == prop).all(dim=1)
    assert 0 < int(acc.sum()) < 40 and float(c1[0]) == float(acc.sum())
    torch.testing.assert_close(lp1, torch.where(acc, lp_prop, lp_cur), rtol=0, atol=0)
    z3, _, c3 = tk.mh_steps_plain(tcfg, z, x, y, v, seed, q, *flats, 3, 32)
    assert float(c3[0]) == float(c1[0])  # a longer window starts the same way
    assert not torch.equal(z3, z1)  # and its later steps moved rows again


def test_philox_draws_differ_across_evaluations_steps_and_domains():
    seed = torch.tensor([2024, -31], dtype=torch.int32)
    d = ttc.PhiloxDraws(seed)
    s00 = d.sign_words(64, 13, 0, ev=0)
    assert s00.dtype == torch.int64 and int(s00.min()) >= 0 and int(s00.max()) < 2**32
    assert not torch.equal(s00, d.sign_words(64, 13, 0, ev=1))
    assert not torch.equal(s00, d.sign_words(64, 13, 1, ev=0))
    assert not torch.equal(s00, ttc.philox_sign_words(seed, 64, 13, 0))  # K1's domain
    e0 = d.eps_words(3, 8, 4, chain=0, layer=1, ev=0)[0]
    assert not torch.equal(e0, d.eps_words(3, 8, 4, chain=0, layer=1, ev=2)[0])
    assert not torch.equal(e0, d.eps_words(3, 8, 4, chain=0, layer=2, ev=0)[0])
    assert not torch.equal(e0[0], e0[1])  # each block its own eps
    p0 = d.proposal_words(64, 3, 0)
    assert not torch.equal(p0[0], d.proposal_words(64, 3, 1)[0])
    assert not torch.equal(d.accept_words(64, 0), d.accept_words(64, 1))
    # a row's draws do not depend on how many rows were drawn
    assert torch.equal(d.sign_words(100, 13, 2, 5)[:37], d.sign_words(37, 13, 2, 5))
    assert torch.equal(d.proposal_words(100, 3, 4)[1][:37], d.proposal_words(37, 3, 4)[1])


def test_kernel_normal_and_uniform_laws():
    d = ttc.PhiloxDraws(torch.tensor([5, 6], dtype=torch.int32))
    u = ttc._kernel_uniform(d.accept_words(200000, 0))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    e = ttc._kernel_normal(*d.eps_words(4, 100, 250, 0, 0, 0), 499)  # odd cols
    assert e.shape == (4, 100, 499)
    assert abs(float(e.mean())) < 0.01 and abs(float(e.std()) - 1.0) < 0.01
    # the cos and sin halves are uncorrelated
    assert abs(float((e[..., :249] * e[..., 250:]).mean())) < 0.01


def test_rows_do_not_depend_on_how_many_rows_are_evaluated():
    """Signs follow the global row and eps the row's block, so a prefix of
    the rows gives the same values alone (K6, K7's gradient, K5)."""
    _, tcfg = _cfgs()
    (z, x, y, v), flats, _ = _port_inputs(tcfg, 70)
    seed = torch.tensor([1, 2], dtype=torch.int32)
    full = tk.logp_plain(tcfg, z, x, y, v, seed, *flats, 32)
    part = tk.logp_plain(tcfg, z[:45], x[:45], y[:45], v[:45], seed, *flats, 32)
    torch.testing.assert_close(part, full[:45], rtol=1e-6, atol=1e-6)
    # rows of one block share eps: another block size changes the values
    assert not torch.allclose(tk.logp_plain(tcfg, z, x, y, v, seed, *flats, 64)[32:64],
                              full[32:64])
    q = torch.tensor(0.5)
    zf, lf, cf = tk.mh_steps_plain(tcfg, z, x, y, v, seed, q, *flats, 2, 32)
    zp, lp, _ = tk.mh_steps_plain(tcfg, z[:45], x[:45], y[:45], v[:45], seed, q, *flats, 2, 32)
    torch.testing.assert_close(zp, zf[:45], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lp, lf[:45], rtol=1e-6, atol=1e-6)


def test_k7_gradient_matches_finite_differences():
    _, tcfg = _cfgs()
    flats, _ = _flats(_jax_nets(tcfg))
    z, x, y, v = _data(tcfg, 6, seed=9)
    d = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    seed = torch.tensor([3, 4], dtype=torch.int32)
    args = (d(x), d(y), d(v), seed, *[[d(a) for a in f] for f in flats], 32)
    zt = d(z)
    _, grad = tk.logp_and_grad_plain(tcfg, zt, *args)
    h = 1e-6
    for k in range(zt.shape[1]):
        e = torch.zeros_like(zt)
        e[:, k] = h
        fd = (tk.logp_plain(tcfg, zt + e, *args) - tk.logp_plain(tcfg, zt - e, *args)) / (2 * h)
        np.testing.assert_allclose(grad[:, k].numpy(), fd.numpy(), rtol=1e-6, atol=1e-6)


def test_kink_rows_mark_pre_activations_near_zero():
    _, tcfg = _cfgs()
    (z, x, y, v), flats, _ = _port_inputs(tcfg, 300)
    args = (tcfg, z, x, y, v, torch.tensor([8, 9], dtype=torch.int32), *flats, 32)
    pre = []
    tk.logp_plain(*args, pre_acts=pre)
    assert [p.shape[1] for p in pre] == [16, 8, 8, 8]  # g's, h's and f's hidden layers
    near = torch.cat([p.abs() for p in pre], dim=1).min(dim=1).values
    k = tk.kink_rows(*args, tol=float(near.median()))
    assert torch.equal(k, near < near.median()) and 0 < int(k.sum()) < 300
    assert not bool(tk.kink_rows(*args, tol=0.0).any())


FLAGSHIP = ([10, 64, 64, 64, 64, 64, 201], [2, 64, 32, 8, 2], [3, 64, 32, 8, 2])


@pytest.mark.parametrize("dims,v_dim,want", [(FLAGSHIP, 200, (512, 256, 512)),
                                             (([5, 16, 8, 7], [2, 8, 2], [3, 8, 2]), 6,
                                              (2048, 2048, 2048))])
def test_block_rows_follow_the_jax_builders(dims, v_dim, want):
    """K6, K7 and K5 size their row block as the JAX builders do."""
    _, tcfg = _cfgs()
    z_dims = (1, 1, 1, dims[0][0] - 3)
    tcfg = tcfg._replace(v_dim=v_dim, z_dims=z_dims)
    got = (tk.make_fused_causal_logp_bnn(tcfg, *dims).block_rows,
           tk.make_fused_causal_logp_and_grad_bnn(tcfg, *dims).block_rows,
           tk.make_fused_mh_steps_bnn(tcfg, *dims, n_steps=50).block_rows)
    assert got == want
    assert tpk.bnn_block_rows(tcfg, *dims) == jpk.bnn_block_rows(tcfg, *dims) == want[0]
    for rb in (100, 3000, 10**6):
        assert tpk.pick_block_rows(rb) == jpk.pick_block_rows(rb)
    assert tpk._round_up(37, 16) == jpk._round_up(37, 16) == 48


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    _, tcfg = _cfgs()
    (z, x, y, v), flats, dims = _port_inputs(tcfg, 20)
    seed, q = torch.tensor([1, 2], dtype=torch.int32), torch.tensor(0.3)
    k6 = tk.make_fused_causal_logp_bnn(tcfg, *dims, block_rows=16)
    k7 = tk.make_fused_causal_logp_and_grad_bnn(tcfg, *dims, block_rows=16)
    k5 = tk.make_fused_mh_steps_bnn(tcfg, *dims, n_steps=2, block_rows=16)
    before = dict(tk.LAUNCHES)
    assert torch.equal(k6(z, x, y, v, seed, *flats),
                       tk.logp_plain(tcfg, z, x, y, v, seed, *flats, 16))
    for got, want in zip(k7(z, x, y, v, seed, *flats),
                         tk.logp_and_grad_plain(tcfg, z, x, y, v, seed, *flats, 16)):
        assert torch.equal(got, want)
    for got, want in zip(k5(z, x, y, v, seed, q, *flats),
                         tk.mh_steps_plain(tcfg, z, x, y, v, seed, q, *flats, 2, 16)):
        assert torch.equal(got, want)
    assert k5.n_steps == 2 and k5(z, x, y, v, seed, q, *flats)[2].shape == (2,)
    assert k5.launches == k6.launches == k7.launches == 0 and tk.LAUNCHES == before
    meta = torch.empty((4, 5), device="meta")
    for fn, extra in ((k6, ()), (k7, ()), (k5, (meta,))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, meta, meta, meta, meta, *extra, [], [], [])
    with pytest.raises(ValueError, match="CUDA int32"):
        tk.DrawsCuda(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="block_rows"):
        tk.make_fused_causal_logp_bnn(tcfg, *dims, block_rows=0)
    with pytest.raises(ValueError, match="n_steps"):
        tk.make_fused_mh_steps_bnn(tcfg, *dims, n_steps=-1)


def test_k7_switch_reads_the_kernel_source_and_takes_the_fit_batch():
    """K7's cluster form covers fit's batch of 32 rows and whole 32-row
    tiles; the switch is the kernel source's own constant, read without a
    build."""
    n = tk.k7_cluster_max_rows()
    assert isinstance(n, int) and n >= 32 and n % 32 == 0
    src = (tk.CSRC / tk._SOURCE).read_text()
    assert f"constexpr int kK7ClusterMaxRows = {n};" in src


def test_replayed_draws_cover_sixteen_layers_only():
    d = ReplayedDraws([[5, 4, 7], [2, 4, 2], [3, 4, 2]], 16)
    assert d.sign_words(20, 7, 0, 0).shape == (20, 7)
    with pytest.raises(ValueError, match="16 layers"):
        d.sign_words(20, 7, 0, 0, group=1)


def test_model_builds_the_window_kernel(tmp_path):
    """BNN models carry one K5 wrapper of 50 steps for predict's windowed
    burn-in, and make_multi_step runs through it; plain ones do not (their
    make_multi_step is None)."""
    p = dict(v_dim=6, z_dims=[1, 1, 1, 2], binary_treatment=False, dataset="t",
             output_dir=str(tmp_path), save_res=False, g_units=[16, 16], e_units=[16],
             h_units=[8], f_units=[8], dz_units=[8])
    m = tcb.CausalBGM(p, random_seed=0, device="cpu")
    assert m.kernels["bnn_mh_window"].n_steps == tcb.MH_WINDOW == 50
    lp, _, make_params, make_multi_step = m._make_param_log_prob()
    data = tuple(np.random.default_rng(0).normal(size=(40, d)).astype(np.float32)
                 for d in (1, 1, 6))
    params = make_params(m.nets, data, True)
    z0 = torch.zeros((40, 5))
    g = torch.Generator().manual_seed(0)
    z, logp, counts = make_multi_step(50)(params, z0, torch.tensor(0.5), g)
    assert z.shape == (40, 5) and logp.shape == (40,) and counts.shape == (50,)
    assert bool(torch.isfinite(logp).all()) and 0 < float(counts.sum()) < 40 * 50
    with pytest.raises(ValueError, match="50 steps per launch"):
        make_multi_step(7)
    plain = tcb.CausalBGM(dict(p, use_bnn=False), random_seed=0, device="cpu")
    assert plain._make_param_log_prob()[3] is None and "bnn_mh_window" not in plain.kernels
