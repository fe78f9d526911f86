"""K1 (the flipout-BNN log-posterior with host eps) and K2 (K1 plus its
z-gradient): the port's plain versions against the JAX kernels in interpret
mode, with the TPU sign PRNG replaced by a counter hash whose words are
replayed into the port, and the port's Philox sign source against the
Random123 known answers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.models import causalbgm as jcb  # noqa: E402
from bayesgm_tpu.ops import _pk_bnn_hosteps as jk  # noqa: E402
from bayesgm_tpu.ops import _pk_util as jpk  # noqa: E402
from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.models import causalbgm as tcb  # noqa: E402
from bayesgm_torch.ops import _pk_bnn_hosteps as tk  # noqa: E402
from bayesgm_torch.ops import _pk_traced_common as ttc  # noqa: E402
from bayesgm_torch.ops import _pk_util as tpk  # noqa: E402
from bayesgm_torch.ops import nn as tnn  # noqa: E402
from _torch_parity import replayed_words as _replayed_words  # noqa: E402
from _torch_parity import stub_prng as _stub_prng  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)  # as the JAX kernel's own mirror test


def _cfgs(binary=False, sigma_v=None):
    kw = dict(v_dim=6, z_dims=(1, 1, 1, 2), binary_treatment=binary, use_bnn=True,
              kl_weight=1e-4, sigma_v=sigma_v, sigma_x=None, sigma_y=None, use_z_rec=1.0,
              lr=2e-4, lr_theta=1e-4, lr_z=1e-4, g_d_freq=5)
    return jcb.CBGMConfig(**kw), tcb.CBGMConfig(**kw)


def _jax_nets(cfg, rho=None):
    keys = jax.random.split(jax.random.PRNGKey(12), 3)
    nets = {
        "g": jnn.init_flipout_mlp(keys[0], sum(cfg.z_dims), cfg.v_dim + 1, [16, 8]),
        "h": jnn.init_flipout_mlp(keys[1], cfg.z_dims[0] + cfg.z_dims[2], 2, [8]),
        "f": jnn.init_flipout_mlp(keys[2], cfg.z_dims[0] + cfg.z_dims[1] + 1, 2, [8]),
    }
    nets = jax.tree.map(np.asarray, nets)
    if rho is not None:
        for net in nets.values():
            for layer in net["layers"]:
                layer["rho"] = np.full_like(layer["rho"], rho)
    return nets


def _data(cfg, n, binary=False, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, sum(cfg.z_dims))).astype(np.float32)
    x = ((rng.uniform(size=(n, 1)) < 0.5) if binary else rng.normal(size=(n, 1))).astype(np.float32)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    v = rng.normal(size=(n, cfg.v_dim)).astype(np.float32)
    return z, x, y, v


def _kernel_inputs(nets, n_sets, seed=3):
    """Numpy (ws per chain, P list, dims per chain) from the JAX flatten,
    with eps drawn by numpy."""
    ws, sigs, dims = [], [], []
    for k in "ghf":
        w, s = jpk.split_flipout_flat(jpk.flatten_flipout_params(nets[k]))
        ws.append([np.asarray(a) for a in w])
        sigs += [np.asarray(a) for a in s]
        dims.append(jpk.flipout_mlp_layer_dims(nets[k]))
    rng = np.random.default_rng(seed)
    ps = [(s * rng.normal(size=(n_sets,) + s.shape)).astype(np.float32) for s in sigs]
    return ws, ps, dims


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _port_logp(tcfg, z, x, y, v, ws, ps, seed=(0, 0), **kw):
    return tk.logp_plain(tcfg, _t(z), _t(x), _t(y), _t(v),
                         torch.tensor(seed, dtype=torch.int32),
                         *[[_t(a) for a in w] for w in ws], [_t(p) for p in ps], **kw).numpy()


@pytest.mark.parametrize("variant", ["continuous", "binary", "fixed_sigma_v"])
def test_plain_matches_jax_kernel_interpret(monkeypatch, variant):
    jcfg, tcfg = _cfgs(binary=variant == "binary",
                       sigma_v=0.5 if variant == "fixed_sigma_v" else None)
    nets = _jax_nets(jcfg)
    n, block = 32, 16  # two row blocks
    z, x, y, v = _data(jcfg, n, binary=variant == "binary")
    ws, ps, dims = _kernel_inputs(nets, 1)

    _stub_prng(monkeypatch)
    fused = jk.make_fused_causal_logp_bnn_hosteps(jcfg, *dims, block_rows=block, interpret=True)
    want = np.asarray(fused(z, x, y, v, jnp.zeros((2,), jnp.int32), *ws, ps))

    got = _port_logp(tcfg, z, x, y, v, ws, ps, sign_words=_replayed_words(dims, n, block))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


def test_paired_plain_matches_jax_paired_kernel(monkeypatch):
    jcfg, tcfg = _cfgs()
    nets = _jax_nets(jcfg)
    n, block = 16, 16  # one block per half: JAX routes set 0 / set 1 per block
    z, x, y, v = _data(jcfg, n)
    z2 = np.concatenate([z, z + 0.1])
    d2 = [np.concatenate([a, a]) for a in (x, y, v)]
    ws, ps2, dims = _kernel_inputs(nets, 2)

    _stub_prng(monkeypatch)
    paired = jk.make_fused_causal_logp_bnn_hosteps(jcfg, *dims, block_rows=block, paired=True,
                                                   interpret=True)
    want = np.asarray(paired(z2, *d2, jnp.zeros((2,), jnp.int32), *ws, ps2))
    got = _port_logp(tcfg, z2, *d2, ws, ps2, sign_words=_replayed_words(dims, 2 * n, block))
    np.testing.assert_allclose(got, want, **TOL)


def test_paired_halves_equal_unpaired_calls_fed_that_set():
    """Set 0 feeds the first half, set 1 the second; each half's Philox signs
    are those of its global rows."""
    _, tcfg = _cfgs()
    nets = _jax_nets(tcfg)
    n = 24
    z, x, y, v = _data(tcfg, n)
    z2 = np.concatenate([z, z + 0.1])
    d2 = [np.concatenate([a, a]) for a in (x, y, v)]
    ws, ps2, dims = _kernel_inputs(nets, 2)
    seed = (12345, -7)
    neg2 = _port_logp(tcfg, z2, *d2, ws, ps2, seed=seed)

    words = [ttc.philox_sign_words(torch.tensor(seed, dtype=torch.int32), 2 * n, max(d), ch)
             for ch, d in enumerate(dims)]
    for half, zz in ((0, z), (1, z + 0.1)):
        rows = slice(half * n, (half + 1) * n)
        neg1 = _port_logp(tcfg, zz, x, y, v, ws, [p[half:half + 1] for p in ps2], seed=seed,
                          sign_words=[w[rows] for w in words])
        np.testing.assert_allclose(neg2[rows], neg1, rtol=1e-6, atol=1e-6)
    # the unpaired Philox path is the first half's words
    neg_first = _port_logp(tcfg, z, x, y, v, ws, [p[:1] for p in ps2], seed=seed)
    np.testing.assert_allclose(neg2[:n], neg_first, rtol=1e-6, atol=1e-6)
    assert np.abs(neg2[:n] - neg2[n:]).max() > 1e-3


def _words_from_signs(r_in, r_out, max_w):
    """Bit-slice per-layer +-1 sign matrices into one word per (row, col)."""
    words = torch.zeros((r_in[0].shape[0], max_w), dtype=torch.int64)
    for i, (si, so) in enumerate(zip(r_in, r_out)):
        words[:, :si.shape[1]] |= (si < 0).to(torch.int64) << (2 * i)
        words[:, :so.shape[1]] |= (so < 0).to(torch.int64) << (2 * i + 1)
    return words


@pytest.mark.parametrize("binary", [False, True])
def test_plain_matches_port_composite_under_same_noise(binary):
    """K1's plain version == the port's _neg_log_posterior_rows when fed the
    composite's own eps and signs (replayed from the same generator seed)."""
    _, tcfg = _cfgs(binary=binary)
    nets = bridge.nets_from_numpy(_jax_nets(tcfg))
    n = 40
    z, x, y, v = (_t(a) for a in _data(tcfg, n, binary=binary))
    d0, d1, d2, _ = tcfg.z_dims
    with torch.no_grad():
        comp = tcb._neg_log_posterior_rows(tcfg, nets, z, x, y, v,
                                           torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        words, ps, ws = [], [], []
        for k, width in zip("ghf", (sum(tcfg.z_dims), d0 + d2, d0 + d1 + 1)):
            eps, r_in, r_out = tnn._fused_flipout_draws(nets[k].layers(), (n, width), gen)
            w, sigs = tpk.split_flipout_flat(tpk.flatten_flipout_params(nets[k]))
            ws.append(w)
            ps += [(s * e)[None] for s, e in zip(sigs, eps)]
            words.append(_words_from_signs(r_in, r_out, max(nets[k].dims)))
        got = tk.logp_plain(tcfg, z, x, y, v, torch.zeros(2, dtype=torch.int32), *ws, ps,
                            sign_words=words)
    np.testing.assert_allclose(got.numpy(), comp.numpy(), **TOL)


def test_deterministic_limit_matches_jax_composite():
    """rho = -20 (sigma ~ 2e-9): the port's K1 with its own Philox signs and
    eps equals the JAX XLA composite."""
    jcfg, tcfg = _cfgs()
    nets = _jax_nets(jcfg, rho=-20.0)
    n = 48
    z, x, y, v = _data(jcfg, n)
    want = np.asarray(jcb._neg_log_posterior_rows(jcfg, nets, z, x, y, v, jax.random.PRNGKey(0)))
    ws, ps, _ = _kernel_inputs(nets, 1)
    got = _port_logp(tcfg, z, x, y, v, ws, ps, seed=(99, 1))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("word,expected", [
    (0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (0xFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(word, expected):
    t = torch.tensor(word, dtype=torch.int64)
    out = ttc.philox4x32_10((t, t, t, t), (t, t))
    assert tuple(int(w) for w in out) == expected


def test_sign_words_are_fair_and_tile_independent():
    seed = torch.tensor([2024, -31], dtype=torch.int32)
    words = ttc.philox_sign_words(seed, 4096, 64, chain=0)
    assert words.dtype == torch.int64 and int(words.min()) >= 0 and int(words.max()) < 2**32
    for k in range(32):
        assert abs(float(((words >> k) & 1).float().mean()) - 0.5) < 0.01, k
    # a row's words do not depend on how many rows were drawn
    assert torch.equal(ttc.philox_sign_words(seed, 100, 64, 0)[:37],
                       ttc.philox_sign_words(seed, 37, 64, 0))
    # chains, word groups and seeds give different words
    assert not torch.equal(words, ttc.philox_sign_words(seed, 4096, 64, chain=1))
    assert not torch.equal(words, ttc.philox_sign_words(seed, 4096, 64, 0, group=1))
    other = torch.tensor([2024, -30], dtype=torch.int32)
    assert not torch.equal(words, ttc.philox_sign_words(other, 4096, 64, 0))


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    _, tcfg = _cfgs()
    nets = _jax_nets(tcfg)
    z, x, y, v = _data(tcfg, 20)
    ws, ps, dims = _kernel_inputs(nets, 1)
    fn = tk.make_fused_causal_logp_bnn_hosteps(tcfg, *dims)
    got = fn(_t(z), _t(x), _t(y), _t(v), torch.tensor([1, 2], dtype=torch.int32),
             *[[_t(a) for a in w] for w in ws], [_t(p) for p in ps]).numpy()
    np.testing.assert_array_equal(got, _port_logp(tcfg, z, x, y, v, ws, ps, seed=(1, 2)))
    assert fn.launches == 0


def test_wrapper_and_sign_words_refuse_other_devices():
    _, tcfg = _cfgs()
    fn = tk.make_fused_causal_logp_bnn_hosteps(tcfg, [5, 4, 7], [2, 4, 2], [3, 4, 2])
    meta = torch.empty((4, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fn(meta, meta, meta, meta, meta, [], [], [], [])
    with pytest.raises(ValueError, match="CUDA int32"):
        tk.sign_words_cuda(torch.zeros(2, dtype=torch.int32), 4, 4, 0)


def test_deep_chain_takes_signs_from_word_group_one():
    """Layers past the 16th read their signs from word group 1 (counter slot
    3 = 1), so no sign matrix repeats; replayed words cover 16 layers only."""
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    d0, d1, d2, _ = tcfg.z_dims
    nets = [tnn.FlipoutMLP(sum(tcfg.z_dims), tcfg.v_dim + 1, [4] * 17, gen),
            tnn.FlipoutMLP(d0 + d2, 2, [4], gen), tnn.FlipoutMLP(d0 + d1 + 1, 2, [4], gen)]
    ws, sigs = zip(*(tpk.split_flipout_flat(tpk.flatten_flipout_params(n)) for n in nets))
    ps = tpk.flipout_step_perturbations(sum(sigs, []), gen)
    z, x, y, v = (_t(a) for a in _data(tcfg, 10))
    seed = torch.tensor([5, 6], dtype=torch.int32)
    with torch.no_grad():
        out = tk.logp_plain(tcfg, z, x, y, v, seed, *ws, ps)
        assert out.shape == (10,) and bool(torch.isfinite(out).all())
        words = [ttc.philox_sign_words(seed, 10, max(n.dims), 0) for n in nets]
        with pytest.raises(ValueError, match="16 layers"):
            tk.logp_plain(tcfg, z, x, y, v, seed, *ws, ps, sign_words=words)
    signs = ttc._sign_source(lambda g: ttc.philox_sign_words(seed, 10, 13, 0, g))
    assert not torch.equal(signs(1, 13), signs(33, 13))  # same bit, other group


@pytest.mark.parametrize("variant", ["continuous", "binary", "fixed_sigmas"])
def test_k2_plain_matches_jax_kernel_interpret(monkeypatch, variant):
    """K2's plain version (autograd of the K1 plain version) against the JAX
    K2 in interpret mode, same words and P: the value at rtol/atol 2e-5, the
    gradient at rtol 5e-4 / atol 5e-5 (the tolerances of JAX's own mirror
    test of its hand-written backward, tests/test_pallas.py)."""
    jcfg, tcfg = _cfgs(binary=variant == "binary",
                       sigma_v=0.5 if variant == "fixed_sigmas" else None)
    if variant == "fixed_sigmas":
        jcfg, tcfg = (c._replace(sigma_x=0.7, sigma_y=0.3) for c in (jcfg, tcfg))
    nets = _jax_nets(jcfg)
    n, block = 32, 16  # two row blocks
    z, x, y, v = _data(jcfg, n, binary=variant == "binary", seed=4)
    ws, ps, dims = _kernel_inputs(nets, 1, seed=5)

    _stub_prng(monkeypatch)
    fused = jk.make_fused_causal_logp_and_grad_bnn_hosteps(jcfg, *dims, block_rows=block,
                                                           interpret=True)
    neg_j, grad_j = (np.asarray(a) for a in
                     fused(z, x, y, v, jnp.zeros((2,), jnp.int32), *ws, ps))

    words = _replayed_words(dims, n, block)
    neg_t, grad_t = tk.logp_and_grad_plain(
        tcfg, _t(z), _t(x), _t(y), _t(v), torch.zeros(2, dtype=torch.int32),
        *[[_t(a) for a in w] for w in ws], [_t(p) for p in ps], sign_words=words)
    assert grad_t.shape == (n, sum(tcfg.z_dims))
    np.testing.assert_allclose(neg_t.numpy(), neg_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(grad_t.numpy(), grad_j, rtol=5e-4, atol=5e-5)
    # K2's value is K1's on the same inputs
    k1 = _port_logp(tcfg, z, x, y, v, ws, ps, sign_words=words)
    np.testing.assert_array_equal(neg_t.numpy(), k1)


def test_k2_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    _, tcfg = _cfgs()
    nets = _jax_nets(tcfg)
    z, x, y, v = _data(tcfg, 20)
    ws, ps, dims = _kernel_inputs(nets, 1)
    fn = tk.make_fused_causal_logp_and_grad_bnn_hosteps(tcfg, *dims)
    args = (_t(z), _t(x), _t(y), _t(v), torch.tensor([1, 2], dtype=torch.int32),
            *[[_t(a) for a in w] for w in ws], [_t(p) for p in ps])
    neg, grad = fn(*args)
    want_neg, want_grad = tk.logp_and_grad_plain(tcfg, *args)
    assert torch.equal(neg, want_neg) and torch.equal(grad, want_grad)
    assert fn.launches == 0
    with pytest.raises(ValueError, match="one eps set"):
        tk.logp_and_grad_plain(tcfg, *args[:-1], [torch.cat([p, p]) for p in args[-1]])
    meta = torch.empty((4, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fn(meta, meta, meta, meta, meta, [], [], [], [])


def test_k2_gradient_matches_finite_differences():
    """The plain K2 gradient is the derivative of the K1 value under fixed
    noise (central differences in float64 of the same function)."""
    _, tcfg = _cfgs()
    nets = _jax_nets(tcfg)
    z, x, y, v = _data(tcfg, 6, seed=9)
    ws, ps, _ = _kernel_inputs(nets, 1)
    d = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    seed = torch.tensor([3, 4], dtype=torch.int32)
    args = (d(x), d(y), d(v), seed, *[[d(a) for a in w] for w in ws], [d(p) for p in ps])
    zt = d(z)
    _, grad = tk.logp_and_grad_plain(tcfg, zt, *args)
    h = 1e-6
    for k in range(zt.shape[1]):
        e = torch.zeros_like(zt)
        e[:, k] = h
        fd = (tk.logp_plain(tcfg, zt + e, *args) - tk.logp_plain(tcfg, zt - e, *args)) / (2 * h)
        np.testing.assert_allclose(grad[:, k].numpy(), fd.numpy(), rtol=1e-6, atol=1e-6)
