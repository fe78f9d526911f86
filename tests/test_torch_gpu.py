"""K1 to K8 on the card: the CUDA kernels against their plain PyTorch
versions, the sign words and the in-kernel draws against the plain Philox
draws, and predict (MH, windowed MH and MALA) and fit through the kernels,
with flipout-BNN and with plain nets.
Every test needs a CUDA device
and skips without one.  This file imports no JAX, so it also runs on a GPU
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesgm_torch.benchmarks import mxu_probe as mp  # noqa: E402
from bayesgm_torch.models.causalbgm import CausalBGM, CBGMConfig  # noqa: E402
from bayesgm_torch.ops import _pk_bnn_hosteps as tk  # noqa: E402
from bayesgm_torch.ops import _pk_bnn_inkernel as ik  # noqa: E402
from bayesgm_torch.ops import _pk_plain as tp  # noqa: E402
from bayesgm_torch.ops._pk_traced_common import (  # noqa: E402
    PhiloxDraws,
    _kernel_normal,
    _kernel_uniform,
    philox_sign_words,
)
from bayesgm_torch.ops._pk_util import (  # noqa: E402
    flatten_flipout_params,
    flatten_mlp_params,
    flipout_step_perturbations,
    split_flipout_flat,
)
from bayesgm_torch.ops.nn import MLP, FlipoutMLP  # noqa: E402

pytestmark = pytest.mark.gpu

# f32 summation order (the kernel sums each dot product in order, cuBLAS does not)
RTOL, ATOL = 1e-4, 1e-3
# K2's z-gradient: f32 dots 24 to 201 wide, through up to 18 layers forward and
# back, each summed in another order than autograd's cuBLAS calls
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(**kw):
    base = dict(v_dim=12, z_dims=(1, 1, 1, 3), binary_treatment=False, use_bnn=True,
                kl_weight=1e-4, sigma_v=None, sigma_x=None, sigma_y=None, use_z_rec=1.0,
                lr=2e-4, lr_theta=1e-4, lr_z=1e-4, g_d_freq=5)
    base.update(kw)
    return CBGMConfig(**base)


def _inputs(cfg, n, dev, n_sets=1, g_hidden=(24, 40), seed=0):
    gen = torch.Generator().manual_seed(seed)
    d0, d1, d2, _ = cfg.z_dims
    nets = [FlipoutMLP(sum(cfg.z_dims), cfg.v_dim + 1, g_hidden, gen),
            FlipoutMLP(d0 + d2, 2, [16, 8], gen), FlipoutMLP(d0 + d1 + 1, 2, [16], gen)]
    ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(net.to(dev))) for net in nets))
    ps = flipout_step_perturbations(sum(sigs, []), torch.Generator(dev).manual_seed(seed),
                                    n_sets=n_sets)
    z = torch.randn((n, sum(cfg.z_dims)), generator=gen).to(dev)
    x = torch.randn((n, 1), generator=gen)
    if cfg.binary_treatment:
        x = (x > 0).to(torch.float32)
    y = torch.randn((n, 1), generator=gen)
    v = torch.randn((n, cfg.v_dim), generator=gen)
    seed_t = torch.tensor([seed + 11, -seed - 3], dtype=torch.int32, device=dev)
    args = (z, x.to(dev), y.to(dev), v.to(dev), seed_t, *ws, ps)
    return args, [net.dims for net in nets]


@pytest.mark.parametrize("chain,cols,group", [(0, 201, 0), (1, 64, 0), (2, 3, 0), (0, 33, 1)])
def test_sign_words_equal_plain(cuda, chain, cols, group):
    seed = torch.tensor([123, -456], dtype=torch.int32, device=cuda)
    got = tk.sign_words_cuda(seed, 1037, cols, chain, group)
    want = philox_sign_words(seed, 1037, cols, chain, group)
    assert torch.equal(got, want)


# Row counts around K1's 64-row tile, and K2's 32-row tile and its switch
# from the cluster form to one block per tile past 512 rows.
@pytest.mark.parametrize("variant,n", [
    ("continuous", 1), ("continuous", 33), ("continuous", 1000), ("binary", 257),
    ("fixed_sigmas", 100), ("deep_g", 70), ("continuous", 63), ("continuous", 64),
    ("continuous", 65), ("binary", 1000), ("fixed_sigmas", 1000), ("deep_g", 1000)])
def test_kernel_matches_plain(cuda, variant, n):
    cfg = _cfg(binary_treatment=variant == "binary",
               **(dict(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3) if variant == "fixed_sigmas" else {}))
    g_hidden = [8] * 17 if variant == "deep_g" else (24, 40)  # 18 layers: word group 1
    args, dims = _inputs(cfg, n, cuda, g_hidden=g_hidden)
    fn = tk.make_fused_causal_logp_bnn_hosteps(cfg, *dims)
    got = fn(*args)
    want = tk.logp_plain(cfg, *args)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # K2's value is K1's, bit for bit
    neg, _ = tk.make_fused_causal_logp_and_grad_bnn_hosteps(cfg, *dims)(*args)
    assert torch.equal(neg, got)


@pytest.mark.parametrize("n_half", [1, 31, 500, 33])
def test_paired_kernel_matches_plain(cuda, n_half):
    cfg = _cfg()
    args, dims = _inputs(cfg, 2 * n_half, cuda, n_sets=2)
    fn = tk.make_fused_causal_logp_bnn_hosteps(cfg, *dims, paired=True)
    got = fn(*args)
    torch.testing.assert_close(got, tk.logp_plain(cfg, *args), rtol=RTOL, atol=ATOL)


def test_kernel_rejects_what_it_cannot_take(cuda):
    cfg = _cfg()
    args, dims = _inputs(cfg, 8, cuda)
    fn = tk.make_fused_causal_logp_bnn_hosteps(cfg, *dims)
    with pytest.raises(ValueError, match="contiguous float32"):
        fn(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="n_sets|shape"):
        fn(*args[:-1], [torch.cat([p, p]) for p in args[-1]])
    wide_cfg = _cfg(v_dim=400)
    wide_args, wide_dims = _inputs(wide_cfg, 8, cuda, g_hidden=(300,))
    with pytest.raises(RuntimeError, match="shared memory"):
        tk.make_fused_causal_logp_bnn_hosteps(wide_cfg, *wide_dims)(*wide_args)
    assert fn.launches == 0


def test_predict_on_cuda_goes_through_the_kernel(cuda, tmp_path):
    params = dict(v_dim=12, z_dims=[1, 1, 1, 3], binary_treatment=False, dataset="t",
                  output_dir=str(tmp_path), save_res=False, g_units=[24, 24], h_units=[8],
                  f_units=[8])
    model = CausalBGM(params, random_seed=0, device="cuda")
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(300, 1)), rng.normal(size=(300, 1)), rng.normal(size=(300, 12)))
    adrf, ci = model.predict(data, x_values=[0.0, 1.0, 2.0], burn_in=20, n_mcmc=30)
    assert adrf.shape == (3,) and np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])
    assert model.kernels["bnn_hosteps"].launches == 1
    assert model.kernels["bnn_hosteps_paired"].launches == 50


@pytest.mark.parametrize("variant,n", [
    ("continuous", 1), ("continuous", 32), ("continuous", 999), ("binary", 257),
    ("fixed_sigmas", 100), ("deep_g", 70), ("continuous", 31), ("continuous", 33),
    ("continuous", 512), ("continuous", 513), ("continuous", 20000), ("binary", 31),
    ("binary", 999), ("fixed_sigmas", 33), ("fixed_sigmas", 999), ("deep_g", 33),
    ("deep_g", 999)])
def test_k2_kernel_matches_plain(cuda, variant, n):
    cfg = _cfg(binary_treatment=variant == "binary",
               **(dict(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3) if variant == "fixed_sigmas" else {}))
    g_hidden = [8] * 17 if variant == "deep_g" else (24, 40)
    args, dims = _inputs(cfg, n, cuda, g_hidden=g_hidden)
    fn = tk.make_fused_causal_logp_and_grad_bnn_hosteps(cfg, *dims)
    neg, grad = fn(*args)
    want_neg, want_grad = tk.logp_and_grad_plain(cfg, *args)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(grad).all())
    torch.testing.assert_close(neg, want_neg, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(grad, want_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the value is K1's, bit for bit, and a second launch gives the same bits
    assert torch.equal(neg, tk.make_fused_causal_logp_bnn_hosteps(cfg, *dims)(*args))
    neg2, grad2 = fn(*args)
    assert fn.launches == 2 and torch.equal(neg2, neg) and torch.equal(grad2, grad)


def test_k2_kernel_rejects_what_it_cannot_take(cuda):
    cfg = _cfg()
    args, dims = _inputs(cfg, 8, cuda)
    fn = tk.make_fused_causal_logp_and_grad_bnn_hosteps(cfg, *dims)
    with pytest.raises(ValueError, match="n_sets|shape"):
        fn(*args[:-1], [torch.cat([p, p]) for p in args[-1]])
    wide_cfg = _cfg(v_dim=400)
    wide_args, wide_dims = _inputs(wide_cfg, 8, cuda, g_hidden=(300,))
    with pytest.raises(RuntimeError, match="shared memory"):
        tk.make_fused_causal_logp_and_grad_bnn_hosteps(wide_cfg, *wide_dims)(*wide_args)
    assert fn.launches == 0


def test_fit_on_cuda_goes_through_k2(cuda, tmp_path):
    params = dict(v_dim=12, z_dims=[1, 1, 1, 3], binary_treatment=False, dataset="t",
                  output_dir=str(tmp_path), save_res=False, g_units=[24, 24], e_units=[16],
                  h_units=[8], f_units=[8], dz_units=[8], lr_decay="cosine")
    model = CausalBGM(params, random_seed=0, device="cuda")
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(100, 1)), rng.normal(size=(100, 1)), rng.normal(size=(100, 12)))
    model.fit(data, epochs=2, epochs_per_eval=1, batch_size=32, egm_n_iter=10,
              egm_batches_per_eval=5, verbose=0)
    # 4 batches per pass (3 full + the remainder of 4 rows), epochs + 1 passes
    assert model.kernels["bnn_hosteps_grad"].launches == 12
    assert model.data_z.shape == (100, 6) and bool(torch.isfinite(model.data_z).all())
    assert all(np.isfinite(v) for v in model.fit_losses.values())
    adrf, ci = model.predict(data, x_values=[0.0, 1.0], burn_in=5, n_mcmc=5,
                             use_swa_nets=True)
    assert np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])


def test_differentiable_log_prob_on_cuda_goes_through_k2(cuda, tmp_path):
    """The gradient samplers' target: one K2 launch per call, and its
    backward equals autograd of the plain version through the same noise."""
    params = dict(v_dim=12, z_dims=[1, 1, 1, 3], binary_treatment=False, dataset="t",
                  output_dir=str(tmp_path), save_res=False, g_units=[24, 24], h_units=[8],
                  f_units=[8])
    model = CausalBGM(params, random_seed=0, device="cuda")
    rng = np.random.default_rng(1)
    data = (rng.normal(size=(70, 1)), rng.normal(size=(70, 1)), rng.normal(size=(70, 12)))
    z = torch.randn((70, 6), device=cuda, requires_grad=True)
    lp = model._make_log_prob(*data, differentiable=True)(z, torch.Generator(cuda).manual_seed(3))
    lp.sum().backward()
    assert model.kernels["bnn_hosteps_grad"].launches == 1
    gen = torch.Generator(cuda).manual_seed(3)
    ws, sigs = zip(*(split_flipout_flat(flatten_flipout_params(model.nets[k])) for k in "ghf"))
    ps = flipout_step_perturbations(sum(sigs, []), gen)
    seed = torch.randint(0, 2**31 - 1, (2,), generator=gen, device=cuda, dtype=torch.int32)
    x, y, v = (torch.as_tensor(a, dtype=torch.float32, device=cuda) for a in data)
    neg, grad = tk.logp_and_grad_plain(model.cfg, z.detach(), x, y, v, seed, *ws, ps)
    torch.testing.assert_close(lp.detach(), -neg, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(z.grad, -grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)


# -- K4 and K3: plain nets ----------------------------------------------------


def _plain_inputs(cfg, n, dev, g_hidden=(24, 40), seed=0):
    gen = torch.Generator().manual_seed(seed)
    d0, d1, d2, _ = cfg.z_dims
    nets = [MLP(sum(cfg.z_dims), cfg.v_dim + 1, g_hidden, gen),
            MLP(d0 + d2, 2, [16, 8], gen), MLP(d0 + d1 + 1, 2, [16], gen)]
    with torch.no_grad():  # non-zero biases
        for net in nets:
            for b in net.b:
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    flats = [flatten_mlp_params(net.to(dev)) for net in nets]
    z = torch.randn((n, sum(cfg.z_dims)), generator=gen)
    x = torch.randn((n, 1), generator=gen)
    if cfg.binary_treatment:
        x = (x > 0).to(torch.float32)
    y = torch.randn((n, 1), generator=gen)
    v = torch.randn((n, cfg.v_dim), generator=gen)
    args = tuple(a.to(dev) for a in (z, x, y, v)) + tuple(flats)
    return args, [net.dims for net in nets]


PLAIN_CASES = [("continuous", 1), ("continuous", 32), ("continuous", 999), ("binary", 257),
               ("fixed_sigmas", 100), ("deep_g", 70)]


def _plain_case(variant, n, dev):
    cfg = _cfg(use_bnn=False, binary_treatment=variant == "binary",
               **(dict(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3) if variant == "fixed_sigmas" else {}))
    g_hidden = {"deep_g": [8] * 17, "panels": (100, 3)}.get(variant, (24, 40))
    return (cfg, *_plain_inputs(cfg, n, dev, g_hidden=g_hidden))


@pytest.mark.parametrize("variant,n", PLAIN_CASES)
def test_k4_kernel_matches_plain(cuda, variant, n):
    cfg, args, dims = _plain_case(variant, n, cuda)
    fn = tp.make_fused_causal_logp(cfg, *dims)
    got = fn(*args)
    want = tp.logp_plain(cfg, *args)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant,n", PLAIN_CASES)
def test_k3_kernel_matches_plain(cuda, variant, n):
    cfg, args, dims = _plain_case(variant, n, cuda)
    fn = tp.make_fused_causal_logp_and_grad(cfg, *dims)
    neg, grad = fn(*args)
    want_neg, want_grad = tp.logp_and_grad_plain(cfg, *args)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(grad).all())
    torch.testing.assert_close(neg, want_neg, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(grad, want_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the value is K4's, bit for bit
    assert torch.equal(neg, tp.make_fused_causal_logp(cfg, *dims)(*args))


# K3's two forms: the cluster form up to the switch row count, one block per
# 32-row tile past it ("switch" is read from the library inside the test).
@pytest.mark.parametrize("variant,n", [
    ("continuous", 32), ("continuous", 256), ("continuous", "switch"),
    ("continuous", "switch+1"), ("continuous", 999), ("continuous", 20000), ("binary", 32),
    ("binary", 999), ("fixed_sigmas", 32), ("fixed_sigmas", 999), ("deep_g", 33),
    ("deep_g", 999)])
def test_k3_both_forms_match_plain_and_k4(cuda, variant, n):
    if isinstance(n, str):
        n = tp.k3_cluster_max_rows() + (1 if n.endswith("+1") else 0)
    cfg, args, dims = _plain_case(variant, n, cuda)
    fn = tp.make_fused_causal_logp_and_grad(cfg, *dims)
    neg, grad = fn(*args)
    want_neg, want_grad = tp.logp_and_grad_plain(cfg, *args)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(grad).all())
    torch.testing.assert_close(neg, want_neg, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(grad, want_grad, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the value is K4's, bit for bit, and a second launch gives the same bits
    assert torch.equal(neg, tp.make_fused_causal_logp(cfg, *dims)(*args))
    neg2, grad2 = fn(*args)
    assert torch.equal(neg2, neg) and torch.equal(grad2, grad)


# K4's tiles: row counts on the edges of a 32- and a 64-row tile, a predict
# batch and n; "panels" gives g a layer wider than one 64-column panel and
# one narrower than 4 columns.
@pytest.mark.parametrize("variant", ["continuous", "binary", "fixed_sigmas", "panels"])
@pytest.mark.parametrize("n", [1, 31, 63, 64, 65, 999, 10000, 20000])
def test_k4_tiles_match_plain_and_k3(cuda, variant, n):
    cfg, args, dims = _plain_case(variant, n, cuda)
    fn = tp.make_fused_causal_logp(cfg, *dims)
    got = fn(*args)
    want = tp.logp_plain(cfg, *args)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # a second launch gives the same bits, and K3's value (either form) is K4's
    assert torch.equal(fn(*args), got)
    neg, _ = tp.make_fused_causal_logp_and_grad(cfg, *dims)(*args)
    assert torch.equal(neg, got)


@pytest.mark.parametrize("make", [tp.make_fused_causal_logp, tp.make_fused_causal_logp_and_grad])
def test_plain_kernels_reject_what_they_cannot_take(cuda, make):
    cfg = _cfg(use_bnn=False)
    args, dims = _plain_inputs(cfg, 8, cuda)
    fn = make(cfg, *dims)
    with pytest.raises(ValueError, match="contiguous float32"):
        fn(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous float32"):
        fn(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        fn(*args[:4], [w.t().contiguous() for w in args[4]], *args[5:])
    with pytest.raises(ValueError, match="tensors"):
        fn(*args[:4], args[4][:-2], *args[5:])
    wide_cfg = _cfg(use_bnn=False, v_dim=400)
    wide_args, wide_dims = _plain_inputs(wide_cfg, 8, cuda, g_hidden=(300,))
    with pytest.raises(RuntimeError, match="shared memory"):
        make(wide_cfg, *wide_dims)(*wide_args)
    assert fn.launches == 0


def _plain_model(tmp_path, **kw):
    params = dict(v_dim=12, z_dims=[1, 1, 1, 3], binary_treatment=False, dataset="t",
                  output_dir=str(tmp_path), save_res=False, use_bnn=False, g_units=[24, 24],
                  e_units=[16], h_units=[8], f_units=[8], dz_units=[8], lr_decay="cosine")
    params.update(kw)
    return CausalBGM(params, random_seed=0, device="cuda")


@pytest.mark.parametrize("binary", [False, True], ids=["continuous", "binary"])
def test_predict_on_cuda_takes_a_column_major_table(cuda, tmp_path, binary):
    """Port fault F2: a column-major v (as the semi-synthetic loaders and
    ``parse_file_triplet`` give it) reaches K1 row-major through predict's
    subject batches and the sampler API, and K2 through fit."""
    params = dict(v_dim=12, z_dims=[1, 1, 1, 3], binary_treatment=binary, dataset="t",
                  output_dir=str(tmp_path), save_res=False, g_units=[24, 24], h_units=[8],
                  f_units=[8])
    model = CausalBGM(params, random_seed=0, device="cuda")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 1))
    x = (x > 0).astype(np.float32) if binary else x
    data = (x, rng.normal(size=(300, 1)), np.asfortranarray(rng.normal(size=(300, 12))))
    model.fit(data, epochs=0, epochs_per_eval=1, batch_size=32, egm_n_iter=5,
              egm_batches_per_eval=5, verbose=0)
    est, ci = model.predict(data, x_values=None if binary else [0.0, 1.0], burn_in=10,
                            n_mcmc=10, bs=200)
    assert np.all(np.isfinite(est)) and np.all(ci[:, 0] <= ci[:, 1])
    assert model.metropolis_hastings_sampler(data, burn_in=2, n_keep=2).shape == (2, 300, 6)
    assert model.kernels["bnn_hosteps_grad"].launches == 10
    assert model.kernels["bnn_hosteps_paired"].launches == 2 * 20


def test_plain_fit_on_cuda_goes_through_k3(cuda, tmp_path):
    model = _plain_model(tmp_path)
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(100, 1)), rng.normal(size=(100, 1)), rng.normal(size=(100, 12)))
    model.fit(data, epochs=2, epochs_per_eval=1, batch_size=32, egm_n_iter=10,
              egm_batches_per_eval=5, verbose=0)
    # 4 batches per pass (3 full + the remainder of 4 rows), epochs + 1 passes
    assert model.kernels["plain_grad"].launches == 12
    assert model.kernels["plain"].launches == 0
    assert model.data_z.shape == (100, 6) and bool(torch.isfinite(model.data_z).all())
    assert all(np.isfinite(v) for v in model.fit_losses.values())


@pytest.mark.parametrize("sampler,launches", [("mh", {"plain": 51, "plain_grad": 0}),
                                              ("mala", {"plain": 0, "plain_grad": 51})])
def test_plain_predict_on_cuda_goes_through_k4_or_k3(cuda, tmp_path, sampler, launches):
    """MH: K4 once for the initial state, then once per step (the value is
    cached); MALA: K3 likewise."""
    model = _plain_model(tmp_path)
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(300, 1)), rng.normal(size=(300, 1)), rng.normal(size=(300, 12)))
    adrf, ci = model.predict(data, x_values=[0.0, 1.0, 2.0], burn_in=20, n_mcmc=30,
                             sampler=sampler)
    assert adrf.shape == (3,) and np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])
    assert {k: f.launches for k, f in model.kernels.items()} == launches


def test_bnn_mala_on_cuda_goes_through_k2(cuda, tmp_path):
    """BNN MALA evaluates both sides of the accept ratio afresh: two K2
    launches per step, no K1."""
    params = dict(v_dim=12, z_dims=[1, 1, 1, 3], binary_treatment=False, dataset="t",
                  output_dir=str(tmp_path), save_res=False, g_units=[24, 24], h_units=[8],
                  f_units=[8])
    model = CausalBGM(params, random_seed=0, device="cuda")
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(300, 1)), rng.normal(size=(300, 1)), rng.normal(size=(300, 12)))
    adrf, ci = model.predict(data, x_values=[0.0, 1.0, 2.0], burn_in=20, n_mcmc=30,
                             sampler="mala")
    assert adrf.shape == (3,) and np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])
    assert model.kernels["bnn_hosteps_grad"].launches == 100
    assert model.kernels["bnn_hosteps"].launches == model.kernels["bnn_hosteps_paired"].launches == 0


# -- K6, K7 and K5: the in-kernel-eps family --------------------------------

# Box-Muller through logf/sqrtf/sincosf (no fast math) on both sides
DRAW_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("step,side", [(0, 0), (0, 1), (3, 1), (49, 0)])
def test_inkernel_draws_equal_plain(cuda, step, side):
    """The kernels' sign words, eps and accept uniforms equal the plain
    Philox draws bit for bit and the normals to 1e-6; another (step, side)
    draws other values."""
    seed = torch.tensor([77, -5], dtype=torch.int32, device=cuda)
    dc, dp = ik.DrawsCuda(seed), PhiloxDraws(seed)
    ev = 2 * step + side
    words = dc.sign_words(1037, 64, 1, ev)
    assert torch.equal(words, dp.sign_words(1037, 64, 1, ev))
    eps = dc.eps(3, 64, 201, 0, 5, ev)
    torch.testing.assert_close(eps, _kernel_normal(*dp.eps_words(3, 64, 101, 0, 5, ev), 201),
                               **DRAW_TOL)
    prop = dc.proposal(1037, 11, step)
    torch.testing.assert_close(prop, _kernel_normal(*dp.proposal_words(1037, 6, step), 11),
                               **DRAW_TOL)
    acc = dc.accept(1037, step)
    assert torch.equal(acc, _kernel_uniform(dp.accept_words(1037, step)))
    other = 2 * (step + 1) + (1 - side)
    assert not torch.equal(words, dc.sign_words(1037, 64, 1, other))
    assert not torch.equal(eps, dc.eps(3, 64, 201, 0, 5, other))
    assert not torch.equal(prop, dc.proposal(1037, 11, step + 1))


def _inkernel_inputs(cfg, n, dev, g_hidden=(24, 40), seed=0):
    gen = torch.Generator().manual_seed(seed)
    d0, d1, d2, _ = cfg.z_dims
    nets = [FlipoutMLP(sum(cfg.z_dims), cfg.v_dim + 1, g_hidden, gen),
            FlipoutMLP(d0 + d2, 2, [16, 8], gen), FlipoutMLP(d0 + d1 + 1, 2, [16], gen)]
    flats = [flatten_flipout_params(net.to(dev)) for net in nets]
    z = torch.randn((n, sum(cfg.z_dims)), generator=gen)
    x = torch.randn((n, 1), generator=gen)
    if cfg.binary_treatment:
        x = (x > 0).to(torch.float32)
    y = torch.randn((n, 1), generator=gen)
    v = torch.randn((n, cfg.v_dim), generator=gen)
    seed_t = torch.tensor([seed + 11, -seed - 3], dtype=torch.int32, device=dev)
    args = tuple(a.to(dev) for a in (z, x, y, v)) + (seed_t, *flats)
    return args, [net.dims for net in nets]


def _inkernel_case(variant, n, dev):
    kw = dict(sigma_v=0.5, sigma_x=0.7, sigma_y=0.3) if variant == "fixed_sigmas" else {}
    if variant == "v31":  # g's last layer 32 wide: K5's 2 x 4 micro-tiles fold it into the loss
        kw["v_dim"] = 31
    if variant == "v100":  # g's last layer 101 wide: two panels of Box-Muller pairs
        kw["v_dim"] = 100
    cfg = _cfg(binary_treatment=variant == "binary", **kw)
    # "panels": a layer wider than one 64-column panel and one narrower than 4
    # columns (72: K5's and K6's buffers fit 227 KB up to g widths of about 90)
    g_hidden = {"deep_g": [8] * 17, "panels": (72, 3)}.get(variant, (24, 40))
    return (cfg, *_inkernel_inputs(cfg, n, dev, g_hidden=g_hidden))


INKERNEL_CASES = [("continuous", 1), ("continuous", 33), ("continuous", 1000), ("binary", 257),
                  ("fixed_sigmas", 100), ("deep_g", 70)]


@pytest.mark.parametrize("variant,n", INKERNEL_CASES)
def test_k6_kernel_matches_plain(cuda, variant, n):
    cfg, args, dims = _inkernel_case(variant, n, cuda)
    fn = ik.make_fused_causal_logp_bnn(cfg, *dims, block_rows=64)  # several blocks
    got = fn(*args)
    want = ik.logp_plain(cfg, *args, 64)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


# K7's two forms: a cluster of 8 CTAs per 32-row tile up to the switch
# (ik.k7_cluster_max_rows()), K5's 64-row tiles (32 where block_rows is an odd
# multiple of 32) past it; n "switch" and "switch+1" sit on either side.
K7_CASES = [(v, n, 64) for v, n in INKERNEL_CASES] + [
    ("continuous", 31, 32), ("continuous", 32, 32), ("continuous", "switch", 96),
    ("continuous", "switch+1", 96), ("continuous", 999, 256), ("continuous", 20000, 256),
    ("binary", 999, 96), ("binary", "switch+1", 256), ("fixed_sigmas", 999, 256),
    ("fixed_sigmas", "switch", 32), ("deep_g", 999, 32), ("deep_g", "switch", 64),
    ("v31", 300, 32), ("v31", "switch+1", 64), ("panels", 33, 64), ("panels", 999, 256),
    ("v100", 200, 256), ("v100", 999, 96)]


@pytest.mark.parametrize("variant,n,block_rows", K7_CASES)
def test_k7_kernel_matches_plain(cuda, variant, n, block_rows):
    if isinstance(n, str):
        n = ik.k7_cluster_max_rows() + (1 if n.endswith("+1") else 0)
    cfg, args, dims = _inkernel_case(variant, n, cuda)
    fn = ik.make_fused_causal_logp_and_grad_bnn(cfg, *dims, block_rows=block_rows)
    neg, grad = fn(*args)
    want_neg, want_grad = ik.logp_and_grad_plain(cfg, *args, block_rows)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(grad).all())
    torch.testing.assert_close(neg, want_neg, rtol=RTOL, atol=ATOL)
    # a row may differ only where a hidden pre-activation sits at LeakyReLU's
    # kink, and at most one in a thousand rows may
    off = ((grad - want_grad).abs() > GRAD_ATOL + GRAD_RTOL * want_grad.abs()).any(dim=1)
    assert not bool((off & ~ik.kink_rows(cfg, *args, block_rows)).any())
    assert int(off.sum()) <= max(1, n // 1000)
    # the value is K6's, bit for bit, and a second launch gives the same bits
    assert torch.equal(neg, ik.make_fused_causal_logp_bnn(cfg, *dims, block_rows=block_rows)(*args))
    neg2, grad2 = fn(*args)
    assert torch.equal(neg2, neg) and torch.equal(grad2, grad)


def test_k7_switch_is_the_librarys(cuda):
    assert ik._lib().bnn_inkernel_grad_cluster_max_rows() == ik.k7_cluster_max_rows()


# block_rows 64 (the tests' default), 32 (a 32-row tile), 96 (an odd multiple
# of 32: 32-row tiles) and 512 (production's size at the flagship width);
# n = 999 and 45 are not multiples of the tile; v31 makes g's last layer 32
# wide.
@pytest.mark.parametrize("variant,n,n_steps,block_rows", [
    ("continuous", 1000, 5, 64), ("continuous", 45, 3, 64), ("binary", 300, 4, 64),
    ("deep_g", 70, 2, 64), ("continuous", 1000, 50, 64), ("continuous", 1000, 5, 32),
    ("continuous", 999, 5, 64), ("continuous", 1000, 5, 512), ("continuous", 1000, 5, 96),
    ("binary", 999, 3, 32), ("fixed_sigmas", 999, 3, 512), ("deep_g", 999, 2, 512),
    ("v31", 300, 3, 64)])
def test_k5_kernel_matches_plain(cuda, variant, n, n_steps, block_rows):
    """The window's counts per step within 0.1 % of n (at least 1 row) and
    at least 99.9 % of the rows in the same final state: an accept decision
    at the boundary may flip on f32 summation order."""
    cfg, args, dims = _inkernel_case(variant, n, cuda)
    q_sd = torch.tensor([0.3], device=cuda)
    fn = ik.make_fused_mh_steps_bnn(cfg, *dims, n_steps=n_steps, block_rows=block_rows)
    z_k, lp_k, c_k = fn(*args[:5], q_sd, *args[5:])
    z_p, lp_p, c_p = ik.mh_steps_plain(cfg, *args[:5], q_sd, *args[5:], n_steps, block_rows)
    torch.cuda.synchronize()
    assert fn.launches == 1 and c_k.shape == (n_steps,)
    assert float((c_k - c_p).abs().max()) <= max(1.0, 1e-3 * n)
    same = (z_k - z_p).abs().max(dim=1).values <= 1e-5
    assert float(same.float().mean()) >= 0.999
    torch.testing.assert_close(lp_k[same], lp_p[same], rtol=RTOL, atol=ATOL)
    assert 0 < float(c_k.sum()) < n * n_steps


# K6 is one evaluation of K5's: 64-row tiles, 32-row ones where block_rows
# is an odd multiple of 32 (32, 96).  K7's value (in either form) and the
# probe's base (K6's own code through K8's entry point) equal it bit for bit.
@pytest.mark.parametrize("variant,n,block_rows", [
    ("continuous", 999, 32), ("continuous", 999, 96), ("continuous", 999, 512),
    ("continuous", 2000, 96), ("binary", 999, 96), ("fixed_sigmas", 999, 512),
    ("deep_g", 999, 32), ("v31", 300, 64), ("v100", 999, 512), ("v100", 999, 96),
    ("panels", 999, 512)])
def test_k6_tiles_match_plain_k7_and_probe_base(cuda, variant, n, block_rows):
    cfg, args, dims = _inkernel_case(variant, n, cuda)
    fn = ik.make_fused_causal_logp_bnn(cfg, *dims, block_rows=block_rows)
    got = fn(*args)
    want = ik.logp_plain(cfg, *args, block_rows)
    torch.cuda.synchronize()
    assert fn.launches == 1 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(fn(*args), got)  # a second launch gives the same bits
    neg, _ = ik.make_fused_causal_logp_and_grad_bnn(cfg, *dims, block_rows=block_rows)(*args)
    assert torch.equal(neg, got)
    if variant not in ("binary", "fixed_sigmas"):  # what the probe computes
        base = mp.make_probe_kernel("base", cfg, *dims, block_rows=block_rows)(*args)
        assert torch.equal(base, got)


def test_inkernel_kernels_reject_what_they_cannot_take(cuda):
    cfg = _cfg()
    args, dims = _inkernel_inputs(cfg, 8, cuda)
    fn = ik.make_fused_causal_logp_bnn(cfg, *dims, block_rows=64)
    with pytest.raises(ValueError, match="contiguous float32"):
        fn(args[0].double(), *args[1:])
    with pytest.raises(RuntimeError, match="block_rows"):
        ik.make_fused_causal_logp_bnn(cfg, *dims, block_rows=48)(*args)
    with pytest.raises(ValueError, match="tensors"):
        fn(*args[:5], args[5][:-1], *args[6:])
    k5 = ik.make_fused_mh_steps_bnn(cfg, *dims, n_steps=2, block_rows=64)
    with pytest.raises(ValueError, match="q_sd"):
        k5(*args[:5], torch.tensor([0.3, 0.2], device=cuda), *args[5:])
    wide_cfg = _cfg(v_dim=400)
    wide_args, wide_dims = _inkernel_inputs(wide_cfg, 8, cuda, g_hidden=(300,))
    for make in (ik.make_fused_causal_logp_bnn, ik.make_fused_causal_logp_and_grad_bnn):
        with pytest.raises(RuntimeError, match="shared memory"):
            make(wide_cfg, *wide_dims, block_rows=64)(*wide_args)
    with pytest.raises(RuntimeError, match="shared memory"):
        ik.make_fused_mh_steps_bnn(wide_cfg, *wide_dims, n_steps=2, block_rows=64)(
            *wide_args[:5], torch.tensor(0.3, device=cuda), *wide_args[5:])
    assert fn.launches == k5.launches == 0


def test_window_predict_on_cuda_goes_through_k5(cuda, tmp_path):
    """mh_window_kernel: K1 once for the initial state, K5 once per 50
    burn-in steps, then one paired K1 per kept step."""
    params = dict(v_dim=12, z_dims=[1, 1, 1, 3], binary_treatment=False, dataset="t",
                  output_dir=str(tmp_path), save_res=False, g_units=[24, 24], h_units=[8],
                  f_units=[8], mh_window_kernel=True)
    model = CausalBGM(params, random_seed=0, device="cuda")
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(300, 1)), rng.normal(size=(300, 1)), rng.normal(size=(300, 12)))
    before = dict(ik.LAUNCHES)
    adrf, ci = model.predict(data, x_values=[0.0, 1.0, 2.0], burn_in=100, n_mcmc=30)
    assert adrf.shape == (3,) and np.all(np.isfinite(adrf)) and np.all(ci[:, 0] <= ci[:, 1])
    assert {k: f.launches for k, f in model.kernels.items()} == {
        "bnn_hosteps": 1, "bnn_hosteps_paired": 30, "bnn_mh_window": 2, "bnn_hosteps_grad": 0}
    # K5 through its entry point, K6's and K7's entry points not at all
    assert {k: n - before[k] for k, n in ik.LAUNCHES.items()} == {
        "logp": 0, "logp_and_grad": 0, "mh_steps": 2}


# -- K8: the probe's variants of K6's evaluation (K6's code, one part switched out)


@pytest.mark.parametrize("variant", mp.VARIANTS)
@pytest.mark.parametrize("n,block_rows", [(1, 64), (999, 64), (999, 32), (999, 96), (999, 512)])
def test_probe_kernel_matches_plain(cuda, variant, n, block_rows):
    """Each variant's kernel against its plain version at N not a multiple
    of block_rows, in K6's 64-row tiles and its 32-row ones (block_rows 32,
    96), and the deep g of word group 1 at 70 rows."""
    for g_hidden, rows in (((24, 40), n), ([8] * 17, 70)):
        cfg = _cfg()
        args, dims = _inkernel_inputs(cfg, rows, cuda, g_hidden=g_hidden)
        fn = mp.make_probe_kernel(variant, cfg, *dims, block_rows=block_rows)
        got = fn(*args)
        want = mp.probe_plain(variant, cfg, *args, block_rows)
        torch.cuda.synchronize()
        assert fn.launches == 1 and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _limits_apart(got, ref):
    """max |got - ref| in units of the (RTOL, ATOL) limit about ref."""
    return float(((got - ref).abs() / (ATOL + RTOL * ref.abs())).max())


@pytest.mark.parametrize("variant", mp.VARIANTS)
def test_probe_kernel_matches_plain_where_the_perturbation_counts(cuda, variant):
    """With each weight sigma ~ U(0.2, 0.4), as in the CPU parity test, the
    perturbation product moves every variant's value from nopert's by over
    ten limits (noeps and noprng too, whose P is sigma * 0.01), and bf16's
    rounding moves it from base's: a kernel that left either out fails."""
    cfg = _cfg()
    args, dims = _inkernel_inputs(cfg, 999, cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    flats = [[t if j < 2 or (j - 2) % 3 != 1  # [gamma, beta, (loc, sigma, b) x L]
              else 0.2 + 0.2 * torch.rand(t.shape, generator=gen, device=cuda)
              for j, t in enumerate(f)] for f in args[5:]]
    args = (*args[:5], *flats)
    got = mp.make_probe_kernel(variant, cfg, *dims, block_rows=64)(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mp.probe_plain(variant, cfg, *args, 64), rtol=RTOL, atol=ATOL)
    if variant != "nopert":
        assert _limits_apart(got, mp.probe_plain("nopert", cfg, *args, 64)) > 10
    if variant == "bf16":
        assert _limits_apart(got, mp.probe_plain("base", cfg, *args, 64)) > 10


def test_probe_base_is_k6_and_xorsign_and_blockdiag_are_base(cuda):
    cfg = _cfg()
    args, dims = _inkernel_inputs(cfg, 1000, cuda)
    before = dict(mp.LAUNCHES)
    out = {v: mp.make_probe_kernel(v, cfg, *dims, block_rows=64)(*args) for v in mp.VARIANTS}
    torch.cuda.synchronize()
    assert torch.equal(out["base"], out["prod"]) and torch.equal(out["xorsign"], out["base"])
    torch.testing.assert_close(out["blockdiag"], out["base"], rtol=RTOL, atol=ATOL)
    assert {v: n - before[v] for v, n in mp.LAUNCHES.items()} == {v: 1 for v in mp.KERNEL_VARIANTS}


def test_probe_kernel_rejects_what_it_cannot_take(cuda):
    cfg = _cfg()
    args, dims = _inkernel_inputs(cfg, 8, cuda)
    with pytest.raises(RuntimeError, match="block_rows"):
        mp.make_probe_kernel("nopert", cfg, *dims, block_rows=48)(*args)
    wide_cfg = _cfg(v_dim=400)
    wide_args, wide_dims = _inkernel_inputs(wide_cfg, 8, cuda, g_hidden=(300,))
    for variant in ("base", "blockdiag"):
        fn = mp.make_probe_kernel(variant, wide_cfg, *wide_dims, block_rows=64)
        with pytest.raises(RuntimeError, match="shared memory"):
            fn(*wide_args)
        assert fn.launches == 0
