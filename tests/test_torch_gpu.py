"""K1 to K4 on the card: the CUDA kernels against their plain PyTorch
versions, the sign words against the plain Philox words, and predict (MH and
MALA) and fit through the kernels, with flipout-BNN and with plain nets.
Every test needs a CUDA device
and skips without one.  This file imports no JAX, so it also runs on a GPU
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesgm_torch.models.causalbgm import CausalBGM, CBGMConfig  # noqa: E402
from bayesgm_torch.ops import _pk_bnn_hosteps as tk  # noqa: E402
from bayesgm_torch.ops import _pk_plain as tp  # noqa: E402
from bayesgm_torch.ops._pk_traced_common import philox_sign_words  # noqa: E402
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


@pytest.mark.parametrize("variant,n", [
    ("continuous", 1), ("continuous", 33), ("continuous", 1000), ("binary", 257),
    ("fixed_sigmas", 100), ("deep_g", 70)])
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


@pytest.mark.parametrize("n_half", [1, 31, 500])
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
    ("fixed_sigmas", 100), ("deep_g", 70)])
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
    # the value is K1's, bit for bit
    assert torch.equal(neg, tk.make_fused_causal_logp_bnn_hosteps(cfg, *dims)(*args))


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
    g_hidden = [8] * 17 if variant == "deep_g" else (24, 40)
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
