"""K1 on the card: the CUDA kernel against its plain PyTorch version, and its
sign words against the plain Philox words.  Every test needs a CUDA device
and skips without one.  This file imports no JAX, so it also runs on a GPU
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bayesgm_torch.models.causalbgm import CausalBGM, CBGMConfig  # noqa: E402
from bayesgm_torch.ops import _pk_bnn_hosteps as tk  # noqa: E402
from bayesgm_torch.ops._pk_traced_common import philox_sign_words  # noqa: E402
from bayesgm_torch.ops._pk_util import (  # noqa: E402
    flatten_flipout_params,
    flipout_step_perturbations,
    split_flipout_flat,
)
from bayesgm_torch.ops.nn import FlipoutMLP  # noqa: E402

pytestmark = pytest.mark.gpu

# f32 summation order (the kernel sums each dot product in order, cuBLAS does not)
RTOL, ATOL = 1e-4, 1e-3


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
