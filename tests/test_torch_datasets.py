"""The port's copy of the Hirano-Imbens simulation gives the same arrays as
the JAX package's sampler for the same (N, v_dim, seed)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from bayesgm_tpu.datasets import Sim_Hirano_Imbens_sampler as JaxSampler  # noqa: E402
from bayesgm_torch.datasets.causal_samplers import (  # noqa: E402
    Sim_Hirano_Imbens_sampler as PortSampler,
)


@pytest.mark.parametrize("n,v_dim,seed", [(1, 3, 0), (257, 6, 0), (1000, 200, 7), (64, 50, 123)])
def test_hirano_imbens_sampler_equals_jax_package(n, v_dim, seed):
    want = JaxSampler(batch_size=32, N=n, v_dim=v_dim, seed=seed).load_all()
    got = PortSampler(batch_size=32, N=n, v_dim=v_dim, seed=seed).load_all()
    for name, a, b in zip("xyv", got, want):
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
