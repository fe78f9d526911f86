"""The port's roofline accounting (``bayesgm_torch/utils/roofline.py``)
against the JAX package's: ``bnn_eval_cost`` on bridged flagship nets (and
plain ones), ``roofline_report``'s dict for the same inputs, and both
measuring functions on the CPU at tiny sizes, where the caller asks for it
by name (the default device is the card)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bayesgm_tpu.ops import nn as jnn  # noqa: E402
from bayesgm_tpu.utils import roofline as jr  # noqa: E402
from bayesgm_torch import bridge  # noqa: E402
from bayesgm_torch.utils import roofline as tr  # noqa: E402

# the flagship's nets (configs/Sim_Hirano_Imbens.yaml: z_dims [1,1,1,7],
# v_dim 200): g [10, 64 x 5, 201], h [2, 64, 32, 8, 2], f [3, 64, 32, 8, 2]
FLAGSHIP = {"g": (10, 201, [64] * 5), "h": (2, 2, [64, 32, 8]), "f": (3, 2, [64, 32, 8])}


def _jax_nets(flipout):
    init = jnn.init_flipout_mlp if flipout else jnn.init_mlp
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    return {name: jax.eval_shape(lambda k, a=args: init(k, *a), key)
            for key, (name, args) in zip(keys, FLAGSHIP.items())}


def _bridged(jax_nets):
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jax_nets)
    return {name: bridge.net_from_numpy(tree) for name, tree in zeros.items()}


@pytest.mark.parametrize("block_rows", [512, 1, 20000])
@pytest.mark.parametrize("flipout", [True, False], ids=["flipout", "plain"])
def test_bnn_eval_cost_matches_jax(flipout, block_rows):
    jnets = _jax_nets(flipout)
    got = tr.bnn_eval_cost(_bridged(jnets), 200, block_rows=block_rows)
    assert got == jr.bnn_eval_cost(jnets, 200, block_rows=block_rows)
    assert got[0] == 4 * 34848  # two products per layer over 34848 multiply-adds per row


def test_roofline_report_matches_jax():
    args = (2.5e9, 4 * 34848.0, 1061.3, 5.1e13, 3.0e12)
    assert tr.roofline_report(*args) == jr.roofline_report(*args)
    low = (1e6, 8.0, 100.0, 5.1e13, 3.0e12)  # below the ridge
    assert tr.roofline_report(*low) == jr.roofline_report(*low)


def test_measurements_run_on_the_cpu_when_asked():
    """Tiny sizes on the CPU; the numbers are the CPU's, positive and
    finite (no claim about a card), and TF32's setting is restored."""
    before = torch.backends.cuda.matmul.allow_tf32
    for dtype in ("float32", "bfloat16"):
        peak = tr.measure_matmul_peak(dtype, size=64, reps=3, device="cpu")
        assert np.isfinite(peak) and peak > 0
    assert torch.backends.cuda.matmul.allow_tf32 == before
    bw = tr.measure_hbm_bandwidth(n_floats=4096, reps=3, device="cpu")
    assert np.isfinite(bw) and bw > 0


def test_measurements_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.measure_matmul_peak(size=8, reps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.measure_hbm_bandwidth(n_floats=8, reps=1)
