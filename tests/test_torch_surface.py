"""Every public symbol of the JAX package has its counterpart in the port:
the top-level ``_SYMBOL_TO_MODULE``, ``bayesgm_tpu.utils.__all__``, the
network facade's and ``parallel``'s ``__all__`` each resolve from the
matching ``bayesgm_torch`` module, every public function and class of each
``bayesgm_tpu`` module has its namesake in the matching port module (but
for the helpers the port replaces by design, :data:`BY_DESIGN`), and the
kernel facade ``bayesgm_torch.ops.kernels`` re-exports the port's
counterpart of each name of ``bayesgm_tpu/ops/pallas_kernels.py`` that
the port has."""

import ast
import importlib
import inspect
import os
import pkgutil

import pytest

pytest.importorskip("torch")

import bayesgm_tpu  # noqa: E402
import bayesgm_tpu.models.networks as jnetworks  # noqa: E402
import bayesgm_tpu.utils as jutils  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED = set()

# What the port replaces by design (ROADMAP.md, Queue 1): a JAX module with
# no port file maps to None; otherwise the names the port does without.
BY_DESIGN = {
    "bayesgm_tpu.utils.runtime": None,  # the device= argument, utils/device.resolve_device
    "bayesgm_tpu.ops.pallas_kernels": None,  # bayesgm_torch/ops/kernels.py (test_kernel_facade)
    "bayesgm_tpu.ops._pk_util": {"on_tpu", "key_to_seed"},
    "bayesgm_tpu.ops.nn": {"flipout_dense_apply", "mlp_l2_penalty"},  # and init_*
    "bayesgm_tpu.ops.conv": {"generator_is_bayesian"},  # and init_*
}
INIT_BY_DESIGN = ("bayesgm_tpu.ops.nn", "bayesgm_tpu.ops.conv")  # nn.Module classes instead
JAX_MODULES = sorted(m.name for m in pkgutil.walk_packages(bayesgm_tpu.__path__, "bayesgm_tpu."))


def _port_module(jax_module: str) -> str:
    return "bayesgm_torch" + jax_module[len("bayesgm_tpu"):]


@pytest.mark.parametrize("name", sorted(bayesgm_tpu._SYMBOL_TO_MODULE))
def test_top_level_symbol(name):
    import bayesgm_torch

    module = bayesgm_tpu._SYMBOL_TO_MODULE[name]
    assert not any(module.startswith(m) for m in NOT_PORTED)
    assert bayesgm_torch._SYMBOL_TO_MODULE[name] == _port_module(module)
    assert getattr(bayesgm_torch, name) is getattr(importlib.import_module(_port_module(module)),
                                                   name)


def test_utils_and_network_facade_exports():
    import bayesgm_torch.models
    import bayesgm_torch.models.networks as tnetworks
    import bayesgm_torch.utils as tutils

    assert list(tutils.__all__) == list(jutils.__all__)
    for name in jutils.__all__:
        assert callable(getattr(tutils, name))
    assert list(tnetworks.__all__) == list(jnetworks.__all__)
    for name in jnetworks.__all__:
        assert getattr(bayesgm_torch.models, name) is getattr(tnetworks, name)


def test_kernel_facade():
    """The port's facade holds every name of the JAX facade whose module has
    it in the port, and nothing else."""
    from bayesgm_torch.ops import kernels

    with open(os.path.join(REPO, "bayesgm_tpu", "ops", "pallas_kernels.py")) as f:
        tree = ast.parse(f.read())
    expected = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith("bayesgm_tpu"):
            port = importlib.import_module(_port_module(node.module))
            expected |= {a.name for a in node.names if hasattr(port, a.name)}
    assert set(kernels.__all__) == expected
    assert {"make_fused_causal_logp_bnn_hosteps", "make_fused_causal_logp_and_grad_bnn_hosteps",
            "make_fused_causal_logp", "make_fused_causal_logp_and_grad",
            "make_fused_causal_logp_bnn", "make_fused_causal_logp_and_grad_bnn",
            "make_fused_mh_steps_bnn"} <= expected
    for name in kernels.__all__:
        assert getattr(kernels, name) is not None


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_public_names(module):
    """Each public function and class defined in ``module`` has its
    namesake in the port's module of the same path."""
    if BY_DESIGN.get(module, ()) is None:
        return
    jmod = importlib.import_module(module)
    names = {k for k, o in vars(jmod).items()
             if not k.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
             and o.__module__ == module}
    names -= BY_DESIGN.get(module, set())
    if module in INIT_BY_DESIGN:
        names = {k for k in names if not k.startswith("init_")}
    port = importlib.import_module(_port_module(module))
    assert sorted(k for k in names if not hasattr(port, k)) == []


def test_parallel_exports():
    import bayesgm_tpu.parallel as jparallel
    import bayesgm_torch.parallel as tparallel

    assert list(tparallel.__all__) == list(jparallel.__all__)
    for name in jparallel.__all__:
        assert callable(getattr(tparallel, name))
