"""The port's Keras-form Adam, row-sparse table Adam and learning-rate
schedule against the JAX package's (``bayesgm_tpu/ops/optim.py``): the same
numpy parameters and gradients go through both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from bayesgm_tpu.ops import optim as joptim  # noqa: E402
from bayesgm_torch.ops import optim as toptim  # noqa: E402

# f32 elementwise arithmetic in another order (fused adds) over a few steps;
# m / (sqrt(v) + eps) is O(1) per element, so relative 1e-5 is ~100 ulp.
TOL = dict(rtol=1e-5, atol=1e-6)


def test_adam_matches_jax_over_several_steps():
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (7,), (3, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp, js = list(map(jnp.asarray, params)), None
    js = joptim.adam_init(jp)
    tp = [torch.as_tensor(p.copy()) for p in params]
    ts = toptim.adam_init(tp)
    for step in range(6):
        grads = [(rng.normal(size=s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
                 for s in shapes]
        lr = 1e-3 * (0.5 + step)
        jp, js = joptim.adam_update([jnp.asarray(g) for g in grads], js, jp, lr)
        ts = toptim.adam_update([torch.as_tensor(g) for g in grads], ts, tp, lr)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert ts.t == int(js.t) == 6
    for a, b in zip(ts.m + ts.v, list(js.m) + list(js.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_adam_is_keras_form_not_torch_adam():
    """b2 = 0.99 and eps outside the corrected root: one step from zero
    moments moves each element by exactly lr * g / (|g| + eps * ...)."""
    p = torch.zeros(3)
    g = torch.tensor([1e-3, 1.0, -4.0])
    toptim.adam_update([g], toptim.adam_init([p]), [p], 0.1)
    lr_t = 0.1 * np.sqrt(1 - 0.99) / (1 - 0.9)
    want = -lr_t * 0.1 * g.numpy() / (np.sqrt(0.01) * np.abs(g.numpy()) + 1e-7)
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-5)


def test_table_adam_matches_jax_over_permuted_batches():
    """Row-sparse Adam over a few permuted batches, with a batch that
    repeats a row: table, moments and step count match JAX, and rows a
    batch does not touch keep their values while their moments decay."""
    rng = np.random.default_rng(1)
    n, d = 23, 4
    table = rng.normal(size=(n, d)).astype(np.float32)
    jt, js = jnp.asarray(table), joptim.table_adam_init(jnp.asarray(table))
    tt = torch.as_tensor(table.copy())
    ts = toptim.table_adam_init(tt)
    batches = [rng.permutation(n)[:8] for _ in range(4)] + [np.array([3, 3, 5])]
    for k, idx in enumerate(batches):
        grads = rng.normal(size=(len(idx), d)).astype(np.float32)
        untouched = np.setdiff1d(np.arange(n), idx)
        before_t, before_m = tt.clone(), ts.m.clone()
        jt, js = joptim.table_adam_update_rows(jnp.asarray(grads), jnp.asarray(idx), js, jt,
                                               2e-3)
        ts = toptim.table_adam_update_rows(torch.as_tensor(grads), torch.as_tensor(idx), ts,
                                           tt, 2e-3)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
        np.testing.assert_allclose(ts.m.numpy(), np.asarray(js.m), **TOL)
        np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), **TOL)
        assert torch.equal(tt[untouched], before_t[untouched])
        torch.testing.assert_close(ts.m[untouched], 0.9 * before_m[untouched])
    assert ts.t == int(js.t) == len(batches)


@pytest.mark.parametrize("decay", ["cosine", "linear", None, ""])
def test_lr_schedule_scale_matches_jax(decay):
    for total in (1, 7, 100):
        for epoch in range(0, total + 2):
            want = float(joptim.lr_schedule_scale(decay, epoch, total))
            assert toptim.lr_schedule_scale(decay, epoch, total) == want
