"""The port's batched Hungarian matcher (zutis_tpu_torch.ops.hungarian, its
plain version on the CPU) against the JAX package's batched_hungarian and
against scipy's linear_sum_assignment.

col4row must equal JAX's exactly: the plain version runs the JAX loop's f32
operations in its order, with the lowest column winning an argmin tie, so
tied and constant-row costs come out the same too. The total cost must
equal scipy's optimum to rtol 1e-5 (f32 potentials)."""
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from zutis_tpu.ops.hungarian import batched_hungarian as jbatched_hungarian
from zutis_tpu_torch.ops.hungarian import (
    batched_hungarian,
    batched_hungarian_reference,
)


def make_costs(kind: str, seed: int = 0, shape=(48, 10, 100)) -> np.ndarray:
    """Cost sets of the training step's shape: random dice+BCE-like values,
    small integers (many ties), and padded rows set to a constant."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.rand(*shape).astype(np.float32) * 3
    if kind == "ties":
        return rng.randint(0, 4, shape).astype(np.float32)
    if kind == "padded rows":
        c = (rng.rand(*shape) * 3).astype(np.float32)
        c[:, 4:] = 0.0  # the criterion's padded rows
        c[::7] = 0.0  # problems with every row padded
        return c
    if kind == "square":
        return rng.randn(6, 9, 9).astype(np.float32)
    if kind == "one row":
        return rng.rand(5, 1, 7).astype(np.float32)
    raise ValueError(kind)


KINDS = ["random", "ties", "padded rows", "square", "one row"]


@pytest.mark.parametrize("kind", KINDS)
def test_col4row_equals_jax(kind):
    cost = make_costs(kind)
    got = batched_hungarian(torch.from_numpy(cost))
    want = np.asarray(jbatched_hungarian(jnp.asarray(cost)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_total_cost_is_scipys_optimum(kind):
    cost = make_costs(kind, seed=1)
    col4row = batched_hungarian(torch.from_numpy(cost)).numpy()
    R = cost.shape[1]
    for p in range(cost.shape[0]):
        assert len(set(col4row[p].tolist())) == R, "a column given twice"
        rows, cols = linear_sum_assignment(cost[p].astype(np.float64))
        got = cost[p][np.arange(R), col4row[p]].astype(np.float64).sum()
        want = cost[p][rows, cols].astype(np.float64).sum()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_batch_axes_are_kept():
    cost = make_costs("random", seed=2).reshape(6, 8, 10, 100)
    got = batched_hungarian(torch.from_numpy(cost))
    assert got.shape == (6, 8, 10)
    flat = batched_hungarian(torch.from_numpy(cost.reshape(48, 10, 100)))
    torch.testing.assert_close(got.reshape(48, 10), flat, rtol=0, atol=0)


def test_nan_costs_terminate():
    cost = np.full((4, 10, 100), np.nan, np.float32)
    cost[1, 3, 5] = 1.0
    cost[2] = make_costs("random", seed=3)[0]
    cost[2, 0, 0] = np.nan
    got = batched_hungarian(torch.from_numpy(cost))  # returns: the bounds hold
    assert got.shape == (4, 10)
    want = np.asarray(jbatched_hungarian(jnp.asarray(cost)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_more_rows_than_columns_is_refused():
    with pytest.raises(ValueError, match="R <= C"):
        batched_hungarian_reference(torch.zeros(2, 5, 4))
