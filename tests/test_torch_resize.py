"""The port's resize (zutis_tpu_torch.ops.resize) against the JAX package's.

Both build the same float64 weight matrices and apply them in f32, so the
tolerance is f32 summation order only: rtol 1e-6, atol 1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zutis_tpu.ops import resize as jresize
from zutis_tpu_torch.ops import resize as tresize

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["linear", "cubic"])
@pytest.mark.parametrize("in_size,out_size,scale", [
    (24, 48, None), (24, 17, None), (7, 14, 0.5), (14, 14, 14 / 14.1),
    (5, 5, None),
])
def test_resize_matrix_is_identical(mode, in_size, out_size, scale):
    np.testing.assert_array_equal(
        tresize._resize_matrix(in_size, out_size, mode, scale),
        jresize._resize_matrix(in_size, out_size, mode, scale))


@pytest.mark.parametrize("mode", ["linear", "cubic"])
@pytest.mark.parametrize("size,scales", [
    ((17, 31), None),
    ((8, 12), (0.5, 0.5)),
    ((4, 4), (4 / 4.1, 4 / 4.1)),  # the CLIP pos-emb +0.1 fudge at the native grid
])
def test_resize_2d_matches_jax(mode, size, scales):
    x = np.random.RandomState(0).randn(2, 3, 4, 6).astype(np.float32)
    got = tresize.resize_2d(torch.from_numpy(x), size, mode=mode, scales=scales)
    want = jresize.resize_2d(jnp.asarray(x), size, mode=mode, scales=scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_interpolate_scale_factor_matches_jax(mode):
    x = np.random.RandomState(1).randn(1, 4, 12, 10).astype(np.float32)
    got = tresize.interpolate(torch.from_numpy(x), scale_factor=2, mode=mode)
    want = jresize.interpolate(jnp.asarray(x), scale_factor=2, mode=mode)
    assert got.shape == (1, 4, 24, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_interpolate_size_matches_jax_and_keeps_dtype():
    x = np.random.RandomState(2).randn(2, 5, 7, 9).astype(np.float32)
    got = tresize.interpolate(torch.from_numpy(x).bfloat16(), size=(14, 18))
    want = jresize.interpolate(jnp.asarray(x, jnp.bfloat16), size=(14, 18))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1 / 128, atol=1 / 128)


def test_identity_without_scales():
    x = torch.arange(24.0).reshape(1, 1, 4, 6)
    assert tresize.resize_2d(x, (4, 6)) is x
