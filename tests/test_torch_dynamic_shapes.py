"""The port's per-sample geometry ops (zutis_tpu_torch.ops.dynamic_shapes)
against zutis_tpu/ops/dynamic_shapes.py on numpy-seeded inputs.

Resize matrices, `token_valid_mask` and `replicate_edges` must be bit-equal:
the matrices decide which pixels of an upsampled proposal clear the
threshold. The positional embeddings and the batched resize go through
products and transcendental functions that XLA and torch sum or round in
their own order, so they are held at rtol 2e-4, atol 2e-5 (f32)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zutis_tpu.ops import dynamic_shapes as JD
from zutis_tpu_torch.ops import dynamic_shapes as D

TOL = dict(rtol=2e-4, atol=2e-5)

# (out, in_pad, native extents): upsampling, downsampling, equal sizes, the
# eval bucket's 64 x 2 feature rows to 512 pixel rows, and extents of 1
SWEEP = [(40, 32, [17, 32, 1]), (8, 32, [31, 5, 32]), (24, 24, [24, 23, 12]),
         (512, 64, [60, 61, 62, 64, 1]), (640, 80, [80, 78, 76, 40]),
         (7, 3, [1, 2, 3])]


@pytest.mark.parametrize("mode", ["linear", "cubic"])
@pytest.mark.parametrize("out,in_pad,natives", SWEEP, ids=str)
def test_resize_matrix_bit_equal(out, in_pad, natives, mode):
    got = D.dynamic_resize_matrix(out, in_pad, torch.tensor(natives), mode)
    for i, n in enumerate(natives):
        want = np.asarray(JD.dynamic_resize_matrix(out, in_pad, jnp.asarray(n),
                                                   mode))
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("feat,pixels,out", [
    ([60, 62, 64], [480, 496, 512], 512), ([80, 76, 78], [640, 608, 624], 640),
    ([4, 6, 2], [37, 48, 33], 48), ([2, 4], [20, 33], 48)])
def test_resize_matrix_with_native_scale_bit_equal(feat, pixels, out):
    """The decode's matrices: scale = f32(feature extent) / f32(pixel
    extent), as batched_eval._native_resize_mats builds them."""
    feat_t, pix_t = torch.tensor(feat), torch.tensor(pixels)
    scale = feat_t.float() / pix_t.float()
    in_pad = max(feat)
    got = D.dynamic_resize_matrix(out, in_pad, feat_t, "linear", scale=scale)
    for i, (nf, npx) in enumerate(zip(feat, pixels)):
        nf_j, np_j = jnp.asarray(nf), jnp.asarray(npx)
        want = JD.dynamic_resize_matrix(
            out, in_pad, nf_j, "linear",
            scale=nf_j.astype(jnp.float32) / np_j.astype(jnp.float32))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_batched_resize_native_matches_jax():
    rng = np.random.RandomState(0)
    sizes = [(20, 24), (13, 17), (7, 24)]
    x = rng.randn(3, 3, 20, 24).astype(np.float32)
    got = D.batched_resize_native(torch.from_numpy(x), torch.tensor(sizes),
                                  (37, 51))
    want = JD.batched_resize_native(jnp.asarray(x), jnp.asarray(sizes),
                                    (37, 51))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sizes", [[[3, 4], [5, 6]], [[1, 1], [5, 1], [1, 6]]])
def test_replicate_edges_bit_equal(sizes):
    x = np.random.RandomState(1).randn(len(sizes), 5, 6, 3).astype(np.float32)
    got = D.replicate_edges(torch.from_numpy(x), torch.tensor(sizes))
    want = JD.replicate_edges(jnp.asarray(x), jnp.asarray(sizes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hp,wp,npf,sizes", [
    (9, 11, 32, [(9, 11), (5, 7)]), (64, 80, 384, [(60, 80), (64, 76)])])
def test_sine_pos_embed_dynamic_matches_jax(hp, wp, npf, sizes):
    got = D.sine_pos_embed_dynamic(hp, wp, npf, torch.tensor(sizes))
    want = JD.sine_pos_embed_dynamic(hp, wp, npf, jnp.asarray(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g,hp,wp,sizes", [
    (14, 12, 13, [(12, 13), (6, 9)]), (2, 3, 3, [(3, 3), (1, 2), (2, 1)])])
def test_interpolate_pos_embed_batched_matches_jax(g, hp, wp, sizes):
    pe = np.random.RandomState(2).randn(g * g + 1, 16).astype(np.float32)
    got = D.interpolate_pos_embed_batched(torch.from_numpy(pe),
                                          torch.tensor(sizes), (hp, wp))
    want = JD.interpolate_pos_embed_batched(jnp.asarray(pe),
                                            jnp.asarray(sizes), (hp, wp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hp,wp,sizes", [
    (4, 4, [[2, 3], [4, 4], [1, 1]]), (32, 40, [[30, 40], [31, 39], [32, 38]])])
def test_token_valid_mask_bit_equal(hp, wp, sizes):
    got = D.token_valid_mask(torch.tensor(sizes), hp, wp)
    want = JD.token_valid_mask(jnp.asarray(sizes), hp, wp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

