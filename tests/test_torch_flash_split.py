"""The f32 flash kernel's split-key path, as its plain version
(`flash_attention_split_reference`), against the unsplit plain version and
the JAX package's flash_attention (the Pallas kernel in interpret mode, as
tests/test_flash_attention.py runs it on the CPU); and the rule that picks
the split count (`key_splits`).

Inputs are numpy-seeded f32. The split version sums each key range apart
and merges the ranges with their own maxima, so it differs from one softmax
over all keys only in rounding: held to rtol 2e-4 / atol 2e-5, the JAX
package's own flash-against-XLA tolerance widened for the reassociation.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zutis_tpu.ops.flash_attention import flash_attention as jflash
from zutis_tpu_torch.ops import flash_attention as fa

RTOL, ATOL = 2e-4, 2e-5
# name -> ([b, h, sq, sk, d], n_splits, masked)
CASES = {
    "d64 one range": ((2, 2, 20, 333, 64), 1, False),
    "d64 two ranges": ((2, 2, 20, 333, 64), 2, False),
    "d96 ragged three ranges": ((1, 3, 33, 200, 96), 3, False),
    "d64 one chunk a range": ((1, 2, 20, 320, 64), 5, False),
    "d96 eight ranges": ((2, 1, 70, 513, 96), 8, False),
    "ranges past the last chunk": ((1, 2, 20, 130, 64), 6, False),
    "d64 masked": ((3, 2, 20, 333, 64), 4, True),
    "d96 masked": ((3, 2, 40, 260, 96), 3, True),
    "d64 masked one range": ((3, 1, 20, 200, 64), 1, True),
    # the wide f32 kernel's chunks: 64 keys at d 128, 32 at 256 and 320,
    # 16 above
    "d128 three ranges": ((1, 2, 20, 333, 128), 3, False),
    "d256 masked": ((3, 2, 20, 300, 256), 4, True),
    "d320 ragged five ranges": ((1, 2, 30, 161, 320), 5, False),
    "d384 masked": ((3, 1, 20, 200, 384), 3, True),
    "d512 ranges past the last chunk": ((1, 1, 20, 40, 512), 4, False),
}


def _inputs(seed, shape, masked):
    """numpy q, k, v [b, h, s, d] and a mask [b, sk] in which item 1 has no
    valid key and item 0 none in keys 64..191 (a whole range when a range
    holds one or two chunks), or None."""
    b, h, sq, sk, d = shape
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk))
    mask = None
    if masked:
        mask = (rng.rand(b, sk) > 0.3).astype(np.int32)
        mask[1] = 0
        mask[0, 64:192] = 0
    return q, k, v, mask


def _split(q, k, v, mask, n):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    return fa.flash_attention_split_reference(*t, m, n).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_split_reference_matches_the_unsplit_plain_version(name):
    shape, n, masked = CASES[name]
    q, k, v, mask = _inputs(0, shape, masked)
    want = fa.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(_split(q, k, v, mask, n), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", [
    "d64 two ranges", "d96 ragged three ranges", "d96 eight ranges",
    "d64 masked", "d96 masked"])
def test_split_reference_matches_the_jax_flash_attention(name):
    shape, n, masked = CASES[name]
    q, k, v, mask = _inputs(1, shape, masked)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  kv_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(_split(q, k, v, mask, n), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_an_item_with_no_valid_key_comes_out_zero(n):
    q, k, v, mask = _inputs(2, (3, 2, 20, 300, 64), masked=True)
    got = _split(q, k, v, mask, n)
    assert np.isfinite(got).all()
    assert (got[1] == 0).all()


def test_a_range_with_no_valid_key_gets_no_weight():
    """Item 0's second of three 64-key ranges is wholly masked: its m is
    -inf and its l 0, and the result is that of the other two ranges."""
    b, h, sq, sk, d = 2, 2, 20, 192, 64
    q, k, v, _ = _inputs(3, (b, h, sq, sk, d), masked=False)
    mask = np.ones((b, sk), np.int32)
    mask[0, 64:128] = 0
    got = _split(q, k, v, mask, 3)
    keep = np.r_[0:64, 128:192]
    want = fa.flash_attention_reference(
        torch.from_numpy(q[:1]), torch.from_numpy(k[:1, :, keep]),
        torch.from_numpy(v[:1, :, keep])).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:1], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sk,n,per", [
    (5504, 22, 4), (5504, 1, 86), (65, 2, 1), (64, 3, 1), (1, 1, 1),
    (577, 4, 3),
])
def test_split_chunks_cut_ranges_as_the_kernel_does(sk, n, per):
    assert fa.split_chunks(sk, n) == per


# [b, h, sq, sk] of SelfMask's f32 calls (encoder self, decoder self, cross)
# and the f32 image bank's, with the split count key_splits gives
@pytest.mark.parametrize("shape,want", [
    ((1, 6, 5505, 5505), 1),   # 258 blocks of 128 rows: the card is full
    ((1, 6, 20, 20), 1),       # one key chunk: nothing to split
    ((32, 16, 577, 577), 1),   # 2,560 blocks
], ids=str)
def test_key_splits_leaves_calls_that_fill_the_card_whole(shape, want):
    assert fa.key_splits(*shape) == want


def test_key_splits_fills_one_wave_at_the_selfmask_cross_shape():
    b, h, sq, sk = 1, 6, 20, 5504  # 6 blocks of 64 rows over 86 chunks
    n = fa.key_splits(b, h, sq, sk)
    assert n >= 16
    per = fa.split_chunks(sk, n)
    assert per >= fa.MIN_SPLIT_CHUNKS
    assert (n - 1) * per < -(-sk // fa.KEY_CHUNK)  # no range is empty
    assert b * h * n <= fa.SMS                     # one wave


@pytest.mark.parametrize("sq,d,rows", [
    (1, 64, 64), (20, 64, 64), (64, 64, 64), (65, 64, 128), (5505, 64, 128),
    (20, 96, 64), (5505, 96, 64), (100, 80, 64), (100, 128, 64),
    (5505, 512, 64),
])
def test_block_rows_takes_one_warpgroup_for_short_queries_and_d96(sq, d, rows):
    assert fa.block_rows(sq, d) == rows


@pytest.mark.parametrize("d,keys", [(64, 64), (80, 64), (96, 64), (128, 64),
                                    (256, 32), (320, 32), (384, 16),
                                    (512, 16)])
def test_f32_chunk_keys_follow_the_kernels(d, keys):
    assert fa.f32_chunk_keys(d) == keys


@pytest.mark.parametrize("d", fa.F32_WIDE_HEAD_DIMS)
def test_key_splits_fills_one_wave_at_the_wide_heads(d):
    """One image's wide decoder cross-attention (8 heads of 100 queries:
    16 blocks) splits into ranges of at least MIN_SPLIT_KEYS keys, about one
    wave and none empty; a batch of 8 (128 blocks) stays whole."""
    sk = 2304 if d == 128 else 576
    n = fa.key_splits(1, 8, 100, sk, d)
    per = fa.split_chunks(sk, n, d)
    keys = fa.f32_chunk_keys(d)
    assert n > 1
    assert per >= fa.MIN_SPLIT_CHUNKS and per * keys >= fa.MIN_SPLIT_KEYS
    assert (n - 1) * per < -(-sk // keys)   # no range is empty
    assert 16 * n <= fa.SMS                  # one wave
    assert fa.key_splits(8, 8, 100, sk, d) == 1


@pytest.mark.parametrize("sk,n,d,per", [
    (576, 5, 512, 8), (576, 4, 256, 5), (2304, 8, 128, 5), (33, 2, 320, 1),
    (1, 3, 384, 1),
])
def test_split_chunks_count_the_wide_kernels_chunks(sk, n, d, per):
    assert fa.split_chunks(sk, n, d) == per


@pytest.mark.parametrize("b,h,sq,sk", [
    (1, 1, 1, 1), (1, 2, 100, 300), (3, 8, 64, 200), (2, 4, 100, 65),
    (1, 6, 20, 5504), (1, 1, 20, 100000), (0, 6, 20, 5504),
])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_key_splits_never_makes_an_empty_range(b, h, sq, sk, d):
    n = fa.key_splits(b, h, sq, sk, d)
    assert n >= 1
    assert (n - 1) * fa.split_chunks(sk, n, d) < -(-sk // fa.f32_chunk_keys(d))
