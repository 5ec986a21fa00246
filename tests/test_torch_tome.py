"""The port's token merging (zutis_tpu_torch/ops/tome.py and the ToMe paths
of models/vit.py) against zutis_tpu/ops/tome.py and the flax CLIPViT on
numpy-seeded inputs, in f32.

The merge's decisions must be JAX's exactly: `merge_schedule`, every
`mapping` and every size are equal; merged tokens and model outputs are
held at rtol 2e-4, atol 2e-5 (summation order). The padded path reproduces
JAX's, the slot collision included: where a bucket has padding slots, two
or more valid tokens merge into one slot that held only padding (the JAX
package's recorded fault, ROADMAP.md section 3), in JAX and in the port
alike.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import zutis_tpu.ops.tome as JT
from zutis_tpu.models.vit import CLIPViT as JCLIPViT
from zutis_tpu_torch.engine.batched_eval import pad_batch
from zutis_tpu_torch.models import vit as V
from zutis_tpu_torch.models.vit import CLIPViT
from zutis_tpu_torch.models.weights import visual_params_from_jax
from zutis_tpu_torch.ops import tome as T

TOL = dict(rtol=2e-4, atol=2e-5)
VIT = dict(width=64, layers=3, heads=4, patch_size=16, output_dim=32,
           input_resolution=32)
BUCKET = (64, 64)  # a 4 x 4 token grid and CLS


@pytest.mark.parametrize("s0", [2, 3, 5, 17, 50, 577, 1281])
def test_merge_schedule_matches_jax(s0):
    for r in (0, 1, 3, 16, 90):
        for n_layers in (1, 4, 12):
            assert T.merge_schedule(s0, r, n_layers) == JT.merge_schedule(
                s0, r, n_layers), (r, n_layers)


def _sizes(kind, rng, b, s):
    if kind == "ones":
        return np.ones((b, s), np.float32)
    if kind == "counts":  # sizes of a stream that has merged before
        return rng.randint(1, 5, (b, s)).astype(np.float32)
    # padded: CLS and a prefix valid, the rest size 0, as forward_padded
    size = np.zeros((b, s), np.float32)
    for i, n in enumerate(rng.randint(2, s, b)):
        size[i, :n] = 1.0
    return size


def _merge_both(x, metric, size, r):
    got = T.tome_merge(*map(torch.from_numpy, (x, metric, size)), r)
    want = JT.tome_merge(*map(jnp.asarray, (x, metric, size)), r)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("kind", ["ones", "counts", "padded"])
@pytest.mark.parametrize("s,r", [(9, 2), (33, 7), (50, 16), (17, 8)])
def test_tome_merge_matches_jax(kind, s, r):
    rng = np.random.RandomState(s + r)
    b, d = 3, 16
    x = rng.randn(b, s, d).astype(np.float32)
    metric = rng.randn(b, s, 8).astype(np.float32)
    size = _sizes(kind, rng, b, s)
    (x_new, sz, mapping), (jx, jsz, jmapping) = _merge_both(x, metric, size, r)
    assert mapping.dtype == np.int32
    np.testing.assert_array_equal(mapping, jmapping)
    np.testing.assert_array_equal(sz, jsz)
    np.testing.assert_allclose(x_new, jx, **TOL)


def test_duplicates_merge_losslessly():
    """tests/test_tome.py's duplicates: a-tokens 2 and 4 copy b-tokens 1 and
    3, so the merged stream gathered back is x exactly, as in JAX."""
    rng = np.random.RandomState(0)
    s, d = 9, 16
    x = rng.randn(1, s, d).astype(np.float32)
    x[:, 2] = x[:, 1]
    x[:, 4] = x[:, 3]
    size = np.ones((1, s), np.float32)
    (x_new, sz, mapping), (jx, jsz, jmapping) = _merge_both(x, x, size, 2)
    np.testing.assert_array_equal(mapping, jmapping)
    np.testing.assert_array_equal(sz, jsz)
    np.testing.assert_array_equal(np.take_along_axis(x_new, mapping[..., None].astype(np.int64), 1), x)
    assert sorted(sz[0].tolist()) == [1] * 5 + [2, 2]
    np.testing.assert_allclose(x_new, jx, **TOL)


def test_proportional_attn_bias_matches_jax():
    size = np.array([[0.0, 1.0, 2.0, 7.0, 0.5], [3.0, 1.0, 0.0, 1.0, 40.0]],
                    np.float32)
    got = T.proportional_attn_bias(torch.from_numpy(size))
    want = np.asarray(JT.proportional_attn_bias(jnp.asarray(size)))
    assert got.shape == (2, 1, 1, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_tome_merge_refuses_what_it_cannot_merge():
    x = torch.zeros(1, 5, 4)
    with pytest.raises(ValueError, match="cannot merge"):
        T.tome_merge(x, x, torch.ones(1, 5), 3)


def _vit_pair(tome_r, seed=0):
    x = np.random.RandomState(seed).randn(2, 3, 64, 64).astype(np.float32)
    params = jax.tree.map(np.asarray, JCLIPViT(**VIT).init(
        jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    ours = CLIPViT(**VIT, tome_r=tome_r, device="cpu")
    ours.load_state_dict(visual_params_from_jax(params), strict=True)
    return JCLIPViT(**VIT, tome_r=tome_r), params, ours.eval(), x


@pytest.mark.parametrize("tome_r", [2, 4, 16])
def test_vit_tome_forward_and_encode_image_match_flax(tome_r):
    jvit, params, ours, x = _vit_pair(tome_r)
    want, h, w = jax.jit(lambda p, x: jvit.apply({"params": p}, x))(
        params, jnp.asarray(x))
    want_pooled = jax.jit(lambda p, x: jvit.apply(
        {"params": p}, x, method=JCLIPViT.encode_image))(params, jnp.asarray(x))
    with torch.no_grad():
        got, gh, gw = ours(torch.from_numpy(x))
        pooled = ours.encode_image(torch.from_numpy(x))
    assert (gh, gw) == (4, 4) and got.shape == (2, 16, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), **TOL)


def _recorder(fn, seen):
    """`fn` (a tome_merge), recording each call's sizes and mapping."""
    def recorded(x, metric, size, r):
        out = fn(x, metric, size, r)
        seen.append((np.asarray(size), np.asarray(out[2])))
        return out
    return recorded


def _most_valid_into_an_empty_slot(size, mapping) -> int:
    """The most valid tokens that one merge sent into a slot that held
    only padding (a size-0 token among its sources)."""
    worst = 0
    for sz, mp in zip(size, mapping):
        for slot in np.unique(mp):
            src = sz[mp == slot]
            if (src == 0).any():
                worst = max(worst, int((src > 0).sum()))
    return worst


@pytest.mark.parametrize("sizes", [[(64, 64), (64, 64)], [(64, 64), (48, 64)]],
                         ids=["full_bucket", "partly_filled"])
def test_forward_padded_tome_matches_jax(sizes, monkeypatch):
    """The padded path's merges equal JAX's block by block (mappings and
    sizes exactly), and the tokens match. On a partly filled bucket both
    send several valid tokens into the first padding slot (the 1.5 score
    ties every valid row to it)."""
    jvit, params, ours, _ = _vit_pair(6, seed=1)
    rng = np.random.RandomState(2)
    imgs = [rng.randn(3, h, w).astype(np.float32) for h, w in sizes]
    padded, grid, _ = pad_batch(imgs, BUCKET, len(imgs), 16)
    seen_jax, seen_port = [], []
    monkeypatch.setattr(JT, "tome_merge", _recorder(JT.tome_merge, seen_jax))
    monkeypatch.setattr(V, "tome_merge", _recorder(V.tome_merge, seen_port))
    want, want_valid = jvit.apply({"params": params}, jnp.asarray(padded),
                                  jnp.asarray(grid),
                                  method=JCLIPViT.forward_padded)
    with torch.no_grad():
        got, valid = ours.forward_padded(torch.from_numpy(padded),
                                         torch.from_numpy(grid))
    assert len(seen_port) == len(seen_jax) == 3  # merges of 6, 5 and 2
    for (sz, mp), (jsz, jmp) in zip(seen_port, seen_jax):
        np.testing.assert_array_equal(sz, jsz)
        np.testing.assert_array_equal(mp, jmp)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    window = valid.numpy().astype(bool)
    np.testing.assert_allclose(got.numpy()[window], np.asarray(want)[window],
                               **TOL)
    worst = max(_most_valid_into_an_empty_slot(*m) for m in seen_port)
    assert worst == max(_most_valid_into_an_empty_slot(*m) for m in seen_jax)
    if sizes[1] == (64, 64):
        assert worst == 0  # no padding, no size-0 slot
    else:
        assert worst >= 2  # the recorded collision, reproduced
