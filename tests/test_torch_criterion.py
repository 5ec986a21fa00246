"""The port's training criterion (zutis_tpu_torch.losses.criterion) against
zutis_tpu.losses.criterion on the same numpy-seeded inputs, in f32.

Values agree to rtol 2e-5 (the same products summed in another order);
the matcher's query indices and the semantic argmax are equal; the
gradients of the loss with respect to the proposals and the patch tokens
(through the checkpointed layer costs and both straight-through clips)
agree to 2e-5 of each tensor's largest |gradient|. The batch holds an image
whose valid GT masks have no pixel (it must add nothing), padded rows and a
wholly padded image, and ignored labels."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.losses import criterion as jcrit
from zutis_tpu_torch.losses import criterion as crit

TOL = dict(rtol=2e-5, atol=2e-6)
B, L, Q, N, H, W = 3, 2, 8, 3, 32, 40
HF, WF, TEXT_DIM, N_CAT, IGNORE = 8, 10, 16, 6, 255


def make_inputs(seed=0):
    rng = np.random.RandomState(seed)
    proposals = 1 / (1 + np.exp(-3 * rng.randn(B, L, Q, HF, WF)))
    gt = (rng.rand(B, N, H, W) > 0.6).astype(np.float32)
    valid = np.ones((B, N), bool)
    valid[0, 2] = False  # a padded row
    gt[0, 2] = 0.0
    gt[1] = 0.0  # valid rows with no GT pixel: the image adds nothing
    valid[2] = False  # a wholly padded image
    tokens = rng.randn(B, HF, WF, TEXT_DIM)
    tokens /= np.linalg.norm(tokens, axis=-1, keepdims=True)
    sem = rng.randint(0, N_CAT, (B, H, W)).astype(np.int32)
    sem[:, :5] = IGNORE
    text = rng.randn(N_CAT, TEXT_DIM)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    return dict(mask_proposals=proposals.astype(np.float32), gt=gt,
                valid=valid, tokens=tokens.astype(np.float32), sem=sem,
                text=text.astype(np.float32))


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def _jax_loss(x, **kw):
    return jcrit.criterion_loss(
        jnp.asarray(x["mask_proposals"]), jnp.asarray(x["gt"]),
        jnp.asarray(x["valid"]), jnp.asarray(x["tokens"]),
        jnp.asarray(x["sem"]), jnp.asarray(x["text"]), ignore_index=IGNORE,
        **kw)


def _port_loss(x, grad=False, **kw):
    proposals = torch.from_numpy(x["mask_proposals"]).requires_grad_(grad)
    tokens = torch.from_numpy(x["tokens"]).requires_grad_(grad)
    out = crit.criterion_loss(
        proposals, torch.from_numpy(x["gt"]), torch.from_numpy(x["valid"]),
        tokens, torch.from_numpy(x["sem"]), torch.from_numpy(x["text"]),
        ignore_index=IGNORE, **kw)
    return out, proposals, tokens


@pytest.mark.parametrize("weights", [
    {}, dict(weight_ce_loss=0.5, weight_mask_loss=2.0, weight_dice_loss=0.3,
             weight_bce_loss=1.7)])
def test_criterion_loss_matches_jax(inputs, weights):
    want = jax.tree.map(np.asarray, jax.jit(
        lambda: _jax_loss(inputs, **weights))())
    got, _, _ = _port_loss(inputs, **weights)
    for key in ("loss", "ce_loss", "mask_loss"):
        np.testing.assert_allclose(got[key].item(), want[key], err_msg=key, **TOL)
    np.testing.assert_array_equal(got["query_indices"].numpy(),
                                  want["query_indices"])
    np.testing.assert_array_equal(got["sem_pred"].numpy(), want["sem_pred"])
    assert got["sem_pred"].dtype == torch.int32
    assert got["query_indices"].shape == (L, B, N)


def test_images_without_gt_pixels_add_no_mask_loss(inputs):
    """Zeroing the proposals of images 1 (no GT pixel) and 2 (all padded)
    leaves the mask loss as it was, on both sides."""
    changed = dict(inputs)
    changed["mask_proposals"] = inputs["mask_proposals"].copy()
    changed["mask_proposals"][1:] = 0.5
    base, _, _ = _port_loss(inputs)
    got, _, _ = _port_loss(changed)
    assert got["mask_loss"].item() == base["mask_loss"].item()
    np.testing.assert_allclose(got["mask_loss"].item(),
                               float(_jax_loss(changed)["mask_loss"]), **TOL)


def test_criterion_gradients_match_jax(inputs):
    def loss(p, t):
        x = dict(inputs, mask_proposals=p, tokens=t)
        return _jax_loss(x)["loss"]

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(inputs["mask_proposals"]), jnp.asarray(inputs["tokens"]))
    got, proposals, tokens = _port_loss(inputs, grad=True)
    got["loss"].backward()
    for name, g, w in (("proposals", proposals.grad, want[0]),
                       ("tokens", tokens.grad, want[1])):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 2e-5, f"d{name}: {err:.3e} of the largest |gradient|"
    assert proposals.grad[2].abs().max() == 0  # the wholly padded image


def test_criterion_class_forwards_its_weights(inputs):
    c = crit.Criterion(torch.from_numpy(inputs["text"]), weight_ce_loss=0.5,
                       weight_bce_loss=2.0, ignore_index=IGNORE)
    got = c(torch.from_numpy(inputs["mask_proposals"]),
            torch.from_numpy(inputs["gt"]), torch.from_numpy(inputs["valid"]),
            torch.from_numpy(inputs["tokens"]), torch.from_numpy(inputs["sem"]))
    want = jcrit.Criterion(jnp.asarray(inputs["text"]), weight_ce_loss=0.5,
                           weight_bce_loss=2.0, ignore_index=IGNORE)(
        *(jnp.asarray(inputs[k]) for k in ("mask_proposals", "gt", "valid",
                                            "tokens", "sem")))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), **TOL)


def test_more_instances_than_queries_is_refused(inputs):
    x = dict(inputs)
    x["gt"] = np.zeros((B, Q + 1, H, W), np.float32)
    x["valid"] = np.ones((B, Q + 1), bool)
    with pytest.raises(ValueError, match="queries"):
        _port_loss(x)


def _pair(seed, lead, n=4, q=5, hw=(6, 7)):
    rng = np.random.RandomState(seed)
    dt = (1 / (1 + np.exp(-2 * rng.randn(*lead, q, *hw)))).astype(np.float32)
    dt[..., 0, 0, 0] = 0.0  # log(0): the -100 clamp
    dt[..., 1, 0, 0] = 1.0  # log1p(-1)
    gt = (rng.rand(*lead, n, *hw) > 0.5).astype(np.float32)
    return dt, gt


@pytest.mark.parametrize("name", ["dice_cost", "bce_cost"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_pairwise_costs_match_jax(name, lead):
    dt, gt = _pair(1, lead)
    flat = lambda a: a.reshape(a.shape[:-2] + (-1,))  # noqa: E731
    got = getattr(crit, name)(torch.from_numpy(flat(dt)), torch.from_numpy(flat(gt)))
    want = getattr(jcrit, name)(jnp.asarray(flat(dt)), jnp.asarray(flat(gt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["dice_cost_2d", "bce_cost_2d"])
def test_unflattened_costs_match_jax_and_the_flat_form(name):
    dt, gt = _pair(2, (3,))
    got = getattr(crit, name)(torch.from_numpy(dt), torch.from_numpy(gt))
    want = getattr(jcrit, name)(jnp.asarray(dt), jnp.asarray(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    flat = getattr(crit, name[:-3])(torch.from_numpy(dt).flatten(-2),
                                    torch.from_numpy(gt).flatten(-2))
    np.testing.assert_allclose(got.numpy(), flat.numpy(), **TOL)


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_cross_entropy_matches_jax(bounded, channels_last, scale):
    """Logits within the bound (|x| <= 1) and far outside it (up to ~120,
    where the bounded form's clamp at 30 takes over), with ignored pixels;
    the loss and its gradient."""
    rng = np.random.RandomState(3)
    logits = (scale * rng.randn(2, 5, 4, 6)).astype(np.float32)
    if channels_last:
        logits = np.ascontiguousarray(logits.transpose(0, 2, 3, 1))
    labels = rng.randint(0, 5, (2, 4, 6)).astype(np.int32)
    labels[0, 0] = 9
    kw = dict(ignore_index=9, channels_last=channels_last, bounded=bounded)
    x = torch.from_numpy(logits).requires_grad_()
    got = crit.cross_entropy_ignore(x, torch.from_numpy(labels), **kw)
    got.backward()
    want, want_grad = jax.value_and_grad(
        lambda z: jcrit.cross_entropy_ignore(z, jnp.asarray(labels), **kw))(
        jnp.asarray(logits))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)
    assert np.isfinite(got.item())


def test_cross_entropy_with_every_pixel_ignored_is_zero():
    logits = torch.randn(1, 3, 2, 2)
    labels = torch.full((1, 2, 2), 7)
    assert crit.cross_entropy_ignore(logits, labels, 7, bounded=True).item() == 0.0
