"""The port's `stop_gradient` against the JAX package's
(zutis_tpu/models/zutis.py:221-224, :350-353), at tests/test_train_step.py's
tiny setup in f32 with weights carried across by params_from_jax:

  * stop_gradient=False: one training step gives the JAX step's loss and
    every gradient, the encoder's included (rtol 2e-4, atol 2e-5);
  * stop_gradient=True: the mask loss alone leaves every encoder `.grad`
    at None, on the dense and the padded path; with False it reaches the
    encoder through ffn1;
  * `build_zutis` and both branches of the CLI's `build_model` pass the
    flag on.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_step import CFG, LR, N_CAT, tiny_batch
from zutis_tpu.losses.criterion import criterion_loss as jcriterion_loss
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.cli import main as port_main
from zutis_tpu_torch.core.config import Config
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.losses.criterion import criterion_loss
from zutis_tpu_torch.models import factory
from zutis_tpu_torch.models.weights import load_params, params_from_jax
from zutis_tpu_torch.models.zutis import ZUTIS

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def setup():
    batch, text = tiny_batch()
    params = jax.jit(JZUTIS(**CFG).init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["image"]))["params"]
    return jax.tree.map(np.asarray, params), batch, text


def test_step_without_stop_gradient_matches_jax(setup):
    params, batch, text = setup
    jmodel = JZUTIS(stop_gradient=False, **CFG)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jbatch["image"])
        return jcriterion_loss(
            out["mask_proposals"], jbatch["instance_masks"],
            jbatch["instance_valid"], out["patch_tokens"],
            jbatch["semantic_mask"], jnp.asarray(text))["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    model = load_params(ZUTIS(**CFG, stop_gradient=False, device="cpu"),
                        params)
    state = TrainState.create(model, base_lr=LR, n_iters=1000)
    got = make_train_step(model, text, N_CAT, device="cpu")(state, batch)
    np.testing.assert_allclose(got["loss"].item(), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # the mask loss reaches the encoder's early blocks only this way
    w = jgrads["encoder.transformer.resblocks.0.mlp.c_fc.weight"].numpy()
    assert np.abs(w).max() > 0


def _mask_loss_encoder_grads(params, batch, text, stop_gradient, padded):
    model = load_params(ZUTIS(**CFG, stop_gradient=stop_gradient,
                              device="cpu"), params)
    image = torch.from_numpy(batch["image"])
    if padded:
        out = model.forward_padded(image, [[2, 2], [2, 1]], inference=False)
    else:
        out = model(image)
    losses = criterion_loss(
        out["mask_proposals"], torch.from_numpy(batch["instance_masks"]),
        torch.from_numpy(batch["instance_valid"]), out["patch_tokens"],
        torch.from_numpy(batch["semantic_mask"]), torch.from_numpy(text))
    losses["mask_loss"].backward()
    return {n: p.grad for n, p in model.encoder.named_parameters()}


@pytest.mark.parametrize("padded", [False, True], ids=["dense", "padded"])
def test_stop_gradient_keeps_the_mask_loss_out_of_the_encoder(setup, padded):
    params, batch, text = setup
    stopped = _mask_loss_encoder_grads(params, batch, text, True, padded)
    assert all(g is None for g in stopped.values()), [
        n for n, g in stopped.items() if g is not None]
    flowing = _mask_loss_encoder_grads(params, batch, text, False, padded)
    assert flowing["conv1.weight"] is not None
    assert flowing["conv1.weight"].abs().max() > 0


def test_build_zutis_passes_stop_gradient():
    for flag in (True, False):
        model = factory.build_zutis("ViT-B/32", n_queries=2,
                                    n_decoder_layers=1, stop_gradient=flag,
                                    device="cpu")
        assert model.stop_gradient is flag


@pytest.mark.parametrize("model_kwargs", [CFG, None],
                         ids=["model_kwargs", "clip_arch"])
def test_cli_build_model_passes_stop_gradient(tmp_path, model_kwargs):
    for flag in (True, False):
        fp = tmp_path / f"cfg_{flag}.yaml"
        lines = ["clip_arch: ViT-B/32", f"stop_gradient: {str(flag).lower()}",
                 "categories: [background, cat]"]
        if model_kwargs:
            lines.append("model_kwargs: {" + ", ".join(
                f"{k}: {v}" for k, v in model_kwargs.items()) + "}")
        fp.write_text("\n".join(lines) + "\n")
        cfg = Config.load(str(fp))
        assert cfg.stop_gradient is flag
        model = port_main.build_model(cfg, "cpu", init=False)
        assert model.stop_gradient is flag
