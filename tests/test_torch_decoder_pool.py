"""The port's decoder-memory pooling and the two levers together
(zutis_tpu_torch/models/zutis.py `decoder_pool` and `tome_r`,
models/decoder.py `memory_bias`) against zutis_tpu/models/zutis.py and
decoder.py at tests/test_decoder_pool.py's tiny config, in f32, weights
carried across by params_from_jax:

  * ZUTIS with decoder_pool 2 (and 4), with tome_r, and with both, on the
    dense and the padded path, and QueryDecoder with a memory mask and a
    per-key memory_bias, at rtol 2e-4, atol 2e-5, on the kernel path's plain
    version and on the "torch" path;
  * decoder_pool=1 and tome_r=0 are the program without levers: the same
    state_dict keys for every setting (the levers add no parameter) and the
    same outputs bit for bit;
  * a pool that does not divide the grid is refused, naming the grid;
  * one training step with both levers gives the JAX step's loss and
    gradients (the port's step against `jax.value_and_grad`, as
    tests/test_torch_stop_gradient.py does).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train_step import CFG as STEP_CFG
from test_torch_train_step import LR, N_CAT, tiny_batch
from zutis_tpu.losses.criterion import criterion_loss as jcriterion_loss
from zutis_tpu.models.decoder import QueryDecoder as JQueryDecoder
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.engine.batched_eval import pad_batch
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.models import weights
from zutis_tpu_torch.models.decoder import QueryDecoder
from zutis_tpu_torch.models.weights import load_params, params_from_jax
from zutis_tpu_torch.models.zutis import ZUTIS

TOL = dict(rtol=2e-4, atol=2e-5)
CFG = dict(width=64, encoder_layers=3, encoder_heads=4, patch_size=16,
           text_dim=32, n_queries=8, n_decoder_layers=2, n_heads=4,
           input_resolution=32)
LEVERS = [(2, 0), (4, 0), (1, 4), (2, 4)]  # (decoder_pool, tome_r)


@pytest.fixture(scope="module")
def setup():
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    params = jax.jit(JZUTIS(**CFG).init)(jax.random.PRNGKey(0),
                                         jnp.asarray(x))["params"]
    return jax.tree.map(np.asarray, params), x


def _port(params, **kw):
    return load_params(ZUTIS(**CFG, **kw, device="cpu"), params).eval()


def _close(got, want):
    for key in ("mask_proposals", "patch_tokens"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("pool,tome_r", LEVERS, ids=str)
def test_dense_forward_matches_flax(setup, pool, tome_r, impl):
    params, x = setup
    jm = JZUTIS(**CFG, decoder_pool=pool, tome_r=tome_r)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params,
                                                            jnp.asarray(x))
    with torch.no_grad():
        got = _port(params, decoder_pool=pool, tome_r=tome_r,
                    attn_impl=impl)(torch.from_numpy(x))
    assert got["mask_proposals"].shape[-2:] == (8, 8)  # proposals stay dense
    _close(got, want)


@pytest.mark.parametrize("pool,tome_r", [(2, 0), (2, 6), (1, 6)], ids=str)
def test_padded_forward_matches_flax(setup, pool, tome_r):
    """A bucket of one full image, a partly filled one and a short one:
    pooled cells partly valid take the log(count) bias."""
    params, _ = setup
    rng = np.random.RandomState(1)
    imgs = [rng.randn(3, h, w).astype(np.float32)
            for h, w in [(64, 64), (48, 64), (33, 48)]]
    padded, grid, _ = pad_batch(imgs, (64, 64), 3, 16)
    jm = JZUTIS(**CFG, decoder_pool=pool, tome_r=tome_r)
    want = jax.jit(lambda p, x, g: jm.apply(
        {"params": p}, x, g, method=JZUTIS.forward_padded))(
        params, jnp.asarray(padded), jnp.asarray(grid))
    with torch.no_grad():
        got = _port(params, decoder_pool=pool, tome_r=tome_r).forward_padded(
            torch.from_numpy(padded), grid)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    _close(got, want)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_memory_bias_through_query_decoder(impl):
    """tests/test_decoder_pool.py's pooled decoder call: a memory mask
    (one item with no valid key) and a log(count) bias a key."""
    rng = np.random.RandomState(7)
    b, s, d = 3, 6, 32
    mem = rng.randn(b, s, d).astype(np.float32)
    pos = rng.randn(b, s, d).astype(np.float32)
    qp = rng.randn(b, 5, d).astype(np.float32)
    counts = rng.randint(0, 5, (b, s))
    counts[0, 0] = max(counts[0, 0], 1)
    counts[2] = 0
    mask = counts > 0
    bias = np.log(np.maximum(counts, 1))[:, None, None, :].astype(np.float32)
    tgt = np.zeros((b, 5, d), np.float32)
    jdec = JQueryDecoder(d_model=d, heads=4, num_layers=2)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(tgt),
                       jnp.asarray(mem))["params"]
    want = jdec.apply({"params": params}, jnp.asarray(tgt), jnp.asarray(mem),
                      pos=jnp.asarray(pos), query_pos=jnp.asarray(qp),
                      memory_mask=jnp.asarray(mask),
                      memory_bias=jnp.asarray(bias))
    sd = {}
    weights._put_decoder(sd, jax.tree.map(np.asarray, params))
    dec = QueryDecoder(d, heads=4, num_layers=2, attn_impl=impl, device="cpu")
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()},
                        strict=True)
    with torch.no_grad():
        got = dec(*map(torch.from_numpy, (tgt, mem, pos, qp)),
                  memory_mask=torch.from_numpy(mask),
                  memory_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_levers_off_are_the_program_without_levers(setup):
    params, x = setup
    plain = _port(params)
    off = _port(params, decoder_pool=1, tome_r=0)
    keys = list(plain.state_dict())
    for kw in (dict(decoder_pool=2), dict(tome_r=4),
               dict(decoder_pool=4, tome_r=16)):
        assert list(ZUTIS(**CFG, **kw, device="meta").state_dict()) == keys
    rng = np.random.RandomState(3)
    imgs = [rng.randn(3, h, w).astype(np.float32)
            for h, w in [(64, 64), (48, 32)]]
    padded, grid, _ = pad_batch(imgs, (64, 64), 2, 16)
    with torch.no_grad():
        for a, b in ((plain(torch.from_numpy(x)), off(torch.from_numpy(x))),
                     (plain.forward_padded(torch.from_numpy(padded), grid),
                      off.forward_padded(torch.from_numpy(padded), grid))):
            for key in ("mask_proposals", "patch_tokens"):
                assert torch.equal(a[key], b[key]), key


def test_a_pool_that_does_not_divide_the_grid_is_refused(setup):
    params, x = setup
    with torch.no_grad():
        with pytest.raises(ValueError, match="must divide .* 8x8"):
            _port(params, decoder_pool=3)(torch.from_numpy(x))
        padded, grid, _ = pad_batch([x[0][:, :, :48]], (64, 48), 1, 16)
        with pytest.raises(ValueError, match="must divide the bucket .* 8x6"):
            _port(params, decoder_pool=4).forward_padded(
                torch.from_numpy(padded), grid)
    with pytest.raises(ValueError, match="decoder_pool must be >= 1"):
        ZUTIS(**CFG, decoder_pool=0, device="meta")


def test_train_step_with_both_levers_matches_jax():
    """tests/test_train_step.py's tiny step (2 x 2 tokens, x2 upsampled to
    4 x 4) with tome_r=2 and decoder_pool=2: the loss and every gradient,
    the encoder's included (the text-space loss reaches it through the
    merged stream)."""
    batch, text = tiny_batch()
    levers = dict(tome_r=2, decoder_pool=2)
    jmodel = JZUTIS(**STEP_CFG, **levers)
    params = jax.tree.map(np.asarray, jax.jit(JZUTIS(**STEP_CFG).init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["image"]))["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jbatch["image"])
        return jcriterion_loss(
            out["mask_proposals"], jbatch["instance_masks"],
            jbatch["instance_valid"], out["patch_tokens"],
            jbatch["semantic_mask"], jnp.asarray(text))["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    model = load_params(ZUTIS(**STEP_CFG, **levers, device="cpu"), params)
    state = TrainState.create(model, base_lr=LR, n_iters=1000)
    got = make_train_step(model, text, N_CAT, device="cpu")(state, batch)
    np.testing.assert_allclose(got["loss"].item(), float(jloss), **TOL)
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(g, want, err_msg=name, **TOL)
    w = jgrads["encoder.transformer.resblocks.0.attn.in_proj_weight"].numpy()
    assert np.abs(w).max() > 0


def test_instance_eval_bench_takes_the_levers(monkeypatch):
    from zutis_tpu_torch.tools import instance_eval_bench as bench

    rec = bench.run(batch=2, iters=1, device="cpu", cfg=CFG, shape=(64, 64),
                    n_categories=5, windows=1, threshold=0.4, tome_r=4,
                    decoder_pool=2)
    assert (rec["tome_r"], rec["decoder_pool"]) == (4, 2) and rec["value"] > 0
    seen = {}
    monkeypatch.setattr(bench, "run", lambda *a, **kw: seen.update(kw))
    bench.main(["--tome_r", "90", "--decoder_pool", "2", "--device", "cpu"])
    assert (seen["tome_r"], seen["decoder_pool"]) == (90, 2)
