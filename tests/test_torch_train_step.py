"""The port's training slice against the JAX package at the tiny setup of
tests/test_train_step.py (width 32, one encoder layer, 8 queries, two
decoder layers, 32 px images), in f32, weights carried across with
params_from_jax:

  * engine/metrics.py: confusion_update equal to JAX's, RunningScore's
    scores equal;
  * engine/optim.py: given identical gradients, AdamW + PolyLR leave the
    parameters equal to optax's chain to 1e-6 of each tensor's largest
    |value| (1e-5 for tensors that start at zero: optax's f32 bias
    correction), both groups, with the schedule's floor reached;
  * engine/train_step.py: one step gives JAX's loss (rtol 1e-4) and its
    gradients (within 2e-4 of each tensor's largest |gradient|), and
    updated parameters equal where the gradient is not at rounding level
    (Adam's first step is sign-like); the loss falls over steps; the
    confusion accumulator threads;
  * engine/batched_eval.py: the "confusion" semantic mode and
    make_semantic_confusion_step equal the JAX steps' histograms.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from zutis_tpu.engine import batched_eval as JBE
from zutis_tpu.engine import metrics as jmetrics
from zutis_tpu.engine.optim import make_optimizer as jmake_optimizer
from zutis_tpu.engine.optim import poly_lr_schedule as jpoly_lr_schedule
from zutis_tpu.engine.train_step import TrainState as JTrainState
from zutis_tpu.engine.train_step import make_eval_step as jmake_eval_step
from zutis_tpu.engine.train_step import make_train_step as jmake_train_step
from zutis_tpu.losses.criterion import criterion_loss as jcriterion_loss
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.engine import batched_eval as BE
from zutis_tpu_torch.engine import metrics
from zutis_tpu_torch.engine.optim import make_optimizer, poly_lr_schedule
from zutis_tpu_torch.engine.train_step import (
    TrainState,
    make_eval_step,
    make_train_step,
)
from zutis_tpu_torch.models.weights import load_params, params_from_jax
from zutis_tpu_torch.models.zutis import ZUTIS

CFG = dict(width=32, encoder_layers=1, encoder_heads=2, patch_size=16,
           text_dim=16, n_queries=8, n_decoder_layers=2, n_heads=2,
           input_resolution=32)
N_CAT = 4
LR = 1e-3


def tiny_batch(seed=0):
    """tests/test_train_step.py's batch: two square instances an image."""
    rng = np.random.RandomState(seed)
    b, H, n_max = 2, 32, 3
    image = rng.randn(b, 3, H, H).astype(np.float32)
    inst = np.zeros((b, n_max, H, H), np.float32)
    valid = np.zeros((b, n_max), bool)
    sem = np.zeros((b, H, H), np.int32)
    for i in range(b):
        inst[i, 0, 4:20, 4:20] = 1
        inst[i, 1, 22:30, 22:30] = 1
        valid[i, :2] = True
        sem[i][inst[i, 0] > 0] = 1
        sem[i][inst[i, 1] > 0] = 2
    text = rng.randn(N_CAT, 16).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    batch = {"image": image, "instance_masks": inst, "instance_valid": valid,
             "semantic_mask": sem}
    return batch, text


@pytest.fixture(scope="module")
def setup():
    batch, text = tiny_batch()
    jmodel = JZUTIS(**CFG)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batch["image"]))["params"]
    return jmodel, jax.tree.map(np.asarray, params), batch, text


def _port(params):
    return load_params(ZUTIS(**CFG, device="cpu"), params)


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def one_step(setup):
    """JAX's loss, gradients and updated parameters of one step, and the
    port's model after the same step with its metrics."""
    jmodel, params, batch, text = setup
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jbatch["image"])
        return jcriterion_loss(
            out["mask_proposals"], jbatch["instance_masks"],
            jbatch["instance_valid"], out["patch_tokens"],
            jbatch["semantic_mask"], jnp.asarray(text))["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jmake_optimizer(base_lr=LR, n_iters=1000)
    jstate, jm = jmake_train_step(jmodel, tx, jnp.asarray(text), N_CAT)(
        JTrainState.create(jax.tree.map(jnp.array, params), tx), jbatch)
    model = _port(params)
    state = TrainState.create(model, base_lr=LR, n_iters=1000)
    got = make_train_step(model, text, N_CAT, device="cpu")(state, batch)
    return dict(jloss=float(jloss), jgrads=params_from_jax(
        jax.tree.map(np.asarray, jgrads)), jparams=params_from_jax(
        jax.tree.map(np.asarray, jstate.params)), jmetrics=jm,
        model=model, state=state, metrics=got)


def test_one_step_loss_matches_jax(one_step):
    got = one_step["metrics"]
    np.testing.assert_allclose(got["loss"].item(), one_step["jloss"], rtol=1e-4)
    for key in ("loss", "ce_loss", "mask_loss"):
        np.testing.assert_allclose(got[key].item(),
                                   float(one_step["jmetrics"][key]), rtol=1e-4)
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  np.asarray(one_step["jmetrics"]["confusion"]))
    assert one_step["state"].step == 1


def test_one_step_gradients_match_jax(one_step):
    zero = []
    for name, p in one_step["model"].named_parameters():
        want = one_step["jgrads"][name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        err = _rel_err(got, want)
        assert err <= 2e-4, f"{name}: {err:.3e} of the largest |gradient|"
        if not np.abs(want).max():
            zero.append(name)
    # decoder layer 0's self-attention sees tgt = 0: its weights get no
    # gradient on either side (v = 0, and a softmax of rows summing to 1)
    assert zero == ["decoder.layers.0.self_attn.in_proj_weight",
                    "decoder.layers.0.self_attn.out_proj.weight",
                    "decoder.layers.0.norm1.weight"]


def test_one_step_updated_params_match_jax(one_step):
    for name, p in one_step["model"].named_parameters():
        g = one_step["jgrads"][name].numpy()
        sure = np.abs(g) > 1e-4 * max(np.abs(g).max(), 1e-30)
        got = p.detach().numpy()[sure]
        want = one_step["jparams"][name].numpy()[sure]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_loss_decreases():
    batch, text = tiny_batch()
    model = ZUTIS(**CFG, device="cpu").init_params(torch.Generator().manual_seed(0))
    state = TrainState.create(model, base_lr=LR, n_iters=1000)
    step = make_train_step(model, text, N_CAT, device="cpu")
    losses = [step(state, batch)["loss"].item() for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    assert state.step == 12


def test_confusion_acc_threading_matches_sum(setup):
    _, params, batch, text = setup
    runs = {}
    for threaded in (False, True):
        model = _port(params)
        state = TrainState.create(model, base_lr=LR, n_iters=1000)
        step = make_train_step(model, text, N_CAT, device="cpu")
        total = torch.zeros(N_CAT, N_CAT)
        losses = []
        for _ in range(3):
            m = step(state, batch, total if threaded else None)
            total = m["confusion"] if threaded else total + m["confusion"]
            losses.append(m["loss"].item())
        runs[threaded] = (total, losses, model.state_dict())
    torch.testing.assert_close(runs[True][0], runs[False][0], rtol=0, atol=0)
    assert runs[True][1] == runs[False][1]
    assert runs[True][0].sum().item() == 3 * 2 * 32 * 32
    for key, value in runs[True][2].items():
        torch.testing.assert_close(value, runs[False][2][key], rtol=0, atol=0)


def test_train_step_refuses_a_model_on_another_device(setup):
    _, params, _, text = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(_port(params), text, N_CAT)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_eval_step(_port(params), text)


def test_eval_step_matches_jax(setup):
    jmodel, params, batch, text = setup
    jout, jlogits = jmake_eval_step(jmodel, jnp.asarray(text))(
        params, jnp.asarray(batch["image"]))
    out, logits = make_eval_step(_port(params), text, device="cpu")(batch["image"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-5)


# ----------------------------------------------------------------- optimiser


def test_poly_lr_schedule_matches_jax():
    for n_iters in (1, 7, 100):
        ours, theirs = poly_lr_schedule(5e-5, n_iters), jpoly_lr_schedule(5e-5, n_iters)
        for s in range(0, n_iters + 3):
            np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-6)
    assert poly_lr_schedule(5e-5, 10)(10) == 1e-6


def test_optimizer_groups():
    model = ZUTIS(**CFG, device="cpu")
    optimizer, scheduler = make_optimizer(model, base_lr=2e-4)
    enc, rest = optimizer.param_groups
    names = {id(p): n for n, p in model.named_parameters()}
    assert all(names[id(p)].startswith("encoder.") for p in enc["params"])
    assert not any(names[id(p)].startswith("encoder.") for p in rest["params"])
    assert len(enc["params"]) + len(rest["params"]) == len(names)
    assert enc["lr"] == pytest.approx(2e-5) and rest["lr"] == pytest.approx(2e-4)
    assert enc["weight_decay"] == rest["weight_decay"] == 0.05


def test_adamw_polylr_equal_optax_given_identical_gradients(setup):
    """Five steps of a schedule that reaches its floor at the third (power
    20 over 5 iterations: lr 1e-3, 1.2e-5, then 1e-6, and a tenth of each
    for the encoder). The steps stop short of n_iters: there the JAX
    package's jitted schedule computes 0.0 ** 0.9 as NaN."""
    _, params, _, _ = setup
    rng = np.random.RandomState(4)
    grads = [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32) * 0.01,
                          params) for _ in range(5)]
    kw = dict(base_lr=LR, n_iters=5, power=20.0)
    tx = jmake_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    schedule = jpoly_lr_schedule(LR, 5, 20.0)
    model = _port(params)
    optimizer, scheduler = make_optimizer(model, **kw)
    by_name = dict(model.named_parameters())
    for step, g in enumerate(grads):
        updates, opt_state = update(jax.tree.map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_lr = float(schedule(step))
        assert [group["lr"] for group in optimizer.param_groups] == pytest.approx(
            [0.1 * want_lr, want_lr], rel=1e-6)
        for name, tg in params_from_jax(g).items():
            by_name[name].grad = tg
        optimizer.step()
        scheduler.step()
    assert want_lr == pytest.approx(1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    start = params_from_jax(params)
    for name, p in model.named_parameters():
        err = _rel_err(p.detach().numpy(), want[name].numpy())
        # a tensor that starts at zero is made of the updates alone, and
        # optax's f32 bias correction 1 - 0.999^t is 1.3e-5 off at t = 1
        # (torch's is float64), which moves its first update by 6.4e-6
        tol = 1e-5 if not start[name].abs().max() else 1e-6
        assert err <= tol, f"{name}: {err:.3e} of the largest |value|"


# ------------------------------------------------------------------- metrics


@pytest.mark.parametrize("n_classes", [1, 4, 919])
def test_confusion_update_matches_jax(n_classes):
    rng = np.random.RandomState(n_classes)
    gt = rng.randint(-2, n_classes + 3, (3, 17, 11)).astype(np.int32)
    pred = rng.randint(0, n_classes, (3, 17, 11)).astype(np.int32)
    got = metrics.confusion_update(torch.from_numpy(gt), torch.from_numpy(pred),
                                   n_classes)
    want = jmetrics.confusion_update(jnp.asarray(gt), jnp.asarray(pred), n_classes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_running_score_matches_jax():
    rng = np.random.RandomState(5)
    ours, theirs = metrics.RunningScore(6), jmetrics.RunningScore(6)
    for _ in range(3):
        gt = rng.randint(-1, 7, (2, 9, 9))
        pred = rng.randint(0, 6, (2, 9, 9))
        pred[gt == 2] = 2  # a class that scores well
        ours.update(gt, pred)
        theirs.update(gt, pred)
    got, got_cls = ours.get_scores()
    want, want_cls = theirs.get_scores()
    assert got == pytest.approx(want, rel=1e-12, nan_ok=True)
    assert got_cls == pytest.approx(want_cls, rel=1e-12, nan_ok=True)
    ours.reset()
    assert ours.confusion_matrix.sum() == 0


def test_average_meter_and_iou_match_jax():
    a, b = metrics.AverageMeter(), jmetrics.AverageMeter()
    for val, n in ((1.5, 2), (3.0, 1), (0.25, 5)):
        a.update(val, n)
        b.update(val, n)
    assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)
    rng = np.random.RandomState(6)
    pred, gt = rng.rand(8, 8), rng.rand(8, 8) > 0.5
    for threshold in (0.5, 0.2, None):
        assert metrics.compute_iou(pred, gt, threshold) == jmetrics.compute_iou(
            pred, gt, threshold)
    assert metrics.compute_iou(np.zeros((2, 2)), np.zeros((2, 2))) == 0.0


# ------------------------------------------------- batched eval, "confusion"

EVAL_CFG = dict(width=32, encoder_layers=2, encoder_heads=2, patch_size=16,
                text_dim=16, n_queries=8, n_decoder_layers=2, n_heads=2,
                input_resolution=32)
SIZES, BUCKET, N_CLASSES = [(48, 48), (32, 48), (37, 33)], (48, 48), 5


@pytest.fixture(scope="module")
def eval_setup():
    jmodel = JZUTIS(**EVAL_CFG)
    rng = np.random.RandomState(0)
    imgs = [rng.randn(3, h, w).astype(np.float32) for h, w in SIZES]
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(imgs[0][None]))["params"])
    text = rng.randn(N_CLASSES, 16).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    model = load_params(ZUTIS(**EVAL_CFG, device="cpu"), params)
    padded, grid, pix = BE.pad_batch(imgs, BUCKET, len(imgs), 16)
    gt = np.full((len(imgs),) + BUCKET, -1, np.int32)
    for i, (h, w) in enumerate(SIZES):
        gt[i, :h, :w] = rng.randint(0, N_CLASSES, (h, w))
    return jmodel, params, model, text, (padded, grid, pix), gt


def test_instance_step_confusion_matches_jax(eval_setup):
    jmodel, params, model, text, inputs, gt = eval_setup
    want = JBE.make_instance_step(jmodel, jnp.asarray(text), BUCKET,
                                  threshold=0.4, semantic_mode="confusion",
                                  n_classes=N_CLASSES)(
        params, *map(jnp.asarray, inputs), jnp.asarray(gt))
    got = BE.make_instance_step(model, text, BUCKET, threshold=0.4,
                                semantic_mode="confusion", n_classes=N_CLASSES,
                                device="cpu")(*inputs, gt)
    assert "semantic" not in got
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  np.asarray(want["confusion"]))
    assert got["confusion"].sum().item() == sum(h * w for h, w in SIZES)
    np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))


def test_semantic_confusion_step_matches_jax(eval_setup):
    jmodel, params, model, text, inputs, gt = eval_setup
    want = JBE.make_semantic_confusion_step(jmodel, jnp.asarray(text), BUCKET,
                                            N_CLASSES)(
        params, *map(jnp.asarray, inputs), jnp.asarray(gt))
    got = BE.make_semantic_confusion_step(model, text, BUCKET, N_CLASSES,
                                          device="cpu")(*inputs, gt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
