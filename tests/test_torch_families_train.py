"""Training and evaluation of the port's RN and DINO ZUTIS against the JAX
package (zutis_tpu/engine/train_step.py, engine/optim.py,
engine/trainer.py), in f32 at the tiny configurations of
tests/test_trainer_batched_eval.py:

  * RN train steps: each step's loss (rtol 1e-4) and every parameter's
    gradient (within 2e-4 of its largest |gradient|; the two whose gradient
    is zero but for rounding, ROUNDING_ONLY, within 2e-4 of a neighbour's
    largest) equal to JAX's, the parameters after the first step equal to optax's chain's
    where the gradient is not at rounding level (Adam's first step is
    sign-like; later steps start from states that rounding has already
    moved apart); the frozen BatchNorm statistics bit-unchanged after every
    step on both sides (buffers here, the masked leaves of
    `_zero_frozen_stats` there) while BatchNorm's weight and bias move;
  * `Trainer.evaluate` on RN and DINO models: batches of one exact shape
    (`batch_images` 3) equal to the per-image regime, and both equal to
    the JAX Trainer's scores (semantic sets of mixed shapes; a coco2017
    set with its instance predictions and COCO metrics for RN).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from zutis_tpu.engine.optim import make_optimizer as jmake_optimizer
from zutis_tpu.engine.train_step import TrainState as JTrainState
from zutis_tpu.engine.train_step import make_train_step as jmake_train_step
from zutis_tpu.engine.trainer import Trainer as JTrainer
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.engine.trainer import Trainer
from zutis_tpu_torch.models.weights import params_from_jax, params_to_jax
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.ops import rle

N_CAT = 4
LR = 1e-3
STEPS = 3
# tests/test_trainer_batched_eval.py's RN, and a DINO arm of its size
CFGS = {
    "rn": dict(encoder_family="rn", rn_layers=(1, 1, 1, 1), rn_width=8,
               width=256, text_dim=16, input_resolution=64, n_queries=6,
               n_decoder_layers=1, n_heads=2),
    "dino": dict(encoder_family="dino", width=16, text_dim=16, patch_size=16,
                 input_resolution=32, dino_embed_dim=32, dino_depth=1,
                 dino_heads=2, n_queries=6, n_decoder_layers=1, n_heads=2),
}
STATS = ("running_mean", "running_var")
# gradients that are zero but for rounding, and the tensor whose largest
# |gradient| sets their scale: attnpool's key bias shifts every logit of a
# query alike, which the softmax ignores; decoder layer 0's self-attention
# sees tgt = 0, so its values are all its value bias whatever the weights
# (the ViT test's step 0 finds these weights' gradients exactly zero; after
# a step moved the biases they are rounding)
ROUNDING_ONLY = {
    "encoder.attnpool.k_proj.bias": "encoder.attnpool.k_proj.weight",
    "decoder.layers.0.self_attn.in_proj_weight":
        "decoder.layers.0.self_attn.in_proj_bias"}


def seeded(name, seed=2):
    """The port's model with seeded parameters and BatchNorm statistics off
    the identity, and the same parameters as a flax tree."""
    model = ZUTIS(**CFGS[name], device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, v in model.state_dict().items():
            if key.endswith("running_var"):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, v.shape)))
            elif key.endswith("running_mean"):
                v.copy_(torch.from_numpy(0.2 * rng.normal(size=v.shape)))
    return model, params_to_jax(model.state_dict())


def text_embeddings(seed=3):
    text = np.random.RandomState(seed).randn(N_CAT, 16).astype(np.float32)
    return text / np.linalg.norm(text, axis=1, keepdims=True)


def train_batch(seed, b=2, size=64):
    rng = np.random.RandomState(seed)
    inst = np.zeros((b, 3, size, size), np.float32)
    valid = np.zeros((b, 3), bool)
    sem = np.zeros((b, size, size), np.int32)
    for i in range(b):
        inst[i, 0, 4:30, 6:40] = 1
        inst[i, 1, 36:60, 30:58] = 1
        valid[i, :2] = True
        sem[i][inst[i, 0] > 0] = 1
        sem[i][inst[i, 1] > 0] = 2
    return {"image": rng.randn(b, 3, size, size).astype(np.float32),
            "instance_masks": inst, "instance_valid": valid,
            "semantic_mask": sem}


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _keep_gradients() -> optax.GradientTransformation:
    """A transformation that passes the gradients on unchanged and keeps
    them as its state, so that a JAX train step reports them."""
    return optax.GradientTransformation(
        lambda params: {"grads": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"grads": updates}))


@pytest.fixture(scope="module")
def rn_steps():
    """STEPS training steps of the RN model on both sides: per step the
    port's metrics, gradients and parameters, and the JAX train step's
    loss, gradients and parameters after it (its optimiser is the JAX
    package's chain behind a transformation that keeps the gradients)."""
    model, params = seeded("rn")
    jm = JZUTIS(**CFGS["rn"])
    text = text_embeddings()
    tx = optax.chain(_keep_gradients(), jmake_optimizer(base_lr=LR, n_iters=100))
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, params), tx)
    jstep = jmake_train_step(jm, tx, jnp.asarray(text), N_CAT)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState.create(model, base_lr=LR, n_iters=100)
    step = make_train_step(model, text, N_CAT, device="cpu")
    records = []
    for t in range(STEPS):
        batch = train_batch(t)
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        jgrads = jstate.opt_state[0]["grads"]
        got = step(state, batch)
        records.append(dict(
            loss=got["loss"].item(), jloss=float(jmetrics["loss"]),
            grads={n: p.grad.numpy().copy() for n, p in
                   model.named_parameters() if p.grad is not None},
            jgrads=params_from_jax(jax.tree.map(np.asarray, jgrads)),
            params={k: v.clone() for k, v in model.state_dict().items()},
            jparams=params_from_jax(jax.tree.map(np.asarray, jstate.params))))
    return dict(model=model, start=start, records=records)


@pytest.mark.parametrize("t", range(STEPS))
def test_rn_step_loss_matches_jax(rn_steps, t):
    r = rn_steps["records"][t]
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-4)


@pytest.mark.parametrize("t", range(STEPS))
def test_rn_step_gradients_match_jax(rn_steps, t):
    r = rn_steps["records"][t]
    model = rn_steps["model"]
    names = [n for n, _ in model.named_parameters()]
    assert any("bn" in n for n in names)
    for name in names:
        want = r["jgrads"][name].numpy()
        got = r["grads"].get(name, np.zeros_like(want))
        if name in ROUNDING_ONLY:
            scale = np.abs(r["jgrads"][ROUNDING_ONLY[name]].numpy()).max()
            err = np.abs(got - want).max() / scale
        else:
            err = _rel_err(got, want)
        assert err <= 2e-4, f"step {t} {name}: {err:.3e} of the largest |gradient|"


@pytest.mark.parametrize("t", range(STEPS))
def test_rn_step_leaves_the_statistics_as_optax_does(rn_steps, t):
    r = rn_steps["records"][t]
    for name in [k for k in r["params"] if k.endswith(STATS)]:
        np.testing.assert_array_equal(r["params"][name].numpy(),
                                      r["jparams"][name].numpy(), err_msg=name)
        np.testing.assert_array_equal(r["params"][name].numpy(),
                                      rn_steps["start"][name].numpy())


def test_rn_first_step_parameters_match_optax(rn_steps):
    """Where the step's gradient is above rounding level, the port's
    parameters after it equal optax's chain's (AdamW's first step moves
    each parameter by about lr whatever the gradient's size, so a gradient
    at rounding level may move it either way)."""
    r = rn_steps["records"][0]
    for name, got in r["params"].items():
        want = r["jparams"][name].numpy()
        if name.endswith(STATS):
            continue
        g = r["jgrads"][name].numpy()
        live = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-30)
        np.testing.assert_allclose(got.numpy()[live], want[live], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_rn_frozen_statistics_stay_while_batchnorm_affine_moves(rn_steps):
    model, start = rn_steps["model"], rn_steps["start"]
    stats = [k for k in start if k.endswith(STATS)]
    affine = [k for k in start if (".bn" in k or "downsample.1." in k)
              and k.endswith(("weight", "bias"))]
    assert stats and affine
    now = model.state_dict()
    for k in stats:
        assert torch.equal(now[k], start[k]), k
        assert not any(k == n for n, _ in model.named_parameters())
    moved = [k for k in affine if not torch.equal(now[k], start[k])]
    assert len(moved) == len(affine)


# ------------------------------------------------------------ evaluation

class SemanticSet:
    """Mixed shapes, repeated, as tests/test_trainer_batched_eval.py's."""

    def __init__(self, name, sizes, seed=4):
        self.name, self.n_categories = name, N_CAT
        rng = np.random.RandomState(seed)
        self.samples = [{"image": rng.randn(3, h, w).astype(np.float32),
                         "semantic_mask": rng.randint(0, N_CAT, (h, w)).astype(
                             np.int32)} for h, w in sizes]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class CocoSet(SemanticSet):
    """A coco2017 set with box-like instance annotations."""

    def __init__(self, root, sizes, seed=5):
        super().__init__("coco2017", sizes, seed)
        images, anns = [], []
        for i, s in enumerate(self.samples):
            h, w = s["image"].shape[-2:]
            m = np.zeros((h, w), np.uint8)
            m[5:40, 8:50] = 1
            s["semantic_mask"] = m.astype(np.int32) * (1 + i % 2)
            s["image_id"] = i + 1
            images.append({"id": i + 1, "height": h, "width": w})
            anns.append({"id": i + 1, "image_id": i + 1,
                         "category_id": 1 + i % 2, "iscrowd": 0,
                         "segmentation": rle.encode(m), "area": int(m.sum())})
        self.p_annotations = os.path.join(root, "instances_val2017.json")
        with open(self.p_annotations, "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 1}, {"id": 2}]}, f)


SIZES = {"rn": [(64, 64), (64, 96), (64, 64), (64, 96), (64, 64)],
         "dino": [(64, 64), (48, 80), (64, 64), (48, 80), (64, 64)]}


def _evaluate_both(name, dataset, dir_ckpt=None):
    """{batch_images: the port's scores} and the JAX Trainer's per-image
    scores."""
    model, params = seeded(name, seed=6)
    text = text_embeddings(7)
    got = {}
    for b in (3, 1):
        d = None if dir_ckpt is None else os.path.join(dir_ckpt, f"port{b}")
        if d:
            os.makedirs(d)
        got[b] = (Trainer(model, text, dir_ckpt=d, device="cpu").evaluate(
            None, dataset, num_iter=1, batch_images=b), d)
    d = None if dir_ckpt is None else os.path.join(dir_ckpt, "jax")
    if d:
        os.makedirs(d)
    jtrainer = JTrainer(JZUTIS(**CFGS[name]), jnp.asarray(text), dir_ckpt=d)
    want = jtrainer.evaluate(jax.tree.map(jnp.asarray, params), dataset,
                             num_iter=1, batch_images=1)
    return got, (want, d)


def _scores_equal(got, want):
    assert set(got) == set(want)
    for key in got:
        if key != "eval_images_per_sec":
            assert got[key] == want[key] or (np.isnan(got[key])
                                             and np.isnan(want[key])), key


@pytest.mark.parametrize("name", ["rn", "dino"])
def test_exact_batched_evaluation_equals_per_image_and_jax(name):
    got, (want, _) = _evaluate_both(name, SemanticSet("coca", SIZES[name]))
    _scores_equal(got[3][0], got[1][0])
    _scores_equal(got[1][0], want)


def test_rn_coco_evaluation_equals_per_image_and_jax(tmp_path):
    ds = CocoSet(str(tmp_path), SIZES["rn"])
    got, (want, jdir) = _evaluate_both("rn", ds, str(tmp_path))
    _scores_equal(got[3][0], got[1][0])
    _scores_equal(got[1][0], want)

    def predictions(d):
        with open(os.path.join(d, "instance_predictions_00001.json")) as f:
            preds = json.load(f)
        return sorted(preds, key=lambda p: (p["image_id"], -p["score"]))

    def coco(d):
        with open(os.path.join(d, "eval_coco_style_metrics.json")) as f:
            return json.load(f)

    by = {b: predictions(d) for b, (_, d) in got.items()}
    jpreds = predictions(jdir)
    assert by[3] == by[1]
    assert len(by[1]) == len(jpreds)
    for p, q in zip(by[1], jpreds):
        assert (p["image_id"], p["category_id"], p["segmentation"]) == (
            q["image_id"], q["category_id"], q["segmentation"])
        np.testing.assert_allclose(p["score"], q["score"], rtol=1e-5)
    assert coco(got[3][1]) == coco(got[1][1])
