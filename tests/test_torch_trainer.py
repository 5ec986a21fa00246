"""The port's Trainer (zutis_tpu_torch/engine/trainer.py) against the JAX
Trainer at the tiny setup of tests/test_checkpoint_resume.py (width 32,
one encoder layer, six queries, two decoder layers, 32 px batches of two),
in f32, from the same parameters (params_from_jax) and the same batch
stream, with a two-image coco2017 validation set written to a temporary
directory:

  * fit, 3 iterations, iter_log 1, iter_eval 3: the same artifact files;
    training_metrics.json's losses at rtol 1e-4 (the single step's
    tolerance, tests/test_torch_train_step.py), its mIoU, pixel accuracy
    and per-class IoUs equal; eval_metrics.json, the instance predictions
    and the COCO stats equal; final_model.npz with the JAX keys, within
    the update tolerance of tests/test_torch_train_step.py (rtol 1e-5,
    atol 1e-6) where the two sides' gradients agree to 1e-3 of themselves
    at every step (Adam turns a gradient's relative difference into an
    update difference of lr times it);
  * evaluate, per image and bucketed: the JAX scores, instance
    predictions and COCO stats;
  * port against port: killed at step 2 and resumed from its checkpoint,
    bit-exact against the straight run; artifacts fresh on a new run and
    appended on a resumed one; a NaN batch raises NonFiniteError naming
    step 1; the bucketed eval equals the per-image one on mixed
    resolutions and ImageNet-S's original sizes;
  * the figures: fit with visualise=True and with debug=True writes the
    JAX Trainer's file names at its iterations, and `_visualise_train`
    hands its figures the JAX one's arrays (semantic argmax, proposals,
    matched assignment) on the same parameters.

The ffn1 output layer is scaled by 8 on both sides, so that the random
model's proposals cross the 0.5 threshold and the instance path has masks.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.engine.optim import make_optimizer as jmake_optimizer
from zutis_tpu.engine.trainer import Trainer as JTrainer
from zutis_tpu.engine.train_step import TrainState as JTrainState
from zutis_tpu.engine.train_step import make_train_step as jmake_train_step
from zutis_tpu.losses.criterion import criterion_loss as jcriterion_loss
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.core.checkpoint import latest_step_dir, restore_train_state
from zutis_tpu_torch.core.profiling import TRACE_FILE, NonFiniteError
from zutis_tpu_torch.data.image_io import read_png
from zutis_tpu_torch.engine.trainer import Trainer
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.models.weights import load_params, params_from_jax
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.ops import rle

CFG = dict(width=32, encoder_layers=1, encoder_heads=2, patch_size=16,
           text_dim=16, n_queries=6, n_decoder_layers=2, n_heads=2,
           input_resolution=32)
N_CAT, H, LR, N_ITERS = 3, 32, 1e-3, 3
ARTIFACTS = ["best_model.npz", "eval_coco_style_metrics.json",
             "eval_metrics.json", "final_model.npz",
             "instance_predictions_00003.json", "latest_model.npz",
             "training_metrics.json"]


def batch_at(step: int) -> dict:
    """tests/test_checkpoint_resume.py's stream: batch t a function of t."""
    rng = np.random.default_rng([11, step])
    image = rng.standard_normal((2, 3, H, H)).astype(np.float32)
    inst = np.zeros((2, 3, H, H), np.float32)
    inst[:, 0, 4:20, 4:16] = 1
    return {"image": image, "instance_masks": inst,
            "instance_valid": np.array([[True, False, False]] * 2),
            "semantic_mask": (inst[:, 0] > 0).astype(np.int32)}


def batches(start: int = 0, jax_arrays: bool = False):
    step = start
    while True:
        b = batch_at(step)
        yield {k: jnp.asarray(v) for k, v in b.items()} if jax_arrays else b
        step += 1


class CocoSet:
    """An in-memory coco2017 validation set with its annotation file."""
    name = "coco2017"
    n_categories = N_CAT

    def __init__(self, root, sizes=((40, 40), (48, 33))):
        rng = np.random.RandomState(0)
        self.samples, images, anns = [], [], []
        for i, (h, w) in enumerate(sizes):
            m = np.zeros((h, w), np.uint8)
            m[5:20, 5:25] = 1
            sem = m.astype(np.int32) * (1 + i % 2)
            self.samples.append({"image": rng.randn(3, h, w).astype(np.float32),
                                 "semantic_mask": sem, "image_id": i + 1})
            images.append({"id": i + 1, "height": h, "width": w})
            anns.append({"id": i + 1, "image_id": i + 1,
                         "category_id": 1 + i % 2, "iscrowd": 0,
                         "segmentation": rle.encode(m), "area": int(m.sum())})
        self.p_annotations = os.path.join(root, "instances_val2017.json")
        with open(self.p_annotations, "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 1}, {"id": 2}]}, f)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class SemanticSet:
    """tests/test_trainer_batched_eval.py's mixed-resolution semantic set;
    ImageNet-S's carry an original size larger than the input."""

    def __init__(self, name, sizes, orig_sizes=None, seed=0):
        self.name, self.n_categories = name, N_CAT
        rng = np.random.RandomState(seed)
        self.samples = []
        for i, (h, w) in enumerate(sizes):
            oh, ow = orig_sizes[i] if orig_sizes else (h, w)
            self.samples.append({
                "image": rng.randn(3, h, w).astype(np.float32),
                "semantic_mask": rng.randint(0, N_CAT, (oh, ow)).astype(np.int32),
                "original_size": (oh, ow)})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.RandomState(1)
    text = rng.randn(N_CAT, 16).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    jmodel = JZUTIS(**CFG)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 3, H, H)))["params"])
    for k in ("kernel", "bias"):
        params["ffn1"]["layers_2"][k] = params["ffn1"]["layers_2"][k] * 8
    root = tmp_path_factory.mktemp("trainer")
    return dict(text=text, jmodel=jmodel, params=params, root=root,
                val=CocoSet(str(root)))


def _port_model(params):
    return load_params(ZUTIS(**CFG, device="cpu"), params)


def _port_state(model, n_iters=N_ITERS):
    return TrainState.create(model, base_lr=LR, n_iters=n_iters)


@pytest.fixture(scope="module")
def fits(setup):
    """Both Trainers' fit, 3 iterations, into directories of their own."""
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = setup["root"] / side
        dirs[side].mkdir()
    tx = jmake_optimizer(base_lr=LR, n_iters=N_ITERS)
    JTrainer(setup["jmodel"], jnp.asarray(setup["text"]),
             dir_ckpt=str(dirs["jax"])).fit(
        JTrainState.create(jax.tree.map(jnp.array, setup["params"]), tx), tx,
        batches(jax_arrays=True), n_iters=N_ITERS, n_categories=N_CAT,
        iter_log=1, iter_eval=3, val_dataset=setup["val"])
    model = _port_model(setup["params"])
    Trainer(model, setup["text"], dir_ckpt=str(dirs["port"]),
            device="cpu").fit(
        _port_state(model), batches(), n_iters=N_ITERS, n_categories=N_CAT,
        iter_log=1, iter_eval=3, val_dataset=setup["val"])
    return dirs


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f.read().split("\n")]


def test_fit_writes_the_jax_artifacts(fits):
    assert sorted(os.listdir(fits["jax"])) == ARTIFACTS
    assert sorted(os.listdir(fits["port"])) == ARTIFACTS


@pytest.mark.parametrize("key", ["loss", "ce_loss", "mask_loss"])
def test_fit_losses_match_jax(fits, key):
    want = _jsonl(fits["jax"] / "training_metrics.json")
    got = _jsonl(fits["port"] / "training_metrics.json")
    assert [r["num_iter"] for r in got] == [1, 2, 3]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want],
                               rtol=1e-4)


def test_fit_training_scores_equal_jax(fits):
    want = _jsonl(fits["jax"] / "training_metrics.json")
    got = _jsonl(fits["port"] / "training_metrics.json")
    skip = {"timestamp", "iters_per_sec", "loss", "ce_loss", "mask_loss"}
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in skip} == {
            k: v for k, v in w.items() if k not in skip}
        assert g["iters_per_sec"] > 0
    assert {"0", "1", "2", "Mean IoU", "Pixel Acc"} <= set(got[0])


def _predictions_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == {
            k: v for k, v in w.items() if k != "score"}
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5)


def test_fit_evaluation_artifacts_equal_jax(fits):
    for name in ("eval_metrics.json", "eval_coco_style_metrics.json"):
        got, want = (_jsonl(fits[s] / name) for s in ("port", "jax"))
        for g, w in zip(got, want):
            g.pop("timestamp", None), w.pop("timestamp", None)
            g.pop("eval_images_per_sec", None), w.pop("eval_images_per_sec", None)
            assert g == w, name
    got, want = (json.load(open(fits[s] / "instance_predictions_00003.json"))
                 for s in ("port", "jax"))
    _predictions_equal(got, want)


def test_final_model_matches_jax(fits, setup):
    """final_model.npz against JAX's at the update tolerance of
    tests/test_torch_train_step.py (rtol 1e-5, atol 1e-6). From the second
    step on, Adam's update is a ratio of gradient moments, so an entry's
    update differs by about lr times its gradient's relative difference: it
    is held where the two gradients agree to 1e-3 of themselves at every
    step (the gradients themselves are held to the tensor's largest
    |gradient| in tests/test_torch_train_step.py). The port's loop is also
    held bit for bit against its steps run by hand."""
    want, got = (np.load(fits[s] / "final_model.npz") for s in ("jax", "port"))
    assert sorted(got.files) == sorted(want.files)
    jmodel, text = setup["jmodel"], jnp.asarray(setup["text"])

    def loss_fn(p, b):
        out = jmodel.apply({"params": p}, b["image"])
        return jcriterion_loss(out["mask_proposals"], b["instance_masks"],
                               b["instance_valid"], out["patch_tokens"],
                               b["semantic_mask"], text)["loss"]

    grad_fn = jax.jit(jax.grad(loss_fn))
    tx = jmake_optimizer(base_lr=LR, n_iters=N_ITERS)
    jstep = jmake_train_step(jmodel, tx, text, N_CAT)
    jstate = JTrainState.create(jax.tree.map(jnp.array, setup["params"]), tx)
    model = _port_model(setup["params"])
    state = _port_state(model)
    step = make_train_step(model, setup["text"], N_CAT, device="cpu")
    held = None
    for t in range(N_ITERS):
        jb = {k: jnp.asarray(v) for k, v in batch_at(t).items()}
        jg = params_from_jax(jax.tree.map(np.asarray,
                                          grad_fn(jstate.params, jb)))
        jstate, _ = jstep(jstate, jb)
        step(state, batch_at(t))
        for name, p in model.named_parameters():
            want_g = jg[name].numpy()
            got_g = (p.grad.numpy() if p.grad is not None
                     else np.zeros_like(want_g))
            agree = np.abs(got_g - want_g) <= 1e-3 * np.abs(want_g)
            held = {} if held is None else held
            held[name] = agree & held.get(name, True)
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), got[name], err_msg=name)
    n_held = sum(int(m.sum()) for m in held.values())
    assert n_held > 0.5 * sum(m.size for m in held.values())
    for name in want.files:
        assert got[name].dtype == want[name].dtype == np.float32, name
        np.testing.assert_allclose(got[name][held[name]], want[name][held[name]],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def jax_evaluations(setup):
    out = {}
    for regime, batch_images in (("per_image", 1), ("bucketed", 4)):
        trainer = JTrainer(setup["jmodel"], jnp.asarray(setup["text"]),
                           dir_ckpt=str(setup["root"] / f"jax_{regime}"))
        os.makedirs(trainer.dir_ckpt)
        scores = trainer.evaluate(setup["params"], setup["val"], num_iter=7,
                                  batch_images=batch_images)
        out[regime] = (scores, trainer.dir_ckpt)
    return out


@pytest.mark.parametrize("regime,batch_images", [("per_image", 1),
                                                 ("bucketed", 4)])
def test_evaluate_matches_jax(setup, jax_evaluations, tmp_path, regime,
                              batch_images):
    want, jdir = jax_evaluations[regime]
    model = _port_model(setup["params"])
    trainer = Trainer(model, setup["text"], dir_ckpt=str(tmp_path),
                      device="cpu")
    got = trainer.evaluate(None, setup["val"], num_iter=7,
                           batch_images=batch_images)
    assert set(got) == set(want)
    for key in got:
        if key != "eval_images_per_sec":
            assert got[key] == want[key] or (np.isnan(got[key])
                                             and np.isnan(want[key])), key
    preds = [json.load(open(os.path.join(d, "instance_predictions_00007.json")))
             for d in (tmp_path, jdir)]
    _predictions_equal(*preds)
    stats = [_jsonl(os.path.join(d, "eval_coco_style_metrics.json"))
             for d in (tmp_path, jdir)]
    assert stats[0] == stats[1]


def test_kill_and_resume_is_bit_exact(setup, tmp_path):
    params = setup["params"]
    model_a = _port_model(params)
    state_a = Trainer(model_a, setup["text"], device="cpu").fit(
        _port_state(model_a, 4), batches(), n_iters=4, n_categories=N_CAT,
        checkpoint_every=2, checkpoint_dir=str(tmp_path / "a"))

    model_b = _port_model(params)
    trainer_b = Trainer(model_b, setup["text"], device="cpu")
    trainer_b.fit(_port_state(model_b, 4), batches(), n_iters=2,
                  n_categories=N_CAT, checkpoint_every=2,
                  checkpoint_dir=str(tmp_path / "b"))
    # a new process would start from a fresh model and state
    model_c = _port_model(params)
    resume_dir = latest_step_dir(str(tmp_path / "b"))
    assert resume_dir.endswith("step_2")
    restored = restore_train_state(resume_dir, _port_state(model_c, 4))
    assert restored.step == 2
    state_c = Trainer(model_c, setup["text"], device="cpu").fit(
        restored, batches(restored.step), n_iters=4, n_categories=N_CAT)
    assert state_c.step == state_a.step == 4
    for (name, a), (_, c) in zip(state_a.model.state_dict().items(),
                                 state_c.model.state_dict().items()):
        torch.testing.assert_close(c, a, rtol=0, atol=0, msg=name)
    sa, sc = state_a.optimizer.state_dict(), state_c.optimizer.state_dict()
    for k in sa["state"]:
        for m in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(sc["state"][k][m], sa["state"][k][m],
                                       rtol=0, atol=0)
    assert state_c.scheduler.get_last_lr() == state_a.scheduler.get_last_lr()


def test_resumed_run_appends_to_the_metrics(setup, tmp_path):
    model = _port_model(setup["params"])
    trainer = Trainer(model, setup["text"], dir_ckpt=str(tmp_path),
                      device="cpu")
    state = trainer.fit(_port_state(model, 4), batches(), n_iters=2,
                        n_categories=N_CAT, iter_log=1)
    trainer.fit(state, batches(2), n_iters=4, n_categories=N_CAT, iter_log=1)
    assert [r["num_iter"] for r in _jsonl(tmp_path / "training_metrics.json")
            ] == [1, 2, 3, 4]
    # a new run in the same directory starts the file afresh
    model = _port_model(setup["params"])
    Trainer(model, setup["text"], dir_ckpt=str(tmp_path), device="cpu").fit(
        _port_state(model, 4), batches(), n_iters=1, n_categories=N_CAT,
        iter_log=1)
    assert [r["num_iter"] for r in _jsonl(tmp_path / "training_metrics.json")
            ] == [1]


def test_nan_batch_raises_naming_step_1(setup):
    model = _port_model(setup["params"])

    def nan_batches():
        while True:
            b = batch_at(0)
            b["image"] = np.full_like(b["image"], np.nan)
            yield b

    with pytest.raises(NonFiniteError, match="step 1"):
        Trainer(model, setup["text"], device="cpu").fit(
            _port_state(model, 2), nan_batches(), n_iters=2,
            n_categories=N_CAT)


def test_profile_dir_writes_a_trace(setup, tmp_path):
    model = _port_model(setup["params"])
    Trainer(model, setup["text"], device="cpu").fit(
        _port_state(model, 3), batches(), n_iters=3, n_categories=N_CAT,
        profile_dir=str(tmp_path / "trace"), profile_steps=(1, 2))
    with open(tmp_path / "trace" / TRACE_FILE) as f:
        assert json.load(f)["traceEvents"]


def test_debug_runs_one_iteration_and_one_image(setup, tmp_path):
    model = _port_model(setup["params"])
    seen = []
    state = Trainer(model, setup["text"], dir_ckpt=str(tmp_path), debug=True,
                    device="cpu").fit(
        _port_state(model), batches(), n_iters=N_ITERS, n_categories=N_CAT,
        val_dataset=setup["val"], eval_every_cb=lambda i, s: seen.append(i))
    assert state.step == 1 and seen == [1]
    assert len(_jsonl(tmp_path / "training_metrics.json")) == 1
    preds = json.load(open(tmp_path / "instance_predictions_00001.json"))
    assert {p["image_id"] for p in preds} <= {1}


def test_imagenet_s919_is_not_evaluated_in_training(setup, tmp_path):
    model = _port_model(setup["params"])
    Trainer(model, setup["text"], dir_ckpt=str(tmp_path), device="cpu").fit(
        _port_state(model, 1), batches(), n_iters=1, n_categories=N_CAT,
        iter_eval=1, val_dataset=SemanticSet("imagenet-s919", [(32, 32)]))
    assert sorted(os.listdir(tmp_path)) == ["final_model.npz"]


@pytest.mark.parametrize("name,sizes,orig,batch_images", [
    ("coca", [(48, 48), (32, 48), (37, 33), (48, 37), (33, 47)], None, 4),
    ("imagenet-s919", [(48, 48), (32, 32), (37, 33)],
     [(70, 65), (50, 41), (37, 33)], 2),
])
def test_bucketed_evaluate_equals_per_image(setup, name, sizes, orig,
                                            batch_images):
    model = _port_model(setup["params"])
    trainer = Trainer(model, setup["text"], device="cpu")
    ds = SemanticSet(name, sizes, orig)
    got = {b: trainer.evaluate(None, ds, batch_images=b)
           for b in (batch_images, 1)}
    for key in ("Mean IoU", "Pixel Acc"):
        assert got[batch_images][key] == got[1][key]


def test_evaluate_builds_each_bucket_step_once(setup, monkeypatch):
    from zutis_tpu_torch.engine import batched_eval as BE

    made = []
    real = BE.make_semantic_confusion_step
    monkeypatch.setattr(BE, "make_semantic_confusion_step",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    model = _port_model(setup["params"])
    trainer = Trainer(model, setup["text"], device="cpu")
    ds = SemanticSet("coca", [(48, 48), (32, 48), (48, 48), (32, 48)], seed=7)
    first = trainer.evaluate(None, ds, batch_images=2)
    n_made = len(made)
    assert n_made >= 1
    assert trainer.evaluate(None, ds, batch_images=2)["Mean IoU"] == first[
        "Mean IoU"]
    assert len(made) == n_made


@pytest.mark.parametrize("mode", ["visualise", "debug"])
def test_fit_writes_the_jax_figures(setup, tmp_path, mode):
    """visualise=True draws at each log point (iter_log 2: iteration 2),
    debug at its one iteration; the same file names as the JAX Trainer's,
    each a PNG that the port's decoder reads."""
    debug = mode == "debug"
    kw = dict(n_iters=N_ITERS, n_categories=N_CAT, iter_log=2,
              visualise=not debug)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    tx = jmake_optimizer(base_lr=LR, n_iters=N_ITERS)
    JTrainer(setup["jmodel"], jnp.asarray(setup["text"]),
             dir_ckpt=str(tmp_path / "jax"), debug=debug).fit(
        JTrainState.create(jax.tree.map(jnp.array, setup["params"]), tx), tx,
        batches(jax_arrays=True), **kw)
    model = _port_model(setup["params"])
    trainer = Trainer(model, setup["text"], dir_ckpt=str(tmp_path / "port"),
                      debug=debug, device="cpu")
    trainer.fit(_port_state(model), batches(), **kw)
    figures = {side: sorted(f for f in os.listdir(tmp_path / side)
                            if f.endswith(".png")) for side in ("jax", "port")}
    k = 1 if debug else 2
    assert figures["port"] == figures["jax"] == [
        f"{stem}_{k:05d}.png" for stem in ("matched", "queries", "semantic")]
    assert trainer.last_visualisation["num_iter"] == k
    for name in figures["port"]:
        image = read_png(tmp_path / "port" / name)
        assert image.dtype == np.uint8 and image.shape[2] == 3


def test_visualise_train_matches_jax(setup, tmp_path, monkeypatch):
    """On the same parameters and batch, the arrays each side hands its
    figures: the triptych's image and ground truth equal and its semantic
    argmax equal wherever the top two resized logits are more than 1e-5
    apart; the proposals and the resized proposals within the f32 parity
    tolerance; the matched assignment and ground truth equal."""
    from zutis_tpu.engine import visualiser as jax_vis
    from zutis_tpu.ops.resize import resize_2d as jresize
    from zutis_tpu_torch.engine import visualiser as port_vis

    seen = {"jax": {}, "port": {}}
    for side, module in (("jax", jax_vis), ("port", port_vis)):
        for name in ("semantic_triptych", "query_grid", "matched_pairs"):
            def record(*a, _side=side, _name=name, _real=getattr(module, name),
                       **k):
                seen[_side][_name] = a
                return _real(*a, **k)
            monkeypatch.setattr(module, name, record)
    batch = batch_at(0)
    params = jax.tree.map(jnp.array, setup["params"])
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    JTrainer(setup["jmodel"], jnp.asarray(setup["text"]),
             dir_ckpt=str(tmp_path / "jax"))._visualise_train(
        params, batch, 7, 255)
    Trainer(_port_model(setup["params"]), setup["text"],
            dir_ckpt=str(tmp_path / "port"),
            device="cpu")._visualise_train(batch, 7, 255)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == [
        "matched_00007.png", "queries_00007.png", "semantic_00007.png"]

    got, want = seen["port"], seen["jax"]
    for i in (0, 1):  # the normalised image, the ground truth
        np.testing.assert_array_equal(got["semantic_triptych"][i],
                                      want["semantic_triptych"][i])
    out = setup["jmodel"].apply({"params": params},
                                jnp.asarray(batch["image"][:1]))
    logits = np.asarray(jresize(jnp.einsum(
        "nc,bhwc->bnhw", jnp.asarray(setup["text"]), out["patch_tokens"]),
        (H, H), "linear"))[0]
    top2 = np.sort(logits, axis=0)[-2:]
    decided = top2[1] - top2[0] > 1e-5
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(got["semantic_triptych"][2][decided],
                                  want["semantic_triptych"][2][decided])
    np.testing.assert_allclose(got["query_grid"][0], want["query_grid"][0],
                               rtol=2e-4, atol=2e-5)
    gt, up, assignment = got["matched_pairs"][:3]
    np.testing.assert_array_equal(gt, want["matched_pairs"][0])
    np.testing.assert_allclose(up, np.asarray(want["matched_pairs"][1]),
                               rtol=2e-4, atol=2e-5)
    assert assignment == want["matched_pairs"][2] and len(assignment) == 1


def test_trainer_refuses_a_model_on_another_device(setup):
    if torch.cuda.is_available():
        pytest.skip("the refusal is of CUDA on a host without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_port_model(setup["params"]), setup["text"])
