"""The port's two CLIs (zutis_tpu_torch/cli/main.py, cli/coco20k_eval.py)
and its model factory on the CPU, against the JAX package's on the tiny
fixture of tests/fixture_helpers.py: training writes the JAX CLI's
artifacts (no figures: the port does not visualise) and resumes from its
newest full checkpoint; evaluating a JAX-written `.npz` gives the JAX CLI's
`eval_metrics.json` and `eval_coco_style_metrics.json` (every score within
1e-6, NaNs where JAX has NaNs); `coco20k_eval` gives the JAX CLI's
predictions and metrics; `load_clip_visual` gives `load_clip_params`'s
encoder on a synthetic CLIP-layout checkpoint; the training CLI makes missing
pseudo-masks from a synthetic SelfMask checkpoint in the flat and ImageNet
layouts, equal to the JAX package's, and refuses without one; both CLIs
build the config's `tome_r` / `decoder_pool` extras into the model (the port
of tests/test_cli_levers.py); the other refusals name their ROADMAP item. The text embeddings computed from a checkpoint are in
tests/test_torch_text_embeddings.py."""
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from fixture_helpers import base_cli_cfg, dump_cfg, write_cli_fixture
from zutis_tpu.cli import coco20k_eval as jax_coco20k
from zutis_tpu.cli import main as jax_main
from zutis_tpu.ops import rle as jax_rle
from zutis_tpu_torch.cli import coco20k_eval, main as port_main
from zutis_tpu_torch.core.config import Config
from zutis_tpu_torch.models import factory

SCORE_TOL = 1e-6
TIMING_KEYS = {"timestamp", "eval_images_per_sec", "iters_per_sec",
               "eval_images_per_sec_warm", "compile_seconds"}
ARTIFACTS = {"config.json", "training_metrics.json", "eval_metrics.json",
             "eval_coco_style_metrics.json", "instance_predictions_00003.json",
             "latest_model.npz", "best_model.npz", "final_model.npz"}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    parts = write_cli_fixture(root, n_val_images=3)
    return root, parts


def _cfg(fixture, name, **overrides):
    root, parts = fixture
    cfg = base_cli_cfg(*parts, root / f"ckpt_{name}", **overrides)
    return cfg, dump_cfg(cfg, root / f"{name}.yaml")


def _run_dir(base):
    found = [dp for dp, _, fns in os.walk(base) if "config.json" in fns]
    assert len(found) == 1, found
    return found[0]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f.read().splitlines()]


def _close(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return abs(a - b) <= SCORE_TOL


def _assert_scores_close(got, want):
    assert set(got) == set(want)
    for k in set(want) - TIMING_KEYS:
        assert _close(got[k], want[k]), (k, got[k], want[k])


def test_train_three_iterations_writes_the_artifacts(fixture):
    _, cfg_fp = _cfg(fixture, "train")
    port_main.main(["--p_config", cfg_fp, "--device", "cpu"])
    run = _run_dir(fixture[0] / "ckpt_train")
    names = set(os.listdir(run))
    assert names == ARTIFACTS, names  # no figures
    logs = _jsonl(f"{run}/training_metrics.json")
    assert [r["num_iter"] for r in logs] == [1, 2, 3]
    assert {"num_iter", "loss", "Mean IoU", "Pixel Acc"} <= set(logs[0])
    assert all(np.isfinite(r["loss"]) for r in logs)
    assert _jsonl(f"{run}/eval_metrics.json")[0]["eval_images_per_sec"] > 0
    with open(f"{run}/config.json") as f:
        assert json.load(f)["n_iters"] == 3
    # a second call finds final_model.npz and returns
    assert port_main.main(["--p_config", cfg_fp, "--device", "cpu"]) is None


def test_training_resumes_from_the_newest_checkpoint(fixture):
    _, cfg_fp = _cfg(fixture, "resume", n_iters=4, iter_eval=4,
                     checkpoint_every=2)
    port_main.main(["--p_config", cfg_fp, "--device", "cpu"])
    run = _run_dir(fixture[0] / "ckpt_resume")
    with np.load(f"{run}/final_model.npz") as f:
        straight = {k: f[k] for k in f.files}
    assert sorted(os.listdir(f"{run}/checkpoints")) == ["step_2", "step_4"]
    os.remove(f"{run}/final_model.npz")
    os.remove(f"{run}/checkpoints/step_4/state.pt")
    port_main.main(["--p_config", cfg_fp, "--device", "cpu"])
    with np.load(f"{run}/final_model.npz") as f:
        for k, v in straight.items():
            np.testing.assert_array_equal(f[k], v, err_msg=k)


@pytest.fixture(scope="module")
def jax_npz(fixture):
    import jax
    import jax.numpy as jnp

    from zutis_tpu.models.weights import export_zutis
    from zutis_tpu.models.zutis import ZUTIS

    cfg, _ = _cfg(fixture, "npz")
    model = ZUTIS(**cfg["model_kwargs"])
    params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                 jnp.zeros((1, 3, 32, 32)))["params"]
    path = fixture[0] / "jax_model.npz"
    np.savez(path, **export_zutis(params))
    return str(path)


def test_eval_from_a_jax_npz_gives_the_jax_clis_metrics(fixture, jax_npz):
    _, cfg_jax = _cfg(fixture, "eval_jax")
    _, cfg_port = _cfg(fixture, "eval_port")
    jax_main.main(["--p_config", cfg_jax, "--p_state_dict", jax_npz])
    port_main.main(["--p_config", cfg_port, "--p_state_dict", jax_npz,
                    "--device", "cpu"])
    run_jax = _run_dir(fixture[0] / "ckpt_eval_jax")
    run_port = _run_dir(fixture[0] / "ckpt_eval_port")
    for name in ("eval_metrics.json", "eval_coco_style_metrics.json"):
        want, got = _jsonl(f"{run_jax}/{name}"), _jsonl(f"{run_port}/{name}")
        assert len(got) == len(want) == 1
        _assert_scores_close(got[0], want[0])


@pytest.fixture(scope="module")
def coco20k(fixture):
    root = fixture[0] / "coco20k"
    (root / "train2014").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.RandomState(3)
    images, annotations = [], []
    for img_id, (h, w) in zip((1, 2, 3, 4, 5),
                              ((40, 40), (40, 40), (33, 47), (64, 48),
                               (40, 40))):
        arr = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        Image.fromarray(arr).save(root / "train2014" / f"{img_id:012d}.jpg")
        m = np.zeros((h, w), np.uint8)
        m[4:20, 5:25] = 1
        images.append({"id": img_id, "height": h, "width": w,
                       "file_name": f"{img_id:012d}.jpg"})
        annotations.append({
            "id": img_id, "image_id": img_id, "category_id": 1,
            "segmentation": jax_rle.encode(m), "area": int(m.sum()),
            "iscrowd": 0, "bbox": jax_rle.to_bbox(m)})
    with open(root / "annotations" / "instances_train2014_sel20k.json",
              "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1}, {"id": 2}]}, f)
    return root


def _sorted_preds(preds):
    keyed = [(p["image_id"], -p["score"], p["category_id"],
              p["segmentation"]["counts"]) for p in preds]
    return sorted(keyed)


@pytest.mark.parametrize("batch_images,depth", [(4, 1), (4, 2), (1, 1)])
def test_coco20k_eval_gives_the_jax_clis_predictions(
        fixture, jax_npz, coco20k, monkeypatch, tmp_path, batch_images,
        depth):
    from zutis_tpu.engine import coco_eval as jax_coco_eval
    from zutis_tpu_torch.engine import coco_eval as port_coco_eval

    _, cfg_fp = _cfg(fixture, "c20k")
    seen_jax, seen_port = [], []

    def recorder(cls, seen):
        class Recording(cls):
            def evaluate(self, predictions):
                seen.extend(predictions)
                return super().evaluate(predictions)
        return Recording

    monkeypatch.setattr(jax_coco_eval, "COCOEvaluator",
                        recorder(jax_coco_eval.COCOEvaluator, seen_jax))
    monkeypatch.setattr(port_coco_eval, "COCOEvaluator",
                        recorder(port_coco_eval.COCOEvaluator, seen_port))
    args = ["--p_config", cfg_fp, "--p_state_dict", jax_npz,
            "--dir_dataset", str(coco20k), "--threshold", "0.3",
            "--batch_images", str(batch_images)]
    jax_coco20k.main(args + ["--dir_ckpt", str(tmp_path / "jax")])
    got = coco20k_eval.main(args + ["--dir_ckpt", str(tmp_path / "port"),
                                    "--pipeline_depth", str(depth),
                                    "--device", "cpu"])
    assert len(seen_port) == len(seen_jax) > 0
    got_p, want_p = _sorted_preds(seen_port), _sorted_preds(seen_jax)
    for (gi, gs, gc, gm), (wi, ws, wc, wm) in zip(got_p, want_p):
        assert (gi, gc, gm) == (wi, wc, wm)
        assert abs(gs - ws) <= SCORE_TOL
    out = {}
    for side in ("jax", "port"):
        files = [os.path.join(dp, fn) for dp, _, fns in
                 os.walk(tmp_path / side) for fn in fns]
        assert len(files) == 1 and files[0].endswith(
            "coco20k_metrics_vit_b_16_nms_hard.json"), files
        with open(files[0]) as f:
            out[side] = json.load(f)
    assert set(out["port"]) == set(out["jax"])
    _assert_scores_close(out["port"], out["jax"])
    assert got["eval_images_per_sec"] > 0


def test_train_cli_trains_a_tiny_rn_from_its_clip_checkpoint(fixture,
                                                            tmp_path):
    """clip_arch RN50 with the pretrained visual tower (the tiny RN's
    weights in OpenAI's layout as <assets>/RN50.pt): 3 iterations, the
    artifacts, final_model.npz as the JAX package's raw RN tree, and the
    BatchNorm statistics still the checkpoint's."""
    from zutis_tpu_torch.core.checkpoint import load_params_any

    ckpt = _synthetic_rn_clip()
    torch.save(ckpt, tmp_path / "RN50.pt")
    _, cfg_fp = _cfg(fixture, "train_rn", clip_arch="RN50",
                     skip_pretrained=False, clip_assets_dir=str(tmp_path),
                     model_kwargs=TINY_RN)
    port_main.main(["--p_config", cfg_fp, "--device", "cpu"])
    run = _run_dir(fixture[0] / "ckpt_train_rn")
    assert set(os.listdir(run)) == ARTIFACTS
    assert all(np.isfinite(r["loss"])
               for r in _jsonl(f"{run}/training_metrics.json"))
    with np.load(f"{run}/final_model.npz") as f:
        assert all(k.startswith("__flax_raw__/") for k in f.files)
    final = load_params_any(f"{run}/final_model.npz")
    for k, v in ckpt.items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(final["encoder." + k[len("visual."):]],
                                       v.float(), rtol=0, atol=0)


@pytest.mark.parametrize("family", ["rn", "dino"])
def test_coco20k_eval_of_rn_and_dino_runs_per_image(fixture, coco20k,
                                                   tmp_path, family):
    """RN and DINO models evaluate image by image at any --batch_images
    (no padded path), giving the JAX CLI's per-image predictions and
    metrics (the JAX CLI would send the DINO arm to its batched path and
    fail there)."""
    import jax
    import jax.numpy as jnp

    from zutis_tpu.models.weights import export_zutis
    from zutis_tpu.models.zutis import ZUTIS as JaxZUTIS
    from zutis_tpu_torch.engine import batched_eval as BE

    kwargs = TINY_RN if family == "rn" else TINY_DINO
    jm = JaxZUTIS(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in kwargs.items()})
    params = jax.jit(jm.init)(jax.random.PRNGKey(4),
                              jnp.zeros((1, 3, 64, 64)))["params"]
    npz = tmp_path / "model.npz"
    np.savez(npz, **export_zutis(params))
    _, cfg_fp = _cfg(fixture, f"c20k_{family}", model_kwargs=kwargs)
    # two 40 x 40 images and a 33 x 47 one (no patch multiple: DINO's
    # patchify drops the remainder, as flax's VALID convolution does)
    args = ["--p_config", cfg_fp, "--p_state_dict", str(npz),
            "--dir_dataset", str(coco20k), "--threshold", "0.3",
            "--max_images", "3"]
    out = {}
    for side, run, extra in (
            ("jax", jax_coco20k.main, ["--batch_images", "1"]),
            ("port", coco20k_eval.main, ["--batch_images", "4",
                                         "--device", "cpu"])):
        calls = []
        real = BE.evaluate_instances
        BE.evaluate_instances = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            run(args + extra + ["--dir_ckpt", str(tmp_path / side)])
        finally:
            BE.evaluate_instances = real
        assert not calls  # the port's batched path is the ViT family's
        files = [os.path.join(dp, fn) for dp, _, fns in
                 os.walk(tmp_path / side) for fn in fns]
        assert len(files) == 1, files
        with open(files[0]) as f:
            out[side] = json.load(f)
    assert set(out["port"]) == set(out["jax"])
    _assert_scores_close(out["port"], out["jax"])


def test_coco20k_eval_refuses_visualise(fixture, jax_npz, coco20k):
    _, cfg_fp = _cfg(fixture, "c20k_vis")
    with pytest.raises(NotImplementedError, match="matplotlib"):
        coco20k_eval.main(["--p_config", cfg_fp, "--p_state_dict", jax_npz,
                           "--dir_dataset", str(coco20k),
                           "--visualise_first", "1", "--device", "cpu"])


# ------------------------------------------------------------ factory

def _synthetic_clip(width=32, layers=2, patch=16, res=32, text_layers=1):
    """A CLIP-layout state dict: the visual tower from a port encoder's
    random parameters under `visual.`, and a small text tower."""
    from zutis_tpu_torch.models.vit import CLIPViT

    enc = CLIPViT(width=width, layers=layers, heads=2, patch_size=patch,
                  output_dim=16, input_resolution=res, device="cpu")
    enc.init_params(torch.Generator().manual_seed(11))
    sd = {f"visual.{k}": v.clone().half() for k, v in
          enc.state_dict().items()}
    g = torch.Generator().manual_seed(12)
    text = CLIPViT(width=width, layers=text_layers, heads=2,
                   patch_size=patch, output_dim=16, input_resolution=res,
                   device="cpu")
    text.init_params(g)
    for k, v in text.state_dict().items():
        if k.startswith("transformer."):
            sd[k] = v.clone().half()
    sd["token_embedding.weight"] = torch.randn(50, width, generator=g).half()
    sd["positional_embedding"] = torch.randn(8, width, generator=g).half()
    sd["ln_final.weight"] = torch.ones(width).half()
    sd["ln_final.bias"] = torch.zeros(width).half()
    sd["text_projection"] = torch.randn(width, 16, generator=g).half()
    sd["logit_scale"] = torch.tensor(4.6)
    return sd


class _Holder(torch.nn.Module):
    """A scriptable module whose state dict is `sd` (as OpenAI's archives)."""

    def __init__(self, sd):
        super().__init__()
        for key, v in sd.items():
            mod = self
            *path, leaf = key.split(".")
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, torch.nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, torch.nn.Parameter(v,
                                                            requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


@pytest.mark.parametrize("archive", ["torchscript", "state_dict"])
def test_load_clip_visual_equals_load_clip_params(tmp_path, archive):
    import jax

    from zutis_tpu.models.factory import load_clip_params
    from zutis_tpu.models.zutis import ZUTIS as JaxZUTIS
    from zutis_tpu_torch.models.weights import params_from_jax
    from zutis_tpu_torch.models.zutis import ZUTIS

    sd = _synthetic_clip()
    path = tmp_path / "ViT-B-16.pt"
    if archive == "torchscript":
        torch.jit.save(torch.jit.script(_Holder(sd)), str(path))
    else:
        torch.save(sd, path)
    kw = dict(width=32, encoder_layers=2, encoder_heads=2, patch_size=16,
              text_dim=16, n_queries=4, n_decoder_layers=1, n_heads=2,
              input_resolution=32)
    model = ZUTIS(**kw, device="cpu")
    assert factory.load_clip_visual(model, str(path)) is model
    visual, _ = load_clip_params("ViT-B/16", str(tmp_path))
    params = jax.jit(JaxZUTIS(**kw).init)(
        jax.random.PRNGKey(0), np.zeros((1, 3, 32, 32), np.float32))["params"]
    params = dict(params, encoder=visual)
    want = {k: v for k, v in params_from_jax(params).items()
            if k.startswith("encoder.")}
    got = {f"encoder.{k}": v for k, v in model.encoder.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


TINY_RN = {"encoder_family": "rn", "rn_layers": [1, 1, 1, 1], "rn_width": 8,
           "width": 256, "text_dim": 16, "n_queries": 12,
           "n_decoder_layers": 2, "n_heads": 2, "input_resolution": 64}
TINY_DINO = {"encoder_family": "dino", "width": 16, "text_dim": 16,
             "patch_size": 16, "input_resolution": 32, "dino_embed_dim": 32,
             "dino_depth": 1, "dino_heads": 2, "n_queries": 12,
             "n_decoder_layers": 2, "n_heads": 2}


def _synthetic_rn_clip(seed=12):
    """An OpenAI RN archive's layout for the tiny RN: the visual tower of a
    seeded port encoder (BatchNorm statistics off the identity) in fp16
    under `visual.`, with torch BatchNorm's `num_batches_tracked`."""
    from zutis_tpu_torch.models.zutis import ZUTIS

    model = ZUTIS(**TINY_RN, device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.encoder.state_dict().items():
        if k.endswith("running_var"):
            v = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape))
        elif k.endswith("running_mean"):
            v = torch.from_numpy(0.2 * rng.normal(size=v.shape))
        sd[f"visual.{k}"] = v.clone().half()
        if k.endswith("running_mean"):
            sd[f"visual.{k[:-len('running_mean')]}num_batches_tracked"] = \
                torch.tensor(0)
    # the text tower of _synthetic_clip, which load_clip_params also reads
    sd.update({k: v for k, v in _synthetic_clip().items()
               if not k.startswith("visual.")})
    return sd


def test_load_clip_visual_equals_load_clip_params_for_a_resnet(tmp_path):
    """OpenAI's RN layout through the port's `load_clip_visual` and through
    the JAX package's `load_clip_params` (which dispatches it to
    `convert_clip_rn_visual`): the same encoder, bit for bit."""
    from zutis_tpu.models.factory import load_clip_params
    from zutis_tpu_torch.models.weights import rn_visual_params_from_jax
    from zutis_tpu_torch.models.zutis import ZUTIS

    torch.save(_synthetic_rn_clip(), tmp_path / "RN50.pt")
    model = ZUTIS(**TINY_RN, device="cpu")
    assert factory.load_clip_visual(model, str(tmp_path / "RN50.pt")) is model
    visual, _ = load_clip_params("dilatedRN50", str(tmp_path))
    want = rn_visual_params_from_jax(visual)
    got = model.encoder.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def _flax_shapes(model):
    import jax
    import jax.numpy as jnp

    return jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 3, 64, 64)))["params"]


def _port_size(model):
    return sum(v.numel() for v in model.state_dict().values())


@pytest.mark.parametrize("arch", ["ViT-B/32", "ViT-B/16", "ViT-L/14",
                                  "ViT-L/14@336px", "RN50", "RN101", "RN50x4",
                                  "RN50x16", "RN50x64", "dilatedRN50"])
def test_factory_equals_jax(arch):
    """The arch's spec, checkpoint path and model against the JAX
    factory's: every family's widths, and for RN the blocks a stage,
    attnpool's stored grid and output and the upsample flag; the count of
    parameters and BatchNorm statistics equal to the flax tree's."""
    import jax

    from zutis_tpu.models import factory as jax_factory

    assert factory.normalize_clip_arch(arch) == \
        jax_factory.normalize_clip_arch(arch)
    for assets in ("assets", "/x/y"):
        assert factory.clip_checkpoint_path(arch, assets) == \
            jax_factory.clip_checkpoint_path(arch, assets)
    jm = jax_factory.build_zutis(arch)
    model = factory.build_zutis(arch, device="meta")
    assert (model.width, model.encoder_family, model.upsample_tokens) == (
        jm.width, jm.encoder_family, jm.upsample_tokens)
    if model.encoder_family == "vit":
        assert factory.clip_spec(arch).__dict__ == \
            jax_factory.clip_spec(arch).__dict__
        spec = factory.clip_spec(arch)
        assert len(model.encoder.transformer.resblocks) == spec.layers
        assert model.encoder.proj.shape == (spec.width, spec.embed_dim)
        return
    enc = model.encoder
    assert tuple(len(getattr(enc, f"layer{i}")) for i in (1, 2, 3, 4)) == \
        tuple(jm.rn_layers)
    assert enc.width == jm.rn_width and enc.embed_dim == jm.width
    g = jm.input_resolution // 32
    assert enc.attnpool.positional_embedding.shape == (g * g + 1, jm.width)
    assert enc.attnpool.c_proj.weight.shape == (jm.text_dim, jm.width)
    assert enc.attnpool.num_heads == jm.width // 64
    # the decoder's heads: 8 over 2048 channels (head dim 256) for RN50
    assert model.decoder.layers[0].self_attn.heads == jm.n_heads
    assert _port_size(model) == sum(
        x.size for x in jax.tree.leaves(_flax_shapes(jm)))


@pytest.mark.parametrize("base", ["ViT-B/16", "RN50"])
def test_factory_dino_arm_equals_jax(base):
    """encoder_type "dino": DINO ViT-B/16 in the base arch's text dim (an RN
    arch's attnpool output)."""
    import jax

    from zutis_tpu.models import factory as jax_factory

    jm = jax_factory.build_zutis(base, encoder_type="dino")
    model = factory.build_zutis(base, encoder_type="dino", device="meta")
    assert (model.encoder_family, model.width) == ("dino", jm.width)
    assert model.width == (1024 if base == "RN50" else 512)
    assert (model.encoder.embed_dim, len(model.encoder.blocks),
            model.encoder.patch_size) == (768, 12, 16)
    assert model.encoder.pos_embed.shape == (1, 14 * 14 + 1, 768)
    assert _port_size(model) == sum(
        x.size for x in jax.tree.leaves(_flax_shapes(jm)))


def test_factory_passes_the_levers():
    with torch.device("meta"):
        model = factory.build_zutis("ViT-B/16", tome_r=16, decoder_pool=2,
                                    device="cpu")
        plain = factory.build_zutis("ViT-B/16", device="cpu")
    assert (model.tome_r, model.encoder.tome_r, model.decoder_pool) == (16, 16, 2)
    assert (plain.tome_r, plain.decoder_pool) == (0, 1)
    assert list(model.state_dict()) == list(plain.state_dict())
    with pytest.raises(ValueError, match="decoder_pool must be >= 1"):
        factory.build_zutis("ViT-B/16", decoder_pool=0, device="meta")


# ------------------------------------------------------------ the levers
# (the port of tests/test_cli_levers.py: both CLIs build the config's
# tome_r / decoder_pool extras into the model)

class _Captured(Exception):
    pass


@pytest.fixture()
def lever_cfg(fixture, tmp_path):
    cfg, _ = _cfg(fixture, "levers", tome_r=3, decoder_pool=2)
    del cfg["model_kwargs"]  # the build_zutis (published-arch) branch
    cfg["dir_ckpt"] = str(tmp_path / "ckpt")
    return dump_cfg(cfg, tmp_path / "lever.yaml")


def _capture_build(monkeypatch):
    seen = {}

    def fake_build(clip_arch, **kwargs):
        seen.update(kwargs, clip_arch=clip_arch)
        raise _Captured

    monkeypatch.setattr(factory, "build_zutis", fake_build)
    return seen


def test_train_cli_passes_levers(lever_cfg, monkeypatch):
    seen = _capture_build(monkeypatch)
    with pytest.raises(_Captured):
        port_main.main(["--p_config", str(lever_cfg), "--device", "cpu"])
    assert seen["tome_r"] == 3 and seen["decoder_pool"] == 2


def test_coco20k_eval_cli_passes_levers(lever_cfg, coco20k, tmp_path,
                                        monkeypatch):
    seen = _capture_build(monkeypatch)
    with pytest.raises(_Captured):
        coco20k_eval.main(["--p_config", str(lever_cfg),
                           "--p_state_dict", str(tmp_path / "none.npz"),
                           "--dir_dataset", str(coco20k),
                           "--dir_ckpt", str(tmp_path / "out"),
                           "--device", "cpu"])
    assert seen["tome_r"] == 3 and seen["decoder_pool"] == 2


def test_build_model_carries_the_levers(fixture, lever_cfg, tmp_path):
    """Both branches of the CLIs' `build_model`: the config's extras through
    build_zutis, and `model_kwargs` carrying the levers itself."""
    with torch.device("meta"):
        model = port_main.build_model(Config.load(str(lever_cfg)), "cpu",
                                      init=False)
    assert (model.tome_r, model.encoder.tome_r, model.decoder_pool) == (3, 3, 2)
    cfg, _ = _cfg(fixture, "lever_kwargs")
    cfg["model_kwargs"] = dict(cfg["model_kwargs"], tome_r=2, decoder_pool=2)
    fp = dump_cfg(cfg, tmp_path / "kwargs.yaml")
    model = port_main.build_model(Config.load(fp), "cpu")
    assert (model.tome_r, model.decoder_pool) == (2, 2)


# ------------------------------------------------- text embeddings, refusals

def test_text_embeddings_from_the_npz_and_the_jax_cache(fixture, tmp_path):
    cfg, cfg_fp = _cfg(fixture, "text")
    port_cfg = Config.load(cfg_fp)
    with np.load(cfg["text_embeddings_npz"]) as f:
        want = f["embeddings"]
    np.testing.assert_array_equal(port_main.build_text_embeddings(port_cfg),
                                  want)
    # the JAX CLI's cache file, with no override
    cfg2 = dict(cfg, clip_assets_dir=str(tmp_path))
    cfg2.pop("text_embeddings_npz")
    fp = dump_cfg(cfg2, tmp_path / "cache.yaml")
    port_cfg = Config.load(fp)
    cache = port_main.text_embeddings_cache_path(port_cfg)
    assert os.path.basename(cache).startswith("text_emb_ViT-B_16_3cat_")
    # neither: the text tower needs the merges file, which is missing
    with pytest.raises(FileNotFoundError, match="BPE merges file not found"):
        port_main.build_text_embeddings(port_cfg, "cpu")
    emb = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
    np.savez(cache, embeddings=emb,
             categories=np.array(cfg2["categories"], dtype=object))
    from zutis_tpu.core.config import Config as JaxConfig

    np.testing.assert_array_equal(
        port_main.build_text_embeddings(port_cfg),
        np.asarray(jax_main.build_text_embeddings(JaxConfig.load(fp))))


@pytest.mark.parametrize("overrides,error,match", [
    (dict(mesh_axes={"data": 2, "model": 1}), NotImplementedError, "item 6"),
    (dict(visualise=True), NotImplementedError, "matplotlib"),
    (dict(category_to_p_images_fp="MISSING_PM"), FileNotFoundError,
     "1 pseudo-masks missing and no SelfMask weights at .*selfmask_nq20.pt"),
    (dict(encoder_type="dino", skip_pretrained=False), ValueError,
     "encoder_type 'dino' needs the skip_pretrained extra"),
])
def test_cli_refusals(fixture, tmp_path, overrides, error, match):
    if overrides.get("category_to_p_images_fp") == "MISSING_PM":
        # the category cache names an image with no pseudo-mask, and the
        # assets directory holds no SelfMask checkpoint to make it with
        fp = tmp_path / "cats" / "category_to_p_images.json"
        fp.parent.mkdir()
        fp.write_text(json.dumps({"square": [str(tmp_path / "new.jpg")]}))
        overrides = dict(overrides, category_to_p_images_fp=str(fp),
                         clip_assets_dir=str(tmp_path))
    cfg, _ = _cfg(fixture, "refuse", **overrides)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    cfg["dir_ckpt"] = str(tmp_path / "ckpt")
    fp = dump_cfg(cfg, tmp_path / "refuse.yaml")
    with pytest.raises(error, match=match):
        port_main.main(["--p_config", fp, "--device", "cpu"])


@pytest.fixture(scope="module")
def selfmask_assets(tmp_path_factory):
    """A synthetic SelfMask checkpoint in the reference layout (width 64,
    so one DeiT head; one encoder and one decoder layer, 4 queries) as
    `<assets>/selfmask_nq20.pt`, and the JAX model and parameters that
    `convert_selfmask_checkpoint` makes of it."""
    from torch_oracle import TorchSelfMask
    from zutis_tpu.models.selfmask import SelfMask as JaxSelfMask
    from zutis_tpu.models.selfmask import convert_selfmask_checkpoint
    from zutis_tpu.models.weights import load_torch_state_dict

    assets = tmp_path_factory.mktemp("selfmask_assets")
    torch.manual_seed(5)
    oracle = TorchSelfMask(dim=64, heads=1, depth=1, patch=8, grid=4,
                           n_queries=4, dec_layers=1)
    path = assets / "selfmask_nq20.pt"
    torch.save(oracle.state_dict(), path)
    jm = JaxSelfMask(n_queries=4, patch_size=8, n_decoder_layers=1,
                     embed_dim=64, heads=1, base_grid=4, depth=1)
    return assets, jm, convert_selfmask_checkpoint(
        load_torch_state_dict(str(path)))


@pytest.mark.parametrize("layout", ["flat", "imagenet"])
def test_training_generates_the_missing_pseudo_masks(fixture, selfmask_assets,
                                                      tmp_path, layout):
    """With no pseudo-mask on disk, the training CLI makes every one from
    the assets' SelfMask checkpoint, then trains; the files equal the JAX
    `generate_pseudo_masks` on the same checkpoint (a SelfMask near-tie
    reported as in tests/test_torch_pseudo_masks.py); a second run finds
    them and leaves them untouched."""
    from test_torch_pseudo_masks import _assert_files_equal
    from zutis_tpu.data.pseudo_masks import generate_pseudo_masks
    from zutis_tpu_torch.data.imagenet_index import imagenet_pseudo_mask_path
    from zutis_tpu_torch.data.pseudo_masks import pseudo_mask_path
    from zutis_tpu_torch.models.weights import load_selfmask

    assets, jm, params = selfmask_assets
    root, (categories, _, dir_train, _, _) = fixture
    sources = sorted(dir_train.glob("*.jpg"))
    cat_fp = tmp_path / "index" / "category_to_p_images.json"
    cat_fp.parent.mkdir()
    if layout == "flat":
        images = [str(p) for p in sources]
        want_paths = {p: pseudo_mask_path(str(cat_fp.parent / "pseudo_masks"),
                                          p) for p in images}
        overrides = {}
    else:
        dir_in = tmp_path / "ImageNet2012"
        images = []
        for i, src in enumerate(sources):
            wnid = f"n0000000{i % 2}"
            dst = dir_in / "train" / wnid / f"{wnid}_{i}.JPEG"
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(src, dst)
            images.append(str(dst))
        want_paths = {p: imagenet_pseudo_mask_path(str(dir_in), p)
                      for p in images}
        overrides = dict(index_dataset_name="imagenet",
                         dir_train_dataset=[str(dir_in)])
    cat_fp.write_text(json.dumps({"square": images[::2],
                                  "blob": images[1::2]}))
    _, cfg_fp = _cfg(fixture, f"gen_{layout}", n_iters=1, iter_eval=1,
                     category_to_p_images_fp=str(cat_fp),
                     clip_assets_dir=str(assets), **overrides)
    port_main.main(["--p_config", cfg_fp, "--device", "cpu"])
    assert "final_model.npz" in os.listdir(
        _run_dir(root / f"ckpt_gen_{layout}"))
    assert all(os.path.exists(p) for p in want_paths.values())

    jax_paths = {p: str(tmp_path / "jax" / os.path.relpath(pm, tmp_path))
                 for p, pm in want_paths.items()}
    want = generate_pseudo_masks(images, "", params, model=jm,
                                 path_map=jax_paths)
    ours = load_selfmask(str(assets / "selfmask_nq20.pt"), device="cpu")
    _assert_files_equal((jm, params, ours), images, want, want_paths, 512)

    # the files are found again, not rewritten
    stamps = {p: os.stat(p).st_mtime_ns for p in want_paths.values()}
    port_main.build_index_dataset(Config.load(cfg_fp), 0, "cpu")
    assert {p: os.stat(p).st_mtime_ns for p in want_paths.values()} == stamps


def test_mesh_axes_of_one_device_train(fixture):
    _, cfg_fp = _cfg(fixture, "mesh1", mesh_axes={"data": 1, "model": 1},
                     n_iters=1, iter_eval=1)
    port_main.main(["--p_config", cfg_fp, "--device", "cpu"])
    assert "final_model.npz" in os.listdir(
        _run_dir(fixture[0] / "ckpt_mesh1"))


@pytest.mark.parametrize("name,want", [("highest", "highest"),
                                       ("float32", "highest"),
                                       ("high", "high"),
                                       ("default", "medium")])
def test_matmul_precision_extra(fixture, tmp_path, name, want):
    cfg, _ = _cfg(fixture, "prec", matmul_precision=name)
    fp = dump_cfg(cfg, tmp_path / "prec.yaml")
    before = torch.get_float32_matmul_precision()
    try:
        port_main.set_matmul_precision(Config.load(fp))
        assert torch.get_float32_matmul_precision() == want
    finally:
        torch.set_float32_matmul_precision(before)


def test_yaml_of_the_fixture_reads_the_same_in_both_configs(fixture):
    cfg, fp = _cfg(fixture, "yaml")
    with open(fp) as f:
        assert yaml.safe_load(f) == cfg
    assert Config.load(fp).extras["model_kwargs"] == cfg["model_kwargs"]
