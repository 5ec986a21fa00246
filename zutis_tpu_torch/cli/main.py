"""Train/eval entry point (the port of zutis_tpu/cli/main.py).

  python -m zutis_tpu_torch.cli.main --p_config configs/<cfg>.yaml \
      [--p_state_dict weights.{npz,pt}] [--debug] [--seed N] \
      [--weight_ce_loss W] [--suffix S] [--device cuda]

With --p_state_dict: evaluate on the config's validation dataset. Without:
train on the index dataset (retrieved images + pseudo-masks + copy-paste
synthesis) with periodic evaluation, as the JAX CLI does, on one card. The
checkpoint directory, `config.json`, the artifacts and the resume from the
newest full-state checkpoint (`checkpoint_every`) are the JAX CLI's.

The category text embeddings come from the `text_embeddings_npz` extra,
else from the JAX CLI's cache file (`text_emb_<arch>_<n>cat_<hash>.npz` in
`clip_assets_dir`), else from the config's CLIP text tower
(`<clip_assets_dir>/<arch>.pt` and the BPE merges file), which writes that
cache file.

Missing pseudo-masks are generated before training, as the JAX CLI does:
SelfMask from `<clip_assets_dir>/selfmask_nq20.pt` and the bilateral solver,
on the training device (`data/pseudo_masks.py`), into the flat
`<dir of category_to_p_images_fp>/pseudo_masks/<stem>.json` layout or
ImageNet's per-wnid one; without that checkpoint the CLI raises.

Every `clip_arch` the JAX CLI builds is built here (the ViTs, the RN archs
and `dilatedRN*`), and `encoder_type: dino` (the DINO ViT-B/16 arm). The
pretrained CLIP visual tower (ViT or RN) loads from `<clip_assets_dir>/<arch>.pt`
unless the `skip_pretrained` extra is set.

What the port does not do, and raises on:
  - `encoder_type: dino` without `skip_pretrained`: the JAX CLI puts the
    CLIP visual tree into the DINO arm's DeiT encoder there
    (zutis_tpu/cli/main.py:262-268), which cannot load; the DINO encoder's
    own weights go in through `models.factory.load_dino_encoder`;
  - `mesh_axes` over more than one device: the parallel layer is item 6;
  - `visualise`: the JAX CLI defaults it to True and renders figures with
    matplotlib, which the port does not use; here it defaults to False and
    a config that sets it raises.
The `matmul_precision` extra ("highest", "high", "default", and JAX's
other names) sets `torch.set_float32_matmul_precision` for the process:
"highest" keeps float32 matrix products in full float32 (TF32 off, the
port's default), "high" allows TF32, "default" allows bf16 passes. It acts
on float32 products only; a bfloat16 `compute_dtype` is unaffected.
"""
from __future__ import annotations

import hashlib
import json
import os
from argparse import ArgumentParser

import numpy as np

# JAX's precision names -> torch.set_float32_matmul_precision's
MATMUL_PRECISION = {"highest": "highest", "float32": "highest",
                    "high": "high", "tensorfloat32": "high",
                    "bfloat16_3x": "high", "default": "medium",
                    "bfloat16": "medium", "fastest": "medium"}


def set_matmul_precision(cfg) -> None:
    name = cfg.extras.get("matmul_precision")
    if not name:
        return
    import torch

    if name not in MATMUL_PRECISION:
        raise ValueError(f"matmul_precision {name!r} not in "
                         f"{sorted(MATMUL_PRECISION)}")
    torch.set_float32_matmul_precision(MATMUL_PRECISION[name])


def text_embeddings_cache_path(cfg) -> str:
    """The JAX CLI's cache file for the config's category list."""
    cat_hash = hashlib.sha1(
        "\x00".join(cfg.categories).encode()).hexdigest()[:10]
    return os.path.join(
        cfg.clip_assets_dir or ".",
        f"text_emb_{cfg.clip_arch.replace('/', '_')}_"
        f"{len(cfg.categories)}cat_{cat_hash}.npz")


def build_text_embeddings(cfg, device="cuda") -> np.ndarray:
    """Plain (template-free) per-category CLIP text embeddings for the ZUTIS
    head [n_categories, text_dim] float32 (reference networks/zutis.py:35-38):
    from the `text_embeddings_npz` extra ("embeddings"), else from the JAX
    CLI's cache file when it holds this category list, else computed by the
    config's CLIP text tower on `device` and written to that cache file."""
    override = cfg.extras.get("text_embeddings_npz")
    if override:
        with np.load(override) as f:
            return np.asarray(f["embeddings"], np.float32)
    cache_fp = text_embeddings_cache_path(cfg)
    if os.path.exists(cache_fp):
        with np.load(cache_fp, allow_pickle=True) as f:
            if list(f["categories"]) == list(cfg.categories):
                return np.asarray(f["embeddings"], np.float32)

    from zutis_tpu_torch.data.tokenizer import CLIPTokenizer
    from zutis_tpu_torch.models.factory import (
        build_text_encoder,
        clip_checkpoint_path,
        find_merges_file,
        load_clip_text,
    )
    from zutis_tpu_torch.retrieval.text_embeddings import (
        plain_category_embeddings,
    )

    merges = find_merges_file(cfg.clip_assets_dir)
    if not merges:
        raise FileNotFoundError(
            f"BPE merges file not found under {cfg.clip_assets_dir!r}; place "
            f"bpe_simple_vocab_16e6.txt.gz there (see models/factory.py)")
    tokenizer = CLIPTokenizer.from_file(merges)
    encoder = build_text_encoder(cfg.clip_arch, device=device)
    encoder.load_state_dict(load_clip_text(clip_checkpoint_path(
        cfg.clip_arch, cfg.clip_assets_dir)), strict=True)
    emb = plain_category_embeddings(encoder, tokenizer, cfg.categories)
    try:
        np.savez(cache_fp, embeddings=emb,
                 categories=np.array(cfg.categories, dtype=object))
    except OSError:
        pass  # a read-only assets directory: the embeddings stand uncached
    return emb


def build_model(cfg, device, seed: int = 0, init: bool = True):
    """The config's ZUTIS on `device`, with seeded random parameters if
    `init` (the `model_kwargs` extra builds an explicit architecture)."""
    import torch

    from zutis_tpu_torch.models.factory import build_zutis
    from zutis_tpu_torch.models.zutis import ZUTIS

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model_kwargs = cfg.extras.get("model_kwargs")
    if model_kwargs:
        # explicit architecture override (tiny models in tests)
        model = ZUTIS(stop_gradient=cfg.stop_gradient, dtype=dtype,
                      device=device, **model_kwargs)
    else:
        model = build_zutis(cfg.clip_arch, stop_gradient=cfg.stop_gradient,
                            dtype=dtype, encoder_type=cfg.encoder_type,
                            tome_r=int(cfg.extras.get("tome_r", 0)),
                            decoder_pool=int(cfg.extras.get("decoder_pool", 1)),
                            device=device)
    if init:
        model.init_params(torch.Generator().manual_seed(seed))
    return model


def check_single_device(cfg) -> None:
    n_mesh = 1
    for size in (cfg.mesh_axes or {}).values():
        n_mesh *= int(size)
    if n_mesh > 1:
        raise NotImplementedError(
            f"mesh_axes {cfg.mesh_axes} spans {n_mesh} devices: the parallel "
            "layer is not ported yet (ROADMAP.md, queue 1, item 6); drop "
            "mesh_axes to train on one card")


def check_pretrained(cfg) -> None:
    """Refuse the DINO arm with a CLIP visual tower to load into it."""
    if cfg.encoder_type == "dino" and not cfg.extras.get("skip_pretrained"):
        raise ValueError(
            "encoder_type 'dino' needs the skip_pretrained extra: the "
            "pretrained CLIP visual tower of clip_arch cannot load into the "
            "DINO arm's DeiT encoder (the JAX CLI tries, "
            "zutis_tpu/cli/main.py:262-268); load DINO weights with "
            "zutis_tpu_torch.models.factory.load_dino_encoder")


def ensure_pseudo_masks(cfg, missing, dir_pseudo: str, path_map=None,
                        device="cuda") -> None:
    """Generate the missing pseudo-masks with SelfMask and the bilateral
    solver on `device`, from `<clip_assets_dir>/selfmask_nq20.pt` (the
    reference's checkpoint layout); raise if that file is missing."""
    if not missing:
        return
    import torch

    from zutis_tpu_torch.data.pseudo_masks import generate_pseudo_masks
    from zutis_tpu_torch.models.weights import load_selfmask

    p_selfmask = os.path.join(cfg.clip_assets_dir or ".", "selfmask_nq20.pt")
    if not os.path.exists(p_selfmask):
        raise FileNotFoundError(
            f"{len(missing)} pseudo-masks missing and no SelfMask weights at "
            f"{p_selfmask}")
    selfmask = load_selfmask(p_selfmask, device=device)
    generate_pseudo_masks(missing, dir_pseudo, selfmask, path_map=path_map,
                          device=device)
    del selfmask
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the training run has the card to itself


def build_index_dataset(cfg, seed: int, device="cuda"):
    """The config's index dataset; its missing pseudo-masks are made first
    on `device`."""
    from zutis_tpu_torch.data.index_dataset import (
        IndexDataset,
        load_category_to_p_images,
    )
    from zutis_tpu_torch.data.pseudo_masks import pseudo_mask_path

    if cfg.index_dataset_name == "imagenet":
        from zutis_tpu_torch.data.imagenet_index import ImageNet1KDataset

        dataset = ImageNet1KDataset(
            dir_dataset=cfg.dir_train_dataset[0],
            categories=cfg.categories,
            ignore_index=cfg.ignore_index,
            category_to_p_images_fp=cfg.category_to_p_images_fp,
            n_images=cfg.n_images,
            image_size=cfg.train_image_size,
            use_advanced_copy_paste=cfg.use_advanced_copy_paste,
            seed=seed,
        )
        ensure_pseudo_masks(cfg, dataset.missing_pseudo_masks(), "",
                            path_map=dataset.p_image_to_p_pseudo_mask,
                            device=device)
        return dataset
    category_to_p_images = load_category_to_p_images(
        cfg.category_to_p_images_fp)
    dir_pseudo = os.path.join(
        os.path.dirname(cfg.category_to_p_images_fp) or ".", "pseudo_masks")
    all_images = [p for ps in category_to_p_images.values() for p in ps]
    p_image_to_p_pseudo_mask = {
        p: pseudo_mask_path(dir_pseudo, p) for p in all_images}
    ensure_pseudo_masks(cfg, [p for p, pm in p_image_to_p_pseudo_mask.items()
                              if not os.path.exists(pm)], dir_pseudo,
                        device=device)
    return IndexDataset(
        categories=cfg.categories,
        category_to_p_images=category_to_p_images,
        p_image_to_p_pseudo_mask=p_image_to_p_pseudo_mask,
        image_size=cfg.train_image_size,
        ignore_index=cfg.ignore_index,
        scale_range=cfg.scale_range,
        random_duplicate=cfg.random_duplicate,
        seed=seed,
        use_advanced_copy_paste=cfg.use_advanced_copy_paste,
    )


def main(argv=None):
    parser = ArgumentParser("zutis-tpu-torch")
    parser.add_argument("--p_config", type=str, required=True)
    parser.add_argument("--p_state_dict", type=str, default="")
    parser.add_argument("--debug", "-d", action="store_true")
    parser.add_argument("--seed", "-s", default=0, type=int)
    parser.add_argument("--weight_ce_loss", type=float, default=1.0)
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--max_eval_images", type=int, default=None)
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of train steps "
                             "10-20 here")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from zutis_tpu_torch.core.checkpoint import (
        latest_step_dir,
        load_params_any,
        restore_train_state,
    )
    from zutis_tpu_torch.core.config import Config, checkpoint_dir
    from zutis_tpu_torch.core.device import resolve_device
    from zutis_tpu_torch.data.datasets import get_eval_dataset
    from zutis_tpu_torch.data.index_dataset import batch_iterator
    from zutis_tpu_torch.engine.train_step import TrainState
    from zutis_tpu_torch.engine.trainer import Trainer
    from zutis_tpu_torch.models.factory import (
        clip_checkpoint_path,
        load_clip_visual,
    )

    device = resolve_device(args.device)
    cfg = Config.load(
        args.p_config, p_state_dict=args.p_state_dict, debug=args.debug,
        seed=args.seed, weight_ce_loss=args.weight_ce_loss,
        suffix=args.suffix,
    )
    if cfg.extras.get("visualise"):
        raise NotImplementedError(
            "visualise: the JAX CLI's figures need matplotlib, which the "
            "port does not use; drop the key")
    dir_ckpt = checkpoint_dir(cfg)
    if (os.path.exists(f"{dir_ckpt}/final_model.npz")
            and not args.p_state_dict):
        print(f"final model already exists at {dir_ckpt}/final_model.npz")
        return
    os.makedirs(dir_ckpt, exist_ok=True)
    cfg.to_json(f"{dir_ckpt}/config.json")
    set_matmul_precision(cfg)

    model = build_model(cfg, device, seed=args.seed,
                        init=not args.p_state_dict)
    text_embeddings = build_text_embeddings(cfg, device)
    val_dataset = get_eval_dataset(
        cfg.dataset_name, cfg.dir_val_dataset, split=cfg.split,
        n_categories=cfg.n_categories
        if cfg.dataset_name == "imagenet-s" else None,
    )
    trainer = Trainer(model, text_embeddings, dir_ckpt=dir_ckpt,
                      debug=args.debug, device=device)

    if args.p_state_dict:
        model.load_state_dict(load_params_any(args.p_state_dict), strict=True)
        scores = trainer.evaluate(model, val_dataset, num_iter=0,
                                  max_images=args.max_eval_images)
        print(json.dumps(scores, indent=2))
        return scores

    # ---- training path ----
    check_single_device(cfg)
    check_pretrained(cfg)
    dataset = build_index_dataset(cfg, args.seed, device)
    batch_size = cfg.train_dataloader_kwargs.get("batch_size", 8)
    if not cfg.extras.get("skip_pretrained"):
        load_clip_visual(model, clip_checkpoint_path(cfg.clip_arch,
                                                     cfg.clip_assets_dir))
    # reference base lr 5e-5 (utils/utils.py:179-192); test/diagnosis
    # configs may override through the extras
    state = TrainState.create(model,
                              base_lr=float(cfg.extras.get("base_lr", 5e-5)),
                              n_iters=cfg.n_iters)
    # preemption resume: restore the newest full-state checkpoint and
    # fast-forward the deterministic (seed, step) batch pipeline to it
    ckpt_base = os.path.join(dir_ckpt, "checkpoints")
    resume_dir = latest_step_dir(ckpt_base)
    if resume_dir is not None:
        restore_train_state(resume_dir, state)
        print(f"resumed train state from {resume_dir} (step {state.step})")
    batches = batch_iterator(dataset, batch_size, seed=args.seed,
                             start_step=state.step, device=device)
    try:
        trainer.fit(
            state, batches, n_iters=cfg.n_iters,
            n_categories=val_dataset.n_categories,
            ignore_index=cfg.ignore_index,
            weight_ce_loss=args.weight_ce_loss,
            iter_eval=cfg.iter_eval, iter_log=cfg.iter_log,
            val_dataset=val_dataset,
            checkpoint_every=cfg.checkpoint_every or None,
            checkpoint_dir=ckpt_base,
            profile_dir=args.profile_dir or None,
        )
    finally:
        batches.close()  # stops the producer thread
    return state


if __name__ == "__main__":
    main()
