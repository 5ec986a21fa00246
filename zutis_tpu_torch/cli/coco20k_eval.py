"""COCO-20K instance-segmentation evaluation entry point (the port of
zutis_tpu/cli/coco20k_eval.py).

  python -m zutis_tpu_torch.cli.coco20k_eval --p_config <cfg>.yaml \
      --p_state_dict <final_model.npz> --dir_dataset <coco20k> \
      [--batch_images 16] [--pipeline_depth 2] [--device cuda]

Loads a trained ZUTIS, predicts instances (threshold -> classify -> NMS)
over the images of `annotations/instances_<eval_split>.json` at native
resolution, scores them with COCO mask AP/AR (maxDets 1/10/100) and writes
`<dir_ckpt>/coco20k/<arch>/coco20k_metrics_<arch>_nms_<type>[_suffix].json`
with the JAX CLI's keys. `--batch_images N > 1` runs the bucketed batched
path (`engine.batched_eval.evaluate_instances`: images padded into
resolution buckets, `--pipeline_depth` batches in flight, raw uint8 images
shipped and normalised on the card); `--batch_images 1` runs each image
through the dense forward, the reference's per-image regime, and so do the
RN and DINO models at any `--batch_images` (they have no padded path; the
JAX CLI sends the RN family per image and, by a fault, the DINO arm to the
batched path, where `ZUTIS.forward_padded` refuses it).
`--visualise_first > 0` raises: the overlays need the JAX package's
matplotlib visualiser.
"""
from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser("zutis-tpu-torch coco20k eval")
    parser.add_argument("--p_config", type=str, required=True)
    parser.add_argument("--p_state_dict", type=str, required=True)
    parser.add_argument("--dir_dataset", type=str, required=True)
    parser.add_argument("--dir_ckpt", type=str, default="ckpt")
    parser.add_argument("--eval_split", type=str, default="train2014_sel20k")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--nms_type", type=str, default="hard")
    parser.add_argument("--suffix", type=str, default="")
    parser.add_argument("--max_images", type=int, default=None)
    parser.add_argument("--batch_images", type=int, default=16)
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="batches in flight in the batched path: depth "
                             "> 1 overlaps a batch's fetch and host COCO "
                             "assembly with the next batch's loading and "
                             "device work; 1 = synchronous")
    parser.add_argument("--visualise_first", type=int, default=0,
                        help="not supported by the port (raises if > 0)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.visualise_first > 0:
        raise NotImplementedError(
            "--visualise_first: the instance overlays need matplotlib, "
            "which the port does not use")

    import numpy as np
    import torch

    from zutis_tpu_torch.cli.main import (
        build_model,
        build_text_embeddings,
        set_matmul_precision,
    )
    from zutis_tpu_torch.core.checkpoint import load_params_any
    from zutis_tpu_torch.core.config import Config
    from zutis_tpu_torch.core.device import resolve_device, to_device
    from zutis_tpu_torch.data.coco_api import COCOIndex
    from zutis_tpu_torch.data.image_io import read_rgb
    from zutis_tpu_torch.data.label_maps import new_label_id_to_old_label_id
    from zutis_tpu_torch.data.transforms import normalize_image
    from zutis_tpu_torch.engine import batched_eval as BE
    from zutis_tpu_torch.engine.coco_eval import COCOEvaluator
    from zutis_tpu_torch.postproc.instance import (
        instances_to_coco_counts,
        predict_instances_device,
    )

    device = resolve_device(args.device)
    cfg = Config.load(args.p_config)
    set_matmul_precision(cfg)
    arch_tag = cfg.clip_arch.lower().replace("-", "_").replace("/", "_")
    dir_ckpt = f"{args.dir_ckpt}/coco20k/{arch_tag}"
    os.makedirs(dir_ckpt, exist_ok=True)

    p_gt = f"{args.dir_dataset}/annotations/instances_{args.eval_split}.json"
    coco = COCOIndex(p_gt)
    image_ids = coco.get_img_ids()
    if args.max_images:
        image_ids = image_ids[:args.max_images]

    model = build_model(cfg, device, init=False)
    model.load_state_dict(load_params_any(args.p_state_dict), strict=True)
    text_embeddings = build_text_embeddings(cfg, device)

    def load_image_u8(image_id):
        """Raw [3, H, W] uint8: the batched path ships these to the card and
        normalises there (a quarter of the f32 transfer)."""
        info = coco.load_img(image_id)
        arr = read_rgb(f"{args.dir_dataset}/train2014/{info['file_name']}")
        return np.ascontiguousarray(arr.transpose(2, 0, 1))

    t0 = time.time()
    if args.batch_images > 1 and model.encoder_family == "vit":
        # images load lazily, inside the pipelined loop, so batch N + 1's
        # decode overlaps batch N's device work
        predictions = BE.evaluate_instances(
            model, text_embeddings, (load_image_u8(i) for i in image_ids),
            image_ids, label_map=new_label_id_to_old_label_id,
            batch_images=args.batch_images, depth=args.pipeline_depth,
            threshold=args.threshold, nms_type=args.nms_type, device=device)
    else:
        text = to_device(torch.from_numpy(text_embeddings), device)
        predictions = []
        for image_id in image_ids:
            img = load_image_u8(image_id)
            image = to_device(torch.from_numpy(
                normalize_image(img.transpose(1, 2, 0)))[None], device)
            H, W = img.shape[-2:]
            with torch.inference_mode():
                out = model(image, inference=True)
                res = predict_instances_device(
                    out["mask_proposals"], out["patch_tokens"], text,
                    size=(int(H), int(W)), threshold=args.threshold,
                    nms_type=args.nms_type, rle=True)
            predictions.extend(instances_to_coco_counts(
                BE.fetch_to_host(res).result(), image_ids=[image_id],
                sizes=[(int(H), int(W))],
                new_label_id_to_old_label_id=new_label_id_to_old_label_id,
                dev_masks=BE.SideStreamView(res["masks"])))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    eval_seconds = time.time() - t0

    with open(p_gt) as f:
        gt = json.load(f)
    stats = COCOEvaluator(gt).evaluate(predictions)
    # reference metric key layout (coco20k_eval.py:296-311)
    result = {
        "AP": stats["AP"], "AP_50": stats["AP50"], "AP_75": stats["AP75"],
        "AP_small": stats["AP_small"], "AP_medium": stats["AP_medium"],
        "AP_large": stats["AP_large"],
        "AR_1": stats["AR_maxDets_1"], "AR_10": stats["AR_maxDets_10"],
        "AR_100": stats["AR_maxDets_100"],
        "AR_small": stats["AR_small"], "AR_medium": stats["AR_medium"],
        "AR_large": stats["AR_large"],
        "eval_images_per_sec": (
            len(image_ids) / eval_seconds if eval_seconds > 0 else 0.0
        ),
        # the JAX CLI's keys for its per-bucket compiles: the port builds
        # its kernels once per process, not per bucket, and compiles nothing
        # per shape
        "compile_seconds": 0.0,
        "eval_images_per_sec_warm": (
            len(image_ids) / eval_seconds if eval_seconds > 0.5 else None
        ),
    }
    suffix = f"_{args.suffix}" if args.suffix else ""
    fp = (f"{dir_ckpt}/coco20k_metrics_{arch_tag}"
          f"_nms_{args.nms_type}{suffix}.json")
    with open(fp, "w") as f:
        json.dump(result, f)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
