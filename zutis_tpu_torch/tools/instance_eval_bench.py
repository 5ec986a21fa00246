"""Throughput of the bucketed instance eval (the port of
tools/instance_eval_bench.py).

    python -m zutis_tpu_torch.tools.instance_eval_bench [--batch 32]
        [--path counts|packed|dense] [--iters 12] [--depth 1] [--device cuda]
        [--tome_r 0] [--decoder_pool 1]

ZUTIS ViT-B/16 (seeded random weights, bf16 matrices), 81 unit-norm random
text embeddings, one batch of images at the JAX bench's native sizes
(480 + 8 (i % 5), 640 - 16 (i % 3)) padded into the 512 x 640 bucket, put
on the device once. Each iteration runs the instance step (forward_padded,
decode, NMS, device RLE; no semantic map) and assembles the batch's COCO
list on the host:
  counts  the device RLE, and the dense mask of any cap overflow;
  packed  the masks packed to bits on the device, unpacked on the host;
  dense   the whole [B, Q, H, W] masks, encoded mask by mask on the host.
--depth > 1 keeps that many batches in flight (batched_eval.pipelined), so
that the host assembles batch N while the device runs N + 1. Prints one
JSON record: the best of three windows of --iters batches, in img/s, with
the device it ran on. --tome_r and --decoder_pool set the opt-in levers
(the JAX tool's lever values are --tome_r 90 --decoder_pool 2: the bucket's
1281 tokens end at 201 after 12 blocks, and the decoder's cross-attention
reads 1280 pooled keys for 5120). `run` takes a smaller model and bucket,
which is how the CPU test drives it.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from zutis_tpu_torch.core.device import resolve_device, to_device
from zutis_tpu_torch.data.label_maps import new_label_id_to_old_label_id
from zutis_tpu_torch.engine import batched_eval as BE
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.postproc.instance import (
    col_stride_bits,
    instances_to_coco,
    instances_to_coco_counts,
    instances_to_coco_packed,
    pack_masks_fortran,
)

VIT_B16 = dict(width=768, encoder_layers=12, encoder_heads=12, patch_size=16,
               text_dim=512, input_resolution=224, n_queries=100,
               n_decoder_layers=6, n_heads=8)
SHAPE = (512, 640)
N_CATEGORIES = 81  # COCO's width
PATHS = ("counts", "packed", "dense")


def build_model(cfg: dict, device, dtype=torch.bfloat16, tome_r: int = 0,
                decoder_pool: int = 1) -> ZUTIS:
    """Seeded random ZUTIS on `device` with the given levers; matrices in
    `dtype` and 1-D parameters in f32, as the JAX bench casts its weights."""
    model = ZUTIS(**cfg, dtype=dtype, tome_r=tome_r,
                  decoder_pool=decoder_pool, device=device)
    model.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.data = p.data.to(dtype)
    return model.eval()


def bench_sizes(batch: int, shape=SHAPE):
    """The JAX bench's native sizes, relative to the bucket's bottom right."""
    H, W = shape
    return [(H - 32 + 8 * (i % 5), W - 16 * (i % 3)) for i in range(batch)]


def text_embeddings(n: int, dim: int, seed: int = 0) -> np.ndarray:
    text = np.random.RandomState(seed).randn(n, dim).astype(np.float32)
    return text / np.linalg.norm(text, axis=1, keepdims=True)


def run(batch: int = 32, path: str = "counts", iters: int = 12,
        depth: int = 1, device="cuda", cfg: dict = VIT_B16, shape=SHAPE,
        n_categories: int = N_CATEGORIES, windows: int = 3,
        model: Optional[ZUTIS] = None, threshold: float = 0.5,
        tome_r: int = 0, decoder_pool: int = 1) -> dict:
    """Time the bucketed instance eval; prints and returns the record. The
    levers build the model unless `model` is given."""
    if path not in PATHS:
        raise ValueError(f"path {path!r} not in {PATHS}")
    device = resolve_device(device)
    if model is None:
        model = build_model(cfg, device, tome_r=tome_r,
                            decoder_pool=decoder_pool)
    text = text_embeddings(n_categories, model.encoder.proj.shape[1])
    step = BE.make_instance_step(model, text, shape, threshold=threshold,
                                 semantic_mode="none", device=device)
    sizes = bench_sizes(batch, shape)
    rng = np.random.RandomState(0)
    images = [rng.randn(3, h, w).astype(np.float32) * 0.1 for h, w in sizes]
    padded, grid, pix = BE.pad_batch(images, shape, batch,
                                     model.encoder.patch_size)
    padded_d = to_device(torch.from_numpy(padded), device)
    ids = list(range(batch))
    label_map = new_label_id_to_old_label_id  # COCO's ids, as the CLI's
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def dispatch(_=None):
        res = step(padded_d, grid, pix)
        if path == "counts":
            return res, BE.fetch_to_host(res, stream)
        keys = ("scores", "category_ids", "keep")
        small = {k: res[k] for k in keys}
        if path == "packed":
            small["masks_packed"] = pack_masks_fortran(res["masks"])
        else:
            small["masks"] = res["masks"]
        return res, BE.HostFetch(small, stream)

    def collect(handles, _=None):
        res, fetch = handles
        host = fetch.result()
        if path == "counts":
            return instances_to_coco_counts(
                host, ids, sizes, new_label_id_to_old_label_id=label_map,
                dev_masks=BE.SideStreamView(res["masks"], stream))
        if path == "packed":
            host["col_stride_bits"] = col_stride_bits(shape[0])
            return instances_to_coco_packed(
                host, ids, sizes, new_label_id_to_old_label_id=label_map)
        preds = []
        for j, (h, w) in enumerate(sizes):
            preds.extend(instances_to_coco(
                {"masks": host["masks"][j:j + 1, :, :h, :w],
                 **{k: host[k][j:j + 1] for k in ("scores", "category_ids",
                                                  "keep")}},
                image_ids=[j], new_label_id_to_old_label_id=label_map))
        return preds

    first = dispatch()
    n_preds = len(collect(first))
    rle = {k: v.cpu().numpy() for k, v in first[0]["rle"].items()}
    n_fallbacks = int((rle["overflow"] & rle["valid"]).sum()
                      + np.maximum(rle["n_kept"] - rle["valid"].shape[1], 0).sum())
    del first
    for _ in BE.pipelined(dispatch, collect, range(2), depth=depth):  # warm
        pass
    best = 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in BE.pipelined(dispatch, collect, range(iters), depth=depth):
            pass
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = max(best, batch * iters / (time.perf_counter() - t0))
    record = {
        "metric": "instance_eval_images_per_sec",
        "value": best,
        "batch": batch,
        "bucket": list(shape),
        "path": path,
        "depth": depth,
        "tome_r": model.tome_r,
        "decoder_pool": model.decoder_pool,
        "n_preds_per_batch": n_preds,
        "n_cap_fallbacks": n_fallbacks,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    print(json.dumps(record), flush=True)
    return record


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--path", choices=PATHS, default="counts")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--depth", type=int, default=1,
                    help="batches in flight: > 1 overlaps the host's COCO "
                         "assembly of batch N with the device's batch N + 1")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tome_r", type=int, default=0,
                    help="opt-in token merging: up to r tokens a block, "
                         "padding first at zero weight (ops/tome.py)")
    ap.add_argument("--decoder_pool", type=int, default=1,
                    help="opt-in decoder-memory pooling: the cross-attention "
                         "reads p x p cells, validity-weighted with a "
                         "log(count) key bias")
    args = ap.parse_args(argv)
    run(args.batch, args.path, args.iters, args.depth, args.device,
        tome_r=args.tome_r, decoder_pool=args.decoder_pool)


if __name__ == "__main__":
    main()
