"""Smoke run of the PyTorch/CUDA port (zutis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, `nvcc`, `g++`
and PyTorch built for CUDA. It imports torch, numpy and zutis_tpu_torch, and
scipy for the matcher's host yardstick (`linear_sum_assignment`).

  1. Card and build: requires CUDA, prints the card's name and power limit,
     builds the flash-attention, attention-probe and matcher kernels from
     zutis_tpu_torch/csrc with nvcc for sm_90a and the host libraries of
     zutis_tpu_torch/native (RLE codec, image library, hole fill and
     labelling) with g++ (one compiler per source, started together), prints ptxas's registers and spills, fails if ptxas
     serialised any kernel's wgmma, and turns TF32 off for matmuls and cuDNN.
  2. Flash kernels against their plain version on the card, at the three
     attention shapes of the serving path (batch 8, bf16), also as strided
     [b, s, h, d] views as the model passes them, ragged cases and kv_mask
     cases with an all-masked item, and f32 inputs (d 96 under a mask, keys
     past the edge, SelfMask's cross-attention split into key ranges and
     held to the same call on one range); checks that both flash kernels
     and every probe kernel were compiled to TMA loads and wgmma with no
     mma.sync or cp.async (cuobjdump, which must be in the toolkit) and that
     the mma.sync f32 kernel is gone; prints each flash kernel's shared
     memory and blocks per SM; times each main-path shape beside the plain
     version and F.scaled_dot_product_attention (a yardstick only: the port
     never calls it).
  3. Probe kernels against their plain versions on the card in bf16: every
     family, layout, sum mode, exp mode and the dots-only kt, at the tuning
     tool's shape [64,12,577,577,64], the serving encoder shape, a ragged
     shape and a d = 96 shape (fastsm and kt at block_q 128 and 64), and
     `single` also at sk 1000 (d 64) and 896 (d 96) and on strided
     [b, s, h, d] views, fastsm and kt at sk 1, 65 and 577 on strided views
     (keys past the edge); the three `single` layouts must come out bit for
     bit alike. Prints each probe kernel's shared memory and blocks per SM.
     Times each kernel at the two 577 shapes (fastsm and kt at both
     block_q) beside its plain version, its bound, SDPA and
     flash_attention.
  4. The tuning path: zutis_tpu_torch.tools.kernel_tune.run for every
     variant at the tool's shape, with every launch count set to 0 before and
     read after; each variant must print RESULT_OK, and the exact ones must
     stay within 2e-2 of an f32 softmax.
  5. Serving at full width: ZUTIS ViT-B/16 (seeded random weights, bf16
     matrices) behind InferenceServer(image_size=384, batch_size=8), 20
     requests through start/submit/stop plus one synchronous infer; checks
     the outputs, that every batch forward launched the flash kernel 24
     times and no probe kernel, the kernel path against the "torch"
     attention path, and the instance decode against a CPU rerun; reports
     the serving rate.
  6. The bucketed eval at full width (ViT-B/16, batch 32, 512 x 640 bucket,
     the JAX bench's native sizes): flash at its three shapes under the
     bench's window masks against the plain version, timed beside the bound
     of the valid keys and SDPA given the mask; the f32 padded forward
     against each image's own forward, and the instance step's keep and
     categories against predict_instances_device; 64 images through
     evaluate_instances with every launch count set to 0 before and read
     after (24 flash launches per padded forward, 18 masked, no probe); one
     batch's decode on the card against its CPU rerun, bit for bit down to
     the COCO list and its stats; one dispatch with no host-device
     synchronisation; the step's spans, device busy and peak memory, and
     the eval tool's img/s at depth 1 and 2; one batch's host COCO
     assembly on the numpy codec and on the C++ one (median of 5 each, in
     turns, equal byte for byte), and the COCO strings alone both ways.

  7. The training step at full width (bench.py:174-201: ViT-B/16, 384 px,
     batch 8, n_max 10 with 4 valid, 919 classes, bf16 compute with f32
     parameters, AdamW + PolyLR at 5e-5 over 80,000 iterations): a warm-up
     step and 10 timed ones with every launch count set to 0 before and
     read per step (24 flash launches and one matcher launch each, no
     probe); finite losses that fall after the first update and end below
     the first; bench.py:207-213's rate (10 steps queued back to back, one
     synchronise); one step's dispatch from host arrays (pinned uploads)
     with no host-device synchronisation;
     the flash Function's dQ, dK, dV against autograd through the plain
     version at the three shapes in bf16 and f32; one f32 step on the
     kernel path and on the "torch" attention path (matchings equal up to
     near-ties of their costs, then on one matching the loss and every
     parameter's gradient); the matcher kernel bit-equal to its plain version on the
     step's own costs and seeded sets, NaN included; the step's time,
     spans, device busy and peak memory, and the matcher's time beside its
     bound, its plain version's and scipy's.
  8. The Trainer at the shipped config
     (configs/coco2017_val_imagenet_pass_n500_vit_b_16.yaml through the
     port's Config.load: ViT-B/16, 384 px, batch 8, 81 categories,
     ignore_index 255, bf16; mesh_axes dropped here, a mesh of one in
     phase 14) over 6 iterations of seeded batches, logging with the
     figures (`visualise=True`) at 2, 4, 6 and evaluating and checkpointing
     the full state at 3 and 6 (16 in-memory coco2017 images at the eval
     bench's native sizes, COCO scoring against their box annotations),
     every launch count set to 0 before and read after (24 flash launches
     a step, a padded forward and a log point's figures, one matcher launch
     a step and a log point's matched pairs, no probe), its quiet
     iterations after the first under the sync debug mode "error"; at each
     log point the figures' launches, counted around their call (exactly
     24 flash and 1 matcher), the matcher's assignment against its plain
     version on the same costs and the host ms of the figures' forward,
     matcher, composition and write (the `visualise:` line); the
     artifacts and figures the JAX Trainer writes, each PNG decoded to its
     layout's size; a second straight run for the
     spread of the backward's atomics, and the run resumed from the step-3
     checkpoint in a fresh model held to 4 x that spread (bit-equal where
     the straight runs are); fit's iterations/s, also without the
     figures' seconds, beside phase_train's step rate, the eval's img/s,
     a checkpoint's bytes and write and restore seconds, peak memory.

  9. Retrieval at full width (`phase_retrieval`): a synthetic merges
     file of CLIP's size (48,894 merges learned from the 80 COCO names and
     the 85 templates, then padded; vocabulary 49,408, EOT 49,407) and the
     6,800 COCO prompts tokenized on the host; prompt_engineered_embeddings
     from the ViT-L/14@336px text tower (f32, 27 batches of 256, no flash
     launch: the causal mask takes the "torch" path), its first and last
     batch against a CPU rerun; plain_category_embeddings of the 81
     training categories from the ViT-B/16 tower, saved as a synthetic
     OpenAI-layout checkpoint; extract_image_embeddings at ViT-L/14@336px
     over the committed fixtures (92 images, batch 32) in f32 and bf16, 24
     flash launches a batch, f32 against the "torch" path,
     decode + preprocess per image on the host against encode per batch on
     the card, projected to ImageNet-train + PASS; flash at
     [32,16,577,577,64] f32 and bf16 against its plain version, timed
     beside SDPA and its bound; an ImageNet-layout and a PASS archive of
     fixture photos with their banks (PASS.ensure_bank), combined_retrieval
     and ImageNet1KDataset with no cache, each JSON read back equal; top-500
     at full bank size on seeded banks made on the card (80 categories over
     2,721,167 x 768, 919 over 1,281,167 x 768), ms, peak memory and both
     bounds, 4 categories of each against a CPU rerun. Every launch count
     is set to 0 before the text tower, each bank and the library path's
     banks, and read after: flash as stated, the probes and the matcher 0.
 10. Pseudo-labelling at full width (`phase_pseudo_masks`), fed by phase
     9's bank images (the five 500 x 375 photos and the 640 x 480
     fixture): a seeded SelfMask (DINO DeiT-S/8, 20 queries, 6 decoder
     layers, f32) saved as a reference-layout selfmask_nq20.pt in phase
     9's assets directory and loaded back through load_selfmask;
     generate_pseudo_masks at 512 px with every launch count set to 0
     before and read after (24 flash launches an image, nothing else),
     and again into a second directory, byte-equal; per image the
     SelfMask forward on the kernel path against the "torch" attention
     path (near-ties of the best query and of mask pixels printed with
     their margins) and the bilateral solve on the card against a CPU
     rerun on the same mask (soft output within 1e-9, masks equal); flash
     f32 at the three SelfMask shapes against its plain version, timed
     beside SDPA and its bound; per image the host's decode + resize, the
     SelfMask forward (host clock, device busy and flash's share from
     torch.profiler), the solve on the card and on the host CPU, the fill
     + labelling and the RLE, projected to the retrieved sets of the
     shipped n500 configs; peak memory.
 11. The two CLIs on images from disk (`phase_cli`), fed by phases 9 and
     10: every committed fixture image (tests/torch_fixtures) through the
     port's JPEG/PNG decoder, held to Pillow's pinned SHA-256; a
     coco2017-layout val set of 16 committed JPEGs with polygon
     annotations; `zutis_tpu_torch.cli.main.main` on the shipped config
     with the Trainer's cuts and skip_pretrained, its text embeddings
     computed from the synthetic checkpoint and merges file into the JAX
     CLI's cache file (equal to phase 9's), the pseudo-masks of every
     image combined_retrieval chose generated by the CLI from phase 10's
     checkpoint (24 flash launches an image), 6 iterations of batch 8 at
     384 px from the JPEGs, logs with the figures at 2, 4, 6, evaluations
     of the 16 val JPEGs and full checkpoints at 3 and 6, every launch
     count set to 0 before and read after (24 flash launches a step, a
     padded forward and a log point's figures, 18 of a padded forward's
     masked, one matcher launch a step and a matched-pairs figure, no
     probe) and the seconds it waited for batches, its artifacts and
     figures (matched pairs where the batch's first image has a valid
     instance, at one log point at least; each log point's launches
     counted around its call, as in phase 8, and its matcher against the
     plain version); the loader's
     IndexDataset.sample ms and batch_iterator samples/s at 1, 2 and
     os.cpu_count() threads, and a COCO2017Dataset item's ms; the same
     evaluation again with no loader thread running, and the run resumed
     from step 3 (which reads the cache and finds every pseudo-mask,
     untouched) against the straight one; `cli.coco20k_eval.main` on the
     trained final_model.npz, batched at depth 1 and 2 and per image, each
     with `--visualise_first 2` (two overlay PNGs at their images' sizes;
     24 flash launches a padded forward or an image). Prints the decode
     ms, the loader's rates, fit's iters/s beside phase_trainer's, the
     eval CLI's img/s and peak memory.

 12. The opt-in levers (`phase_levers`, run after phase 7): flash at the
     levers' calls (the serving encoder under ToMe r 16 at 577 and 401
     tokens with its log(size) bias, the pooled cross-attention's 576 keys,
     the eval encoder under ToMe r 90 at 1281 and 291 tokens and the
     padded pooled cross's 1280 keys, masked and biased) against the plain
     version in bf16 and f32, split and unsplit, timed beside the bound,
     the unbiased kernel and SDPA given the bias as a float mask; serving
     at (tome_r, decoder_pool) = (0, 1), (16, 1), (0, 2), (16, 2) with
     every launch count set to 0 before and read after (24 flash launches
     a batch forward, 12 of them biased under ToMe, no probe), the semantic
     map against the f32 forward on the kernel path's merges, the decode
     against a CPU rerun, img/s, device busy and top kernels; the eval at
     the JAX tool's (90, 2): the f32 padded forward on both attention
     paths on the same merges, evaluate_instances (18 masked and 18 biased
     launches a padded forward), img/s at depth 1; a training step at
     (16, 2) (24 flash launches, 12 biased, one matcher launch) and the f32
     step on both paths on the same merges, ReLU gates and matching.
 13. The ResNet encoders, the DINO arm and the wide decoders
     (`phase_encoders`, run after phase 12): flash's head-dim-256
     instantiation against its plain version at the RN50 decoder's shapes
     ([8,8,100,100,256] and [8,8,100,576,256], also as strided views, and a
     ragged 577-key call under a kv_mask with an all-masked item), and each
     (dtype, head dim) the factory adds (bf16 at 80, 128, 320, 384, 512;
     f32 at 80, 128, 256, 320, 384, 512) at its decoder's self- and
     cross-attention, strided, ragged under a mask and biased; the
     families' attention shapes and every new pair's decoder calls timed
     beside the plain version, SDPA and the bound; for RN50, the DINO arm
     (ViT-B/16 text dim), ViT-L/14@336px (336 px), RN50x4, RN50x16, RN50x64
     and the DINO arm at RN50x4's text dim at full width: the encoder
     written as a synthetic checkpoint of its family's published layout
     (OpenAI's CLIP archive in fp16, with BatchNorm's num_batches_tracked
     for an RN; DINO's with the fused qkv) and loaded back through
     load_clip_visual / load_dino_encoder, bit for bit; InferenceServer at
     384 px (336 for ViT-L/14@336px), batch 8, 16 requests plus one
     synchronous infer, with the flash launches a batch forward by head dim,
     the semantic map against an f32 "torch"-path forward (>= 98.5%; an arch
     at a new head dim whose own torch path falls below that on random
     weights at that path's agreement less 0.1 point), the outputs no
     further from it than the torch path's x 1.5, the decode against a CPU
     rerun, and for an arch at a new head dim its f32 forward on the kernel
     path against the torch path's (1e-3 of the largest value); img/s,
     device busy and flash's share; Trainer.evaluate in batches of one exact
     shape against per image (RN50, DINO); training steps at
     bench.py:174-201's configuration (RN50 and DINO 5 after a warm-up,
     their losses ending below the first; ViT-L/14@336px, RN50x4 and RN50x64
     2, finite; RN50x64 at 1e-6, the rate its seeded 4096-wide decoder
     survives; the frozen BatchNorm statistics bit-unchanged and its affine
     moved); dilatedRN50's batch forward (attnpool over 1 + 12 x 12 tokens,
     the cross over 144 keys, 13 launches); build_zutis("RN50") at its
     default f32 on the kernel path (13 launches) against the torch path.

 14. The parallel layer (`phase_parallel`, at the end of phase 11, on its
     fixture): this script under `python -m torch.distributed.run
     --standalone --nproc_per_node 1` (`--parallel <job.json>`: one rank,
     NCCL), with every launch count set to 0 before each part and read
     after: the training CLI on phase 11's YAML with `mesh_axes: {data: 1,
     model: 1}`, its final parameters held against phase 11's straight run
     within 4 x phase 8's spread of two runs without a mesh, its figures
     as phase 11's; the training
     step at phase 7's configuration with and without the mesh (two models
     from one seed), in turns, a warm-up and 5 steps each, the first
     losses equal to 1e-6; InferenceServer with `mesh=` (16 queued
     requests, 8 synchronous) against the server without, equal to the
     bit; `topk_sharded` against `topk_local` over phase 9's seeded 80 x
     2,721,167 x 768 bank (seeded text), indices and values equal, both
     timed; ring and Ulysses attention at [8,12,577,64] bf16 against dense
     attention (8e-3 of the largest |output|), Ulysses' one flash launch.

Prints the kernel record (flash's launches on the main paths, its eval,
retrieval, SelfMask, lever and encoder shapes; each instantiation past d 64
and 96 apart, with its launches on the encoder paths and its calls a
forward beside their bound; the matcher's) and the card on lines of their own,
then, as the last line, {"ok": true, "device": {...}}. Exits non-zero, with
no result line, on any failure or without a card.
"""
from __future__ import annotations

import contextlib
import cProfile
import dataclasses
import hashlib
import io
import json
import os
import pickle
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from zutis_tpu_torch import native
from zutis_tpu_torch.core.checkpoint import (load_params_any,
                                             restore_train_state,
                                             save_train_state)
from zutis_tpu_torch.core.config import Config
from zutis_tpu_torch.data.label_maps import new_label_id_to_old_label_id
from zutis_tpu_torch.data.image_io import read_png
from zutis_tpu_torch.engine import batched_eval as BE
from zutis_tpu_torch.engine import visualiser
from zutis_tpu_torch.engine.coco_eval import COCOEvaluator
from zutis_tpu_torch.engine.server import InferenceServer
from zutis_tpu_torch.engine.train_step import (TrainState, make_train_step,
                                               upload_batch)
from zutis_tpu_torch.engine.trainer import Trainer
from zutis_tpu_torch.losses import criterion as crit
from zutis_tpu_torch.models import vit as vit_module
from zutis_tpu_torch.models import factory
from zutis_tpu_torch.models.layers import MultiHeadAttention
from zutis_tpu_torch.models.resnet import AttentionPool2d
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.native import image as native_image
from zutis_tpu_torch.native import labels as native_labels
from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import attention_probes as ap
from zutis_tpu_torch.ops import flash_attention as fa
from zutis_tpu_torch.ops import hungarian as hg
from zutis_tpu_torch.ops import nms as nms_ops
from zutis_tpu_torch.ops import rle
from zutis_tpu_torch.ops.dynamic_shapes import token_valid_mask
from zutis_tpu_torch.ops.nms import mask_nms
from zutis_tpu_torch.postproc import instance
from zutis_tpu_torch.postproc.instance import (
    classify_proposals,
    instances_to_coco_counts,
    predict_instances_device,
)
from zutis_tpu_torch.tools import instance_eval_bench as eval_bench
from zutis_tpu_torch.tools import kernel_tune
from zutis_tpu_torch.tools.instance_eval_bench import VIT_B16, build_model
from zutis_tpu_torch.tools.kernel_tune import bound

BATCH = 8
IMAGE_SIZE = 384
N_CATEGORIES = 919
# (name, [b, h, sq, sk, d], launches per batch forward) at 384 px, batch 8
MAIN_SHAPES = [
    ("encoder self", (BATCH, 12, 577, 577, 64), 12),
    ("decoder self", (BATCH, 8, 100, 100, 96), 6),
    ("decoder cross", (BATCH, 8, 100, 2304, 96), 6),
]
LAUNCHES_PER_FORWARD = sum(n for _, _, n in MAIN_SHAPES)
MAIN_DIMS = {64: 12, 96: 12}  # those launches by head dim
PROBES = {  # kernel name -> (wrapper, plain version, TPU kernel body)
    "single_attention": (ap.single_attention, ap.single_attention_reference,
                         "tools/pallas_tune.py:54"),
    "fastsm_attention": (ap.fastsm_attention, ap.fastsm_attention_reference,
                         "tools/pallas_tune.py:173"),
    "kt_attention": (ap.kt_attention, ap.kt_attention_reference,
                     "tools/pallas_tune.py:252"),
}


class _ProbeCount:
    """A probe kernel's launches (`ap.launches` of its C entry), read and
    zeroed as a counted wrapper's `.launches`."""

    def __init__(self, entry: str):
        self.entry = entry

    @property
    def launches(self) -> int:
        return ap.launches[self.entry]

    @launches.setter
    def launches(self, n: int) -> None:
        ap.launches[self.entry] = n


PROBE_COUNTS = {name: _ProbeCount(entry) for name, entry in (
    ("single_attention", "zutis_probe_single"),
    ("fastsm_attention", "zutis_probe_fastsm"),
    ("kt_attention", "zutis_probe_kt"))}

# (kernel, label, options): every family, layout, sum mode and exp mode
PROBE_CONFIGS = (
    [("single_attention", f"single {hp}", dict(heads_per_cell=hp))
     for hp in ap.HEADS_PER_CELL]
    + [("single_attention", f"single {hp} {m}", dict(heads_per_cell=hp, exp_mode=m))
       for hp in ("unroll", "grid") for m in ("bf16", "mul")]
    + [("fastsm_attention", f"fastsm {sm}" + ("" if m == "exp" else f" {m}"),
        dict(sum_mode=sm, exp_mode=m))
       for sm in ap.SUM_MODES for m in ap.EXP_MODES]
    + [("kt_attention", "kt" + ("" if m == "exp" else f" {m}"),
        dict(exp_mode=m, dots_only=False)) for m in ap.EXP_MODES]
    + [("kt_attention", "kt dots-only", dict(exp_mode="exp", dots_only=True))]
)
PROBE_SHAPES = [
    ("tool", kernel_tune.SHAPE),
    ("encoder", (BATCH, 12, 577, 577, 64)),
    ("ragged", (2, 3, 130, 260, 64)),
    ("d96", (2, 4, 100, 300, 96)),
]
# `single` alone: more keys than a block holding V whole could take (768 at
# d 64, 512 at d 96), and q, k, v as [b, h, s, d] views of [b, s, h, d]
# tensors, whose strides go into the tensor maps
SINGLE_SHAPES = [
    ("long keys", (2, 4, 130, 1000, 64), False),
    ("long keys d96", (2, 4, 100, 896, 96), False),
    ("strided", (2, 12, 577, 577, 64), True),
]
# fastsm and kt alone: the last chunk holds 1 key and 63 that TMA fills with
# zeros (sk 1, 65, 577), q, k, v as strided [b, s, h, d] views
MAXFREE_EDGE_SHAPES = [
    ("sk 1", (2, 4, 100, 1, 64)),
    ("sk 65", (2, 4, 100, 65, 96)),
    ("sk 577", (1, 4, 130, 577, 64)),
]
PROBE_TIMED_SHAPES = ("tool", "encoder")
# kernel_tune runs of the tuning path: every variant, plus probe modes
TUNE_RUNS = ([(v, "exp", False) for v in kernel_tune.VARIANTS]
             + [("kt", "exp", True), ("single", "mul", False),
                ("fastsm-mxu", "bf16", False)])
TOL_BF16 = 2e-2  # bf16 outputs (8-bit mantissa) against the f32 plain version
# bf16 flash, relative to the largest |output|: ~2.6x the 3.1e-3 read on an
# H100 (P and the output rounded to bf16); giving the 63 zero keys past the
# edge at sk 577 weight would cost ~7%
TOL_FLASH_BF16 = 8e-3
TOL_F32 = 1e-4   # f32 inputs take hi/lo bf16 splits (~16 mantissa bits)
MIN_SEMANTIC_AGREEMENT = 0.985
SEMANTIC_SLACK = 0.002  # 0.2 points: ~37 of the 18,432 pixels of a batch
# the bucketed eval: the JAX bench's batch and bucket, two batches through
# evaluate_instances
EVAL_BATCH = 32
EVAL_SHAPE = eval_bench.SHAPE
EVAL_IMAGES = 2 * EVAL_BATCH
# (name, [b, h, sq, sk, d], launches per padded forward, its kv_mask)
EVAL_FLASH_SHAPES = [
    ("eval encoder self", (EVAL_BATCH, 12, 1281, 1281, 64), 12, "encoder"),
    ("eval decoder self", (EVAL_BATCH, 8, 100, 100, 96), 6, None),
    ("eval decoder cross", (EVAL_BATCH, 8, 100, 5120, 96), 6, "memory"),
]
EVAL_LAUNCHES = sum(n for _, _, n, _ in EVAL_FLASH_SHAPES)
EVAL_MASKED_LAUNCHES = sum(n for _, _, n, m in EVAL_FLASH_SHAPES if m)
# padded against per-image f32 forwards, relative to the largest |output|:
# the f32 kernel's hi/lo splits carry ~16 mantissa bits, and the two
# programs sum keys in different chunks
TOL_PADDED_F32 = 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def counted_wrappers() -> dict:
    """Every wrapper that counts its kernel's launches, by kernel name."""
    return {"flash_attention": fa.flash_attention,
            "batched_hungarian": hg.batched_hungarian,
            "mask_nms": mask_nms,
            "pairwise_iou": nms_ops.pairwise_iou,
            **PROBE_COUNTS}


def zero_counts() -> None:
    """Every wrapper's launch count, and flash's masked, biased and split
    counts, set to 0."""
    for w in counted_wrappers().values():
        w.launches = 0
    fa.flash_attention.masked_launches = 0
    fa.flash_attention.biased_launches = 0
    fa.flash_attention.split_launches = 0
    fa.flash_attention.launches_by_dim = {}


def read_counts() -> tuple:
    """({kernel name: launches since zero_counts}, flash's masked ones)."""
    return ({n: w.launches for n, w in counted_wrappers().items()},
            fa.flash_attention.masked_launches)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, calls: int = 20, reps: int = 21, warmup: int = 3) -> float:
    """Device ms per call of `fn`: `calls` back-to-back calls captured in a
    CUDA graph, the graph replayed `reps` times between CUDA events; the
    median replay over `calls`. The graph keeps the host's per-call Python
    overhead out of the device time. Inputs stay L2-warm."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def host_ms(fn, device: torch.device, reps: int = 10, warmup: int = 2) -> float:
    """Median host-clock time of `fn` ending in a device synchronise."""
    def synced():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    for _ in range(warmup):
        synced()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        synced()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


_LENGTH = re.compile(r"(\d+)(?=[A-Za-z_])")  # the length before a mangled name


def _kernel_name(mangled: str) -> str:
    """A kernel's name in its mangled symbol, with its integer template
    arguments: `single_kernel<64,0,1>`, `flash_wgmma_kernel<96>`. Each
    length-prefixed name is skipped whole, so that the digits of the
    anonymous namespace's hash never read as a length."""
    names, pos = [], 0
    while (m := _LENGTH.search(mangled, pos)):
        ident = mangled[m.end():m.end() + int(m.group(1))]
        pos = m.end() + len(ident)
        args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[pos:])
        if args:
            vals = re.findall(r"L[a-z](\d+)E", args.group(1))
            return f"{ident}<{','.join(vals)}>"
        if not ident.startswith("_GLOBAL"):
            names.append(ident)
    return names[0] if names else mangled[:80]


def ptxas_report(log: str) -> list:
    """One line per kernel from ptxas's -v report: its name with template
    arguments, registers, spill stores and loads; and ptxas's warnings."""
    lines, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = _kernel_name(line.split("'")[1] if "'" in line else line.strip())
        elif "spill stores" in line:
            spills = line.split(",", 1)[1].strip() if "," in line else line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{name}: {regs.group(1) if regs else '?'} registers, {spills}")
            name, spills = None, ""
        elif "warning" in line.lower() or "Performance Loss" in line:
            lines.append(line.strip()[:200])
    return lines


def phase_card() -> tuple[str, list]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    # one compiler per source, together: nvcc for the five kernel
    # libraries, g++ for the RLE codec, the image library and the hole
    # fill and labelling
    cuda_builds = (fa.build, ap.build, hg.build, nms_ops.build,
                   nms_ops.build_iou)
    with ThreadPoolExecutor(8) as pool:
        builds = [pool.submit(b) for b in (*cuda_builds, native.build,
                                           native_image.build,
                                           native_labels.build)]
        results = [b.result() for b in builds]
    print(f"build: all eight libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for path, seconds, log in results:
        print(f"build: {path.name} in {seconds:.1f} s", flush=True)
        report = ptxas_report(log)
        for line in report:
            print(f"build: {line}", flush=True)
        # C7511-C7515: ptxas serialised a kernel's wgmma, e.g. because a
        # register of a wgmma in flight was touched before its wait
        serialised = [line for line in report if "serialized" in line]
        check(not serialised, f"{path.name}: ptxas serialised wgmma: "
              f"{serialised[:2]}")
    # the selection kernels keep their per-lane arrays (and the IoU kernel
    # its loaders' rows) in registers: a register array indexed at run time
    # would go to local memory
    for build, (path, _, log) in zip(cuda_builds, results):
        if build in (hg.build, nms_ops.build, nms_ops.build_iou):
            local = [line.strip() for line in log.splitlines()
                     if "stack frame" in line and not re.search(
                         r"\b0 bytes stack frame, 0 bytes spill stores, "
                         r"0 bytes spill loads", line)]
            check(not local, f"{path.name}: local memory or spills: {local[:2]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return card, [path for path, _, _ in results[:len(cuda_builds)]]


# TMA, wgmma (bf16, int8), mma.sync, cp.async
SASS_OPS = ("UTMALDG", "HGMMA", "IGMMA", "HMMA", "LDGSTS")
# the wgmma kernels of each library and their instantiations: flash's bf16
# kernel per head dim (d 64 to 256 on one consumer warpgroup, 320 to 512 on
# two), its f32 kernel at d 64 with one and two consumer warpgroups and at
# d 80 and 96 with one, its wide f32 kernel at d 128 to 512, and the biased
# instantiations of each;
# `single` per head dim, exp mode and layout; the max-free kernel per head
# dim for fastsm (3 exp x 2 sum modes) and kt (3 exp modes, dots-only)
WGMMA_HEAD_DIMS = len(fa.HEAD_DIMS) - len(fa.HALVES_HEAD_DIMS)
SASS_KERNELS = {
    "flash_wgmma_kernel": WGMMA_HEAD_DIMS,
    "flash_halves_kernel": len(fa.HALVES_HEAD_DIMS),
    "flash_f32_kernel": len(fa.F32_HEAD_DIMS) + 1,
    "flash_f32_wide_kernel": len(fa.F32_WIDE_HEAD_DIMS),
    "flash_wgmma_bias_kernel": WGMMA_HEAD_DIMS,
    "flash_halves_bias_kernel": len(fa.HALVES_HEAD_DIMS),
    "flash_f32_bias_kernel": len(fa.F32_HEAD_DIMS) + 1,
    "flash_f32_wide_bias_kernel": len(fa.F32_WIDE_HEAD_DIMS),
    "single_kernel": 2 * len(ap.EXP_MODES) * 2,
    "maxfree_kernel": 2 * (len(ap.EXP_MODES) * len(ap.SUM_MODES)
                           + len(ap.EXP_MODES) + 1),
}
# the int8 wgmma kernel: NMS's intersection counts, <tile pairs, TMA>, its
# two instantiations without TMA loading the rows themselves
IGMMA_KERNELS = {"mask_counts_kernel": 4}


# kernels that a redesign replaced: the f32 flash forward on mma.sync, and
# at d 128 to 512 on the CUDA cores
GONE_KERNELS = ("flash_fwd_kernel", "flash_f32_simt_kernel",
                "flash_f32_simt_bias_kernel")


def sass_check(libs: list) -> dict:
    """Opcode counts of each wgmma kernel in the built libraries (every
    instantiation of SASS_KERNELS), from cuobjdump's SASS; each must load
    through TMA (UTMALDG) and multiply on wgmma (HGMMA), with no mma.sync
    (HMMA) and no cp.async (LDGSTS); none of GONE_KERNELS may be left.
    cuobjdump ships beside nvcc; fails without it."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        tool = str(Path(_build._nvcc()).parent / "cuobjdump")
    check(Path(tool).exists(), "no cuobjdump beside nvcc: the wgmma "
          "kernels' opcodes cannot be checked")
    counts, names = {}, []
    for lib in libs:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=300)
        check(out.returncode == 0,
              f"cuobjdump failed: {out.stderr.strip()[:300]}")
        for block in out.stdout.split("Function : ")[1:]:
            name = _kernel_name(block.split()[0])
            names.append(name)
            if name.split("<")[0] in {**SASS_KERNELS, **IGMMA_KERNELS}:
                counts[name] = {op: len(re.findall(rf"\b{op}\b", block))
                                for op in SASS_OPS}
    for kernel, n in {**SASS_KERNELS, **IGMMA_KERNELS}.items():
        found = sorted(k for k in counts if k.split("<")[0] == kernel)
        check(len(found) == n,
              f"cuobjdump found {found} for {kernel}, expected {n}")
    check(not any(name.split("<")[0] in GONE_KERNELS for name in names),
          f"the libraries still hold one of {GONE_KERNELS}")
    for name, c in counts.items():
        print(f"sass: {name}: {json.dumps(c)}", flush=True)
        check(c["HMMA"] == 0 and c["LDGSTS"] == 0,
              f"{name} still holds mma.sync or cp.async")
        if name.split("<")[0] in IGMMA_KERNELS:
            tma = name.endswith(",1>")
            check(c["IGMMA"] > 0 and c["HGMMA"] == 0
                  and (c["UTMALDG"] > 0) == tma,
                  f"{name}: no int8 wgmma, or TMA loads where it has none")
            continue
        check(c["UTMALDG"] > 0 and c["HGMMA"] > 0,
              f"{name} has no TMA load or no wgmma")
    return counts


def _inputs(gen, b, h, sq, sk, d, dtype, strided=False):
    """q, k, v [b, h, s, d]; `strided` makes them [b, s, h, d] and returns
    [b, h, s, d] views."""
    if strided:
        return [torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
                .transpose(1, 2) for s in (sq, sk, sk)]
    return [torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


# (dtype, head dim, query rows a block) of every flash kernel the library
# launches: bf16 at 64 rows; f32 at 128 and 64 rows at d 64, else 64
FLASH_BLOCKS = ([(torch.bfloat16, d, 64) for d in fa.HEAD_DIMS]
                + [(torch.float32, 64, 128), (torch.float32, 64, 64),
                   (torch.float32, 80, 64), (torch.float32, 96, 64)]
                + [(torch.float32, d, 64) for d in fa.F32_WIDE_HEAD_DIMS])


def flash_occupancy() -> dict:
    """Each flash kernel's dynamic shared memory and blocks per SM: the
    bf16 kernels per head dim (keys "d64", "d96", ...), the f32 kernels per
    head dim and block ("f32 d64 block_q 128", ...), and the biased
    instantiations of both ("bias d64", "bias f32 d64 block_q 128", ...),
    which must hold at least as many blocks an SM."""
    occ = {}
    for bias in (False, True):
        for dtype, d, block_q in FLASH_BLOCKS:
            f32 = dtype == torch.float32
            smem, blocks = fa.occupancy(d, dtype, block_q, bias=bias)
            layout = (fa.f32_smem_layout(d, bias) if f32
                      else fa.smem_layout(d, bias))
            check(smem == layout["total"],
                  f"flash shared memory {smem} differs from its layout mirror")
            key = ("bias " if bias else "") + (
                f"f32 d{d} block_q {block_q}" if f32 else f"d{d}")
            occ[key] = dict(smem_bytes=smem, blocks_per_sm=blocks)
            if bias:
                unbiased = occ[key[len("bias "):]]["blocks_per_sm"]
                check(blocks >= unbiased, f"flash {key}: {blocks} blocks an "
                      f"SM against {unbiased} unbiased")
            print(f"flash occupancy {key}: {smem} bytes of dynamic shared "
                  f"memory, {blocks} block(s) per SM", flush=True)
    return occ


def check_flash_case(gen, name, shape, masked, dtype, strided,
                     biased=False) -> float:
    """One flash launch at `shape` [b, h, sq, sk, d] against its plain
    version (bf16 within TOL_FLASH_BF16 of the largest |output|, f32 within
    TOL_F32): with `masked` a kv_mask whose item 1 has no valid key (its
    output must be exactly zero), with `strided` [b, s, h, d] views, with
    `biased` a key bias in [0, 6) (ToMe's log(size) range); an f32 call
    split into key ranges also against the same call on one range.
    Returns the largest absolute error."""
    b, h, sq, sk, d = shape
    q, k, v = _inputs(gen, b, h, sq, sk, d, dtype, strided)
    mask = bias = None
    if masked:
        mask = (torch.rand(b, sk, generator=gen, device="cuda") > 0.3).int()
        mask[1] = 0  # an item with no valid key
    if biased:
        bias = torch.rand(b, sk, generator=gen, device="cuda") * 6
    before = fa.flash_attention.launches
    split_before = fa.flash_attention.split_launches
    got = fa.flash_attention(q, k, v, mask, bias)
    torch.cuda.synchronize()
    check(fa.flash_attention.launches == before + 1, f"{name}: no launch")
    splits = (fa.key_splits(b, h, sq, sk, d)
              if dtype == torch.float32 else 1)
    check(fa.flash_attention.split_launches == split_before
          + (splits > 1), f"{name}: {splits} key ranges, split count "
          f"{fa.flash_attention.split_launches - split_before}")
    check(got.stride() == q.stride(), f"{name}: output not in q's layout")
    want = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask,
                                        bias)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got.float() - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    if dtype == torch.bfloat16:
        tol, ok = f"{TOL_FLASH_BF16} rel", rel <= TOL_FLASH_BF16
    else:
        tol, ok = f"{TOL_F32} abs", err <= TOL_F32
    print(f"kernel check {name} {[b, h, sq, sk, d]} {str(dtype)[6:]}: "
          f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol {tol}), "
          f"{splits} key range(s)", flush=True)
    check(ok, f"{name}: kernel disagrees with its plain version")
    if masked:
        check(bool((got[1] == 0).all()), f"{name}: all-masked item not zero")
    if splits > 1:  # the same call on one key range
        whole = fa._flash_forward(q, k, v, mask, 1, key_bias=bias)
        torch.cuda.synchronize()
        apart = (whole - got).abs().max().item()
        print(f"kernel check {name}: {splits} key ranges against one: "
              f"max_abs_diff {apart:.3e} (tol {TOL_F32} abs)", flush=True)
        check(apart <= TOL_F32, f"{name}: split and unsplit launches "
              "disagree")
        if masked:
            check(bool((whole[1] == 0).all()),
                  f"{name}: all-masked item not zero unsplit")
    return err


def phase_kernel():
    """Kernels against their plain version; per-shape times and bounds."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    cases = [(name, shape, None, torch.bfloat16, False)
             for name, shape, _ in MAIN_SHAPES]
    cases += [(f"{name} strided", shape, None, torch.bfloat16, True)
              for name, shape, _ in MAIN_SHAPES]
    cases += [("ragged", (1, 1, 130, 260, 64), None, torch.bfloat16, False),
              ("ragged sq 577 sk 260", (2, 3, 577, 260, 64), None,
               torch.bfloat16, True),
              # one key in the last chunk and 63 past the edge
              ("keys past the edge", (2, 4, 100, 65, 96), None,
               torch.bfloat16, False),
              ("kv_mask", (3, 8, 64, 200, 96), "mask", torch.bfloat16, False),
              ("kv_mask strided", (3, 4, 130, 300, 64), "mask",
               torch.bfloat16, True),
              ("kv_mask f32", (3, 8, 64, 200, 96), "mask", torch.float32, False),
              ("ragged f32", (2, 12, 77, 333, 64), None, torch.float32, False),
              # SelfMask's cross-attention, split into key ranges
              ("selfmask cross f32", SELFMASK_FLASH_SHAPES[2][1], None,
               torch.float32, True),
              ("selfmask cross f32 kv_mask", (3, 6, 20, 5504, 64), "mask",
               torch.float32, True),
              ("keys past the edge f32", (2, 4, 100, 65, 96), None,
               torch.float32, True)]
    for case in cases:
        max_err = max(max_err, check_flash_case(gen, *case))

    occupancy = flash_occupancy()
    rows = []
    for name, (b, h, sq, sk, d), per_forward in MAIN_SHAPES:
        q, k, v = _inputs(gen, b, h, sq, sk, d, torch.bfloat16)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
        qs, ks, vs = _inputs(gen, b, h, sq, sk, d, torch.bfloat16, True)
        strided_ms = cuda_ms(lambda: fa.flash_attention(qs, ks, vs))
        del qs, ks, vs
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = bound(b, h, sq, sk, d)
        rows.append(dict(name=name, shape=[b, h, sq, sk, d],
                         per_forward=per_forward, ms=ms,
                         strided_ms=strided_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, **occupancy[f"d{d}"]))
        print(f"kernel time {name} {[b, h, sq, sk, d]}: kernel {ms:.4f} ms "
              f"(strided [b,s,h,d] {strided_ms:.4f}), plain {plain_ms:.4f} "
              f"ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.1%} of bound", flush=True)
    return max_err, rows, occupancy


def _probe_kernel_only(label, kw, q, k, v, block_q=128):
    """The call that `label` times: the probe wrapper, or for kt the kernel
    alone on a K^T made beforehand."""
    if label.startswith("kt"):
        kt = ap.transpose_keys(k)
        return lambda: ap.kt_attention_kernel(q, kt, v, block_q, **kw)
    wrapper = PROBES[next(n for n, lab, _ in PROBE_CONFIGS if lab == label)][0]
    return lambda: wrapper(q, k, v, block_q, **kw)


def _check_probes(shape_name, q, k, v, configs, max_err, max_rel):
    """Each config's kernel against its plain version, fastsm and kt at
    both block_q and `single` at 128; the `single` layouts, where checked,
    bit for bit against each other."""
    outs = {}
    for kernel, label, kw in configs:
        wrapper, reference, _ = PROBES[kernel]
        want = reference(q, k, v, **kw).float()
        block_qs = (128,) if kernel == "single_attention" else ap.BLOCK_Q[::-1]
        for block_q in block_qs:
            before = PROBE_COUNTS[kernel].launches
            got = wrapper(q, k, v, block_q, **kw)
            torch.cuda.synchronize()
            check(PROBE_COUNTS[kernel].launches == before + 1,
                  f"{label}: no kernel launch")
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
            err = (got.float() - want).abs().max().item()
            # relative to the largest |output|: "mul" drives single's output
            # to ~1e-30 and the dots-only probe's reaches ~100, where one
            # flipped bf16 rounding of p moves a sum of 577 products
            rel = err / want.abs().max().item()
            print(f"probe check {shape_name} "
                  f"{list(q.shape[:3]) + list(k.shape[2:])} {label} block_q "
                  f"{block_q}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
                  f"(tol {TOL_BF16})", flush=True)
            check(rel <= TOL_BF16, f"{label} block_q {block_q} at "
                  f"{shape_name}: kernel disagrees with its plain version")
            max_err[kernel] = max(max_err[kernel], err)
            max_rel[kernel] = max(max_rel[kernel], rel)
            if block_q == 128:
                outs[label] = got
        del want
    if "single unroll" not in outs:
        return
    same = (torch.equal(outs["single unroll"], outs["single batched"])
            and torch.equal(outs["single unroll"], outs["single grid"]))
    print(f"probe check {shape_name}: single unroll/batched/grid "
          f"bit-identical: {same}", flush=True)
    check(same, f"single layouts differ at {shape_name}")


def single_occupancy():
    """The `single` kernel's dynamic shared memory and blocks per SM at sk
    577, for each layout, head dim and block_q."""
    occ = {}
    for hp in ap.HEADS_PER_CELL:
        for d in (64, 96):
            for block_q in ap.BLOCK_Q[::-1]:
                smem, blocks = ap.single_occupancy(d, 577, block_q, hp)
                occ[f"single {hp} d{d} block_q {block_q}"] = dict(
                    smem_bytes=smem, blocks_per_sm=blocks)
                print(f"single occupancy {hp} d {d} sk 577 block_q {block_q}: "
                      f"{smem} bytes of dynamic shared memory, {blocks} "
                      "block(s) per SM", flush=True)
    return occ


def maxfree_occupancy():
    """The fastsm and kt kernels' dynamic shared memory and blocks per SM
    (any sk), for each family, head dim and block_q, in the lane sum and
    exp mode."""
    occ = {}
    for family in ("fastsm", "kt"):
        for d in (64, 96):
            for block_q in ap.BLOCK_Q[::-1]:
                smem, blocks = ap.maxfree_occupancy(d, block_q, family)
                check(smem == ap.maxfree_smem_layout(d, block_q)["total"],
                      f"{family} shared memory {smem} differs from "
                      "maxfree_smem_layout")
                occ[f"{family} d{d} block_q {block_q}"] = dict(
                    smem_bytes=smem, blocks_per_sm=blocks)
                print(f"{family} occupancy d {d} block_q {block_q}: {smem} "
                      f"bytes of dynamic shared memory, {blocks} block(s) "
                      "per SM", flush=True)
    return occ


def phase_probes():
    """Each probe kernel, layout and mode against its plain version in bf16;
    the `single` layouts bit for bit against each other, also at its edge
    shapes; times at the two 577-token shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = {name: 0.0 for name in PROBES}
    max_rel = {name: 0.0 for name in PROBES}
    timings = []
    for shape_name, (b, h, sq, sk, d) in PROBE_SHAPES:
        q, k, v = _inputs(gen, b, h, sq, sk, d, torch.bfloat16)
        _check_probes(shape_name, q, k, v, PROBE_CONFIGS, max_err, max_rel)
        if shape_name in PROBE_TIMED_SHAPES:
            timings.append(_time_probes(shape_name, q, k, v))
        del q, k, v
        torch.cuda.empty_cache()
    single_configs = [c for c in PROBE_CONFIGS if c[0] == "single_attention"]
    for shape_name, (b, h, sq, sk, d), strided in SINGLE_SHAPES:
        q, k, v = _inputs(gen, b, h, sq, sk, d, torch.bfloat16, strided)
        _check_probes(shape_name, q, k, v, single_configs, max_err, max_rel)
        del q, k, v
    maxfree_configs = [c for c in PROBE_CONFIGS if c[0] != "single_attention"]
    for shape_name, (b, h, sq, sk, d) in MAXFREE_EDGE_SHAPES:
        q, k, v = _inputs(gen, b, h, sq, sk, d, torch.bfloat16, strided=True)
        _check_probes(f"{shape_name} strided", q, k, v, maxfree_configs,
                      max_err, max_rel)
        del q, k, v
    occupancy = dict(single_occupancy(), **maxfree_occupancy())
    return max_err, max_rel, timings, occupancy


def _time_probes(shape_name, q, k, v):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bound_ms, bound_by = bound(b, h, sq, sk, d)
    # the plain versions hold [b, h, sq, 640] f32 logits: fewer calls at b 64
    plain_calls = dict(calls=3, reps=5, warmup=1) if b > BATCH else {}
    row = dict(name=shape_name, shape=[b, h, sq, sk, d], bound_ms=bound_ms,
               bound_by=bound_by,
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
               flash_ms=cuda_ms(lambda: fa.flash_attention(q, k, v)),
               flash_plain_ms=cuda_ms(
                   lambda: fa.flash_attention_reference(q, k, v), **plain_calls),
               transpose_ms=cuda_ms(lambda: ap.transpose_keys(k)),
               plain_ms={name: cuda_ms(lambda: ref(q, k, v), **plain_calls)
                         for name, (_, ref, _) in PROBES.items()},
               ms={})
    for kernel, label, kw in PROBE_CONFIGS:
        if kw.get("exp_mode", "exp") == "exp":
            row["ms"][label] = cuda_ms(_probe_kernel_only(label, kw, q, k, v))
            if kernel != "single_attention":  # one warpgroup a block
                row["ms"][f"{label} block_q 64"] = cuda_ms(
                    _probe_kernel_only(label, kw, q, k, v, 64))
    row["ms"]["kt with transpose"] = cuda_ms(lambda: ap.kt_attention(q, k, v, 128))
    # one consumer warpgroup a block: K loaded per 64 query rows, 2 blocks an SM
    for hp in ("unroll", "grid"):
        row["ms"][f"single {hp} block_q 64"] = cuda_ms(
            lambda: ap.single_attention(q, k, v, 64, hp))
    for label, ms in row["ms"].items():
        print(f"probe time {shape_name} {row['shape']} {label}: kernel "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of bound", flush=True)
    print(f"probe time {shape_name} {row['shape']}: plain "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in row["plain_ms"].items())
          + f"; sdpa {row['library_ms']:.4f} ms; flash_attention "
          f"{row['flash_ms']:.4f} ms (plain {row['flash_plain_ms']:.4f}); "
          "K transpose "
          f"{row['transpose_ms']:.4f} ms",
          flush=True)
    return row


def phase_tune():
    """The tuning path: kernel_tune.run for every variant at the tool's
    shape, with every launch count set to 0 before and read after."""
    inputs = kernel_tune.make_inputs(kernel_tune.SHAPE, "cuda")
    counted = {"flash_attention": fa.flash_attention, **PROBE_COUNTS}
    for w in counted.values():
        w.launches = 0
    results = []
    for variant, exp_mode, dots_only in TUNE_RUNS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = kernel_tune.run(variant, 128, exp_mode, dots_only,
                                  inputs=inputs)
        sys.stdout.write(buf.getvalue())
        check(any(line.startswith(f"RESULT_OK variant={variant} block_q=128 ms=")
                  for line in buf.getvalue().splitlines()),
              f"kernel_tune {variant}: no RESULT_OK line")
        if res["exact"]:
            check(res["max_err"] <= kernel_tune.TOL_BF16,
                  f"kernel_tune {variant}: RESULT_MAXERR {res['max_err']} over "
                  f"{kernel_tune.TOL_BF16}")
        results.append(res)
    launches = {name: w.launches for name, w in counted.items()}
    print(f"tune: launches in {len(TUNE_RUNS)} kernel_tune runs: "
          f"{json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"the tuning path never launched {name}")
    del inputs
    torch.cuda.empty_cache()
    return launches, results


def device_kernels(fn, grad: bool = False) -> dict:
    """{kernel name: (device ms, launches)} of one call of `fn` as
    torch.profiler sees them; `fn` runs under inference mode unless
    `grad`. Empty where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with contextlib.nullcontext() if grad else torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


def profile_device(fn, device: torch.device, top: int = 12, grad: bool = False):
    """Device busy ms of one call of `fn` (sum of kernel durations seen by
    torch.profiler), the `top` kernels by device time, as [name, ms, count],
    and device_kernels' whole table; `fn` runs under inference mode unless
    `grad`. (None, [], {}) where the profiler sees no device time."""
    if device.type != "cuda":
        return None, [], {}
    by_name = device_kernels(fn, grad)
    if not by_name:
        print("profile: the profiler saw no device time", flush=True)
        return None, [], {}
    busy = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    for name, (ms, n) in ranked:
        print(f"profile: {ms:9.4f} ms {n:5d}x {name[:110]}", flush=True)
    print(f"profile: device busy {busy:.4f} ms in {sum(n for _, n in by_name.values())}"
          " kernels for one step", flush=True)
    return busy, [[name[:80], ms, n] for name, (ms, n) in ranked], by_name


def set_attn_impl(model: torch.nn.Module, impl: str) -> None:
    for m in model.modules():
        if isinstance(m, (MultiHeadAttention, AttentionPool2d)):
            m.attn_impl = impl


TOL_F32_FORWARD = 1e-3  # of the largest |output|: see f32_kernel_forward


def f32_kernel_forward(model: ZUTIS, x: torch.Tensor, want: dict,
                       label: str) -> dict:
    """An f32 `model`'s forward on the kernel attention path against
    `want`, its forward on the "torch" path: every f32 flash call takes
    hi/lo bf16 splits (~16 mantissa bits), so the outputs agree within
    TOL_F32_FORWARD of their largest |value| after dozens of layers. Returns the launches by head dim and the differences
    (every f32 kernel of the model's head dims on a main path)."""
    impl = next(m.attn_impl for m in model.modules()
                if isinstance(m, (MultiHeadAttention, AttentionPool2d)))
    set_attn_impl(model, "auto")
    before = dict(fa.flash_attention.launches_by_dim)
    with torch.inference_mode():
        got = model(x, inference=True)
    _sync(x.device)
    set_attn_impl(model, impl)
    launched = {d: n - before.get(d, 0)
                for d, n in fa.flash_attention.launches_by_dim.items()
                if n > before.get(d, 0)}
    out = dict(launches_by_dim=launched)
    for key in ("patch_tokens", "mask_proposals"):
        check(bool(torch.isfinite(got[key]).all()), f"{label}: f32 kernel "
              f"path's {key} not finite")
        scale = want[key].abs().max().item()
        out[key] = (got[key] - want[key]).abs().max().item() / scale
        check(out[key] <= TOL_F32_FORWARD, f"{label}: f32 kernel path's "
              f"{key} {out[key]:.3e} of the largest |value| from the torch "
              "path's")
    print(f"f32 kernel forward {label}: launches by head dim {launched}; "
          f"patch_tokens {out['patch_tokens']:.3e}, mask_proposals "
          f"{out['mask_proposals']:.3e} of the largest |value| from the "
          f"torch path (tol {TOL_F32_FORWARD})", flush=True)
    return out


# NMS on the card against a CPU rerun, relative to each score: gaussian's
# weight differs by an ulp or so (the card divides by sigma as a product with
# its reciprocal, and the two exps round differently); hard and linear run
# the same f32 operations on both
TOL_NMS_CPU = 1e-6
# the eval step on the float64 IoU product, before the IoU kernel (H100
# 80GB HBM3, 700 W; PERF.md section 5): mask_nms and decode host ms, peak
# memory
FLOAT64_IOU_EVAL = {"nms_ms": 11.30, "decode_ms": "83.7-91.3",
                    "peak_memory_gib": 17.10}
# the per-image decode's size for the IoU kernel's own row loads: 375 x 500
# bytes a mask, no multiple of 16 (COCO holds many 375 x 500 photos)
RAGGED_SIZE = (375, 500)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN's payload aside."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


@contextlib.contextmanager
def nms_inputs():
    """Records the inputs of every selection (nms_rounds) that mask_nms
    runs: (iou, areas, scores, category_ids, options)."""
    real, seen = nms_ops.nms_rounds, []

    def capture(iou, areas, scores, category_ids, **options):
        seen.append((iou, areas, scores, category_ids, options))
        return real(iou, areas, scores, category_ids, **options)

    nms_ops.nms_rounds = capture
    try:
        yield seen
    finally:
        nms_ops.nms_rounds = real


def check_nms_kernel(inputs: tuple, label: str) -> dict:
    """The NMS kernel against its plain version on the same card tensors
    (a selection's captured inputs), for every NMS type: keep equal, scores
    bit-equal. {type: kept}."""
    iou, areas, conf, cats, options = inputs
    options = {k: v for k, v in options.items() if k != "nms_type"}
    kept = {}
    for nms_type in nms_ops.NMS_TYPES:
        keep, out = nms_ops.nms_rounds(iou, areas, conf, cats,
                                       nms_type=nms_type, **options)
        want_keep, want_out = nms_ops.nms_rounds_reference(
            iou, areas, conf, cats, nms_type=nms_type, **options)
        torch.cuda.synchronize()
        check(torch.equal(keep, want_keep) and same_bits(out, want_out),
              f"{label}: the NMS kernel differs from its plain version "
              f"({nms_type})")
        kept[nms_type] = int(keep.sum())
    print(f"{label}: NMS kernel equals its plain version on the card "
          f"{list(conf.shape)} (keep equal, scores bit for bit), kept "
          f"{json.dumps(kept)}", flush=True)
    return kept


def time_nms(inputs: tuple, masks: torch.Tensor, label: str) -> dict:
    """The NMS kernel's device time on a selection's captured inputs beside
    its bound (the IoU block and the per-candidate arrays read once, keep
    and the scores written once), the plain rounds' device time in a CUDA
    graph and their host time with a sync (what a call of the Python loop
    costs), and pairwise_iou's device time on `masks`."""
    iou, areas, conf, cats, options = inputs
    b, q = conf.shape

    def plain():
        nms_ops.nms_rounds_reference(iou, areas, conf, cats, **options)

    ms = cuda_ms(lambda: nms_ops.nms_rounds(iou, areas, conf, cats, **options))
    plain_ms = cuda_ms(plain, calls=3, reps=5, warmup=1)
    plain_host_ms = host_ms(plain, masks.device, reps=3, warmup=1)
    iou_ms = cuda_ms(lambda: nms_ops.pairwise_iou(masks), calls=3, reps=5,
                     warmup=1)
    bound_ms = (iou.numel() * 4 + b * q * (4 + 4 + 8 + 1 + 4)) / 3.35e12 * 1e3
    row = dict(shape=[b, q], ms=ms, plain_ms=plain_ms,
               plain_host_ms=plain_host_ms, iou_ms=iou_ms, bound_ms=bound_ms,
               bound_by="bytes",
               iou_in_shared_memory=nms_ops.iou_in_shared_memory(q))
    print(f"{label}: NMS kernel {[b, q]}: {ms:.4f} ms, bound {bound_ms:.6f} "
          f"ms (bytes), plain rounds {plain_ms:.3f} ms on the card in a CUDA "
          f"graph, {plain_host_ms:.3f} ms of host clock; pairwise_iou "
          f"{iou_ms:.3f} ms", flush=True)
    return row


@contextlib.contextmanager
def iou_inputs():
    """Records the masks of every IoU kernel call that mask_nms makes."""
    real, seen = nms_ops.pairwise_iou_kernel, []

    def capture(masks):
        seen.append(masks)
        return real(masks)

    nms_ops.pairwise_iou_kernel = capture
    try:
        yield seen
    finally:
        nms_ops.pairwise_iou_kernel = real


def check_iou_kernel(masks: torch.Tensor, inputs: tuple, label: str) -> dict:
    """The IoU kernel against its plain version on the same card masks (a
    path's own): counts equal, IoU and areas bit-equal; then mask_nms on
    the kernels against the plain IoU and rounds, for every NMS type, with
    the path's scores, categories and options (`inputs`, the rounds'
    captured inputs): keep equal, scores bit-equal."""
    _, _, conf, cats, options = inputs
    options = {k: v for k, v in options.items() if k != "nms_type"}
    iou, areas, counts = nms_ops.pairwise_iou_kernel(masks)
    want_counts = nms_ops.intersection_counts_reference(masks)
    want_iou, want_areas = nms_ops.pairwise_iou_reference(masks)
    torch.cuda.synchronize()
    check(torch.equal(counts.long(), want_counts.long()),
          f"{label}: the IoU kernel's counts differ from the plain product's")
    check(same_bits(iou, want_iou) and same_bits(areas, want_areas),
          f"{label}: the IoU kernel's IoU or areas differ from the plain "
          "version's")
    kept = {}
    for nms_type in nms_ops.NMS_TYPES:
        keep, out = mask_nms(masks, conf, cats, nms_type=nms_type, **options)
        want_keep, want_out = nms_ops.nms_rounds_reference(
            want_iou, want_areas, conf, cats, nms_type=nms_type, **options)
        torch.cuda.synchronize()
        check(torch.equal(keep, want_keep) and same_bits(out, want_out),
              f"{label}: mask_nms on the kernels differs from the plain route "
              f"({nms_type})")
        kept[nms_type] = int(keep.sum())
    b, q = masks.shape[:2]
    row = dict(shape=[b, q, *masks.shape[2:]],
               max_abs_err=(iou - want_iou).abs().max().item(),
               max_count=int(counts.max()), kept=kept)
    print(f"{label}: IoU kernel equals its plain version on the card "
          f"{row['shape']} (counts equal, IoU and areas bit for bit; largest "
          f"count {row['max_count']}); mask_nms keeps {json.dumps(kept)} as "
          "the plain route does, scores bit for bit", flush=True)
    return row


def event_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median device ms of eager calls of `fn` between CUDA events (for
    calls a CUDA graph may not capture)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_iou(masks: torch.Tensor, label: str, row: dict) -> dict:
    """The IoU kernel's device time on a path's masks beside its bound (the
    masks read once, the IoU and areas written once; the product's int8
    operations at 1,979 TOP/s), the plain version's (the float64 product
    and the f32 IoU), the float64 product's alone, and, as the library's
    yardstick, torch._int_mm per image on [Q, K] x [K, Q rounded up to 8]
    int8 summed over the batch (where K is a multiple of 8; timed only)."""
    b, q = masks.shape[:2]
    k = masks[0, 0].numel()
    ms = cuda_ms(lambda: nms_ops.pairwise_iou(masks))
    plain_ms = cuda_ms(lambda: nms_ops.pairwise_iou_reference(masks),
                       calls=3, reps=5, warmup=1)
    product_ms = cuda_ms(lambda: nms_ops.intersection_counts_reference(masks),
                         calls=3, reps=5, warmup=1)
    library_ms = None
    if k % 8 == 0 and q > 16:
        n = -(-q // 8) * 8
        a8 = torch.zeros(b, n, k, dtype=torch.int8, device=masks.device)
        a8[:, :q] = masks.reshape(b, q, k)

        def int_mm():
            for i in range(b):
                torch._int_mm(a8[i, :q], a8[i].t())
        library_ms = event_ms(int_mm)
        del a8
    bytes_ms = (b * q * k + b * q * q * 4 + b * q * 4) / 3.35e12 * 1e3
    ops_ms = 2 * b * q * q * k / 1979e12 * 1e3
    row = dict(row, ms=ms, plain_ms=plain_ms, float64_product_ms=product_ms,
               library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(f"{label}: IoU kernel {row['shape']}: {ms:.4f} ms, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}), plain version "
          f"{plain_ms:.4f} ms (the float64 product {product_ms:.4f} ms), "
          f"torch._int_mm image by image {library_ms} ms", flush=True)
    return row


def phase_serving(cfg: dict = VIT_B16, image_size: int = IMAGE_SIZE,
                  n_categories: int = N_CATEGORIES, n_requests: int = 20,
                  device="cuda", launches_per_forward: int = LAUNCHES_PER_FORWARD,
                  dims_per_forward: dict = MAIN_DIMS, model=None,
                  new_arch: bool = False, nms_checks: bool = True) -> dict:
    """InferenceServer at full width: `cfg` is ZUTIS's keyword arguments
    (the model is `build_model`'s seeded one unless given); each batch
    forward must launch flash `launches_per_forward` times, by head dim
    `dims_per_forward` ({d: launches}). A `new_arch` (the head dims added
    to 64, 96 and 256) is held to its "torch" path's semantic agreement
    less 0.1 point where that falls below MIN_SEMANTIC_AGREEMENT on random
    weights (rounding, not the kernel), and also runs the f32 forward on
    the kernel path against the f32 "torch" one (`f32_kernel_forward`).
    Every serving step must launch the NMS kernel once; `nms_checks` adds
    the decode's CPU rerun for the soft NMS types (hard is always rerun),
    the NMS kernel against its plain version on the card and its times."""
    device = torch.device(device)
    rng = np.random.RandomState(0)
    if model is None:
        model = build_model(cfg, device)
    text = rng.randn(n_categories, cfg["text_dim"]).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    images = [rng.randn(3, image_size, image_size).astype(np.float32)
              for _ in range(n_requests)]
    x = torch.from_numpy(np.stack(images[:BATCH])).to(device)

    # a threshold at which a tenth of the random model's proposal pixels
    # binarise, so that the instance decode has masks to work on
    with torch.inference_mode():
        out_k = model(x, inference=True)
    grid = out_k["patch_tokens"].shape[1]  # square images: a square grid
    proposals = out_k["mask_proposals"][:, -1]
    threshold = float(torch.quantile(proposals.flatten()[::7].float(), 0.9))
    print(f"serving: threshold {threshold:.6f}", flush=True)

    for w in (fa.flash_attention, mask_nms, nms_ops.pairwise_iou,
              *PROBE_COUNTS.values()):
        w.launches = 0
    fa.flash_attention.launches_by_dim = {}
    server = InferenceServer(model, text, image_size=image_size,
                             batch_size=BATCH, threshold=threshold,
                             max_wait_ms=50, device=device)
    server.start()
    futures = [server.submit(im) for im in images]
    results = [f.result(timeout=600) for f in futures]
    server.stop()
    sync = server.infer(images[:BATCH])
    launches = fa.flash_attention.launches
    nms_launches = mask_nms.launches
    iou_launches = nms_ops.pairwise_iou.launches
    by_dim = dict(fa.flash_attention.launches_by_dim)
    probe_launches = sum(w.launches for w in PROBE_COUNTS.values())
    batches = server.batches
    print(f"serving: {len(results)} async + {len(sync)} sync requests in "
          f"{batches} batch forwards, {launches} kernel launches, "
          f"{nms_launches} NMS launches", flush=True)

    check(len(results) == n_requests, "not every request was answered")
    n_inst = 0
    for r in results + sync:
        sem = r["semantic"]
        check(sem.shape == (grid, grid), f"semantic shape {sem.shape}")
        check(bool((sem >= 0).all() and (sem < n_categories).all()),
              "semantic ids out of range")
        for inst in r["instances"]:
            check(rle.decode(inst["segmentation"]).shape == (grid, grid),
                  "instance RLE does not decode to the token grid")
            check(0 <= inst["category_id"] < n_categories, "bad category id")
            n_inst += 1
    for a, b in zip(results[:BATCH], sync):
        check(np.array_equal(a["semantic"], b["semantic"])
              and len(a["instances"]) == len(b["instances"]),
              "sync and async answers differ for the same batch")
    print(f"serving: {n_inst} instances returned", flush=True)
    check(probe_launches == 0, "serving launched a probe kernel")
    if device.type == "cuda":
        check(launches == launches_per_forward * batches,
              f"{launches} kernel launches for {batches} batch forwards, "
              f"expected {launches_per_forward} each")
        check(by_dim == {d: n * batches for d, n in dims_per_forward.items()},
              f"flash launches by head dim {by_dim} for {batches} batch "
              f"forwards, expected {dims_per_forward} each")
        check(nms_launches == batches and iou_launches == batches,
              f"{nms_launches} NMS and {iou_launches} IoU launches for "
              f"{batches} serving steps")

    # the kernel path against the "torch" attention path on one batch, and
    # both against an f32 forward of the same (bf16-rounded) weights with
    # exact attention, which arbitrates where the two bf16 paths differ
    set_attn_impl(model, "torch")
    with torch.inference_mode():
        out_t = model(x, inference=True)
    set_attn_impl(model, "auto")
    ref = ZUTIS(**cfg, dtype=torch.float32, attn_impl="torch", device=device)
    ref.load_state_dict(model.state_dict())
    with torch.inference_mode():
        out_f = ref(x, inference=True)
    f32_check = (f32_kernel_forward(ref, x, out_f, f"serving {image_size} px")
                 if new_arch else None)
    del ref
    text_d = torch.from_numpy(text).to(device)

    def semantic(out):
        return torch.einsum("nc,bhwc->bnhw", text_d, out["patch_tokens"]).argmax(1)

    sem_k, sem_t, sem_f = semantic(out_k), semantic(out_t), semantic(out_f)
    agree = (sem_k == sem_t).float().mean().item()
    agree_kf = (sem_k == sem_f).float().mean().item()
    agree_tf = (sem_t == sem_f).float().mean().item()
    diffs = {}
    for name, a, b in (("kernel vs torch attention", out_k, out_t),
                       ("kernel vs f32", out_k, out_f),
                       ("torch attention vs f32", out_t, out_f)):
        diffs[name] = [(a[key] - b[key]).abs().max().item()
                       for key in ("patch_tokens", "mask_proposals")]
        print(f"{name}: patch_tokens max diff {diffs[name][0]:.3e}, "
              f"mask_proposals max diff {diffs[name][1]:.3e}", flush=True)
    n_classes = int(sem_k.unique().numel())
    print(f"semantic agreement: kernel vs torch attention {agree:.4%}, kernel "
          f"vs f32 {agree_kf:.4%}, torch attention vs f32 {agree_tf:.4%} "
          f"({n_classes} classes in the kernel path's maps)", flush=True)
    # Where random weights leave one class on every pixel (the RN50's
    # attnpool averages nearly all tokens alike), agreement says little:
    # both outputs are held to the f32 forward too, no further from it
    # than the "torch" path is, with half again for bf16 rounding; a
    # skipped chunk or a masked key given weight moves them far more.
    for i, key in enumerate(("patch_tokens", "mask_proposals")):
        check(diffs["kernel vs f32"][i]
              <= 1.5 * diffs["torch attention vs f32"][i],
              f"kernel path's {key} further from the f32 forward than the "
              "torch path's")
    # Random weights and 919 random text embeddings leave many pixels with a
    # near-tied argmax, and each bf16 path moves about 1% of them away from
    # the f32 forward, independently, so the two bf16 paths can agree with
    # each other below 99% (98.84% on an H100). The kernel is held to the
    # f32 forward instead: no further from it than the "torch" attention
    # path is, and above a floor half a point under the 99.0% both bf16
    # paths reach.
    floor = MIN_SEMANTIC_AGREEMENT
    if new_arch and agree_tf < MIN_SEMANTIC_AGREEMENT:
        floor = agree_tf - 0.001
        print(f"semantic floor: the torch path reaches {agree_tf:.4%} on "
              f"random weights; the kernel path is held to {floor:.4%}",
              flush=True)
    check(agree_kf >= floor,
          "kernel path's semantic map disagrees with the f32 forward")
    check(agree_kf >= agree_tf - SEMANTIC_SLACK,
          "kernel path is further from the f32 forward than the torch path")

    # the instance decode on the device against a CPU rerun, for every NMS
    # type, and the NMS kernel against its plain version on the card
    binary = proposals > threshold
    check(bool(binary.any()), "no proposal pixel binarised")
    for nms_type in nms_ops.NMS_TYPES if nms_checks else ("hard",):
        decoded = []
        for dev in (device, torch.device("cpu")):
            with torch.inference_mode():
                conf, cats = classify_proposals(
                    proposals.to(dev), binary.to(dev),
                    out_k["patch_tokens"].to(dev), text_d.to(dev),
                    server.temperature)
                keep, scores = mask_nms(binary.to(dev), conf, cats,
                                        nms_threshold=server.nms_threshold,
                                        nms_type=nms_type)
            decoded.append((keep.cpu(), cats.cpu(), scores.cpu()))
        (keep_d, cats_d, sc_d), (keep_c, cats_c, sc_c) = decoded
        rel = ((sc_d - sc_c).abs() / sc_c.abs().clamp(min=1e-30)).max().item()
        print(f"decode {nms_type}: {int(keep_d.sum())} kept on the device, "
              f"{int(keep_c.sum())} on the CPU, score max diff "
              f"{(sc_d - sc_c).abs().max().item():.3e} ({rel:.3e} relative)",
              flush=True)
        check(torch.equal(keep_d, keep_c),
              f"NMS {nms_type} keep differs between card and CPU")
        check(torch.equal(cats_d, cats_c), "categories differ between card and CPU")
        check(rel <= TOL_NMS_CPU, f"NMS {nms_type} scores differ between card "
              f"and CPU by {rel:.3e} relative")
    nms_row = iou_row = ragged_row = None
    if nms_checks and device.type == "cuda":
        with torch.inference_mode(), nms_inputs() as seen, \
                iou_inputs() as masks:
            server.step(x)
        check_nms_kernel(seen[0], "serving")
        nms_row = time_nms(seen[0], binary, "serving")
        iou_row = time_iou(masks[0], "serving", check_iou_kernel(
            masks[0], seen[0], "serving"))
        # the per-image decode at an image size whose rows are no multiple
        # of 16 bytes (TMA refuses them: the kernel loads them itself)
        with torch.inference_mode(), nms_inputs() as seen, \
                iou_inputs() as masks:
            predict_instances_device(
                out_k["mask_proposals"][:1], out_k["patch_tokens"][:1],
                text_d, size=RAGGED_SIZE, threshold=threshold,
                temperature=server.temperature,
                nms_threshold=server.nms_threshold)
        label = f"per-image decode {RAGGED_SIZE[0]} x {RAGGED_SIZE[1]}"
        ragged_row = time_iou(masks[0], label, check_iou_kernel(
            masks[0], seen[0], label))
        del seen, masks

    # serving rate of the synchronous path, and where a batch's time goes
    rate_images = images[:2 * BATCH]
    infer_ms = host_ms(lambda: server.infer(rate_images), device, reps=5)
    with torch.inference_mode():
        fwd_ms = host_ms(lambda: model(x, inference=True), device)
        step_ms = host_ms(lambda: server.step(x), device)
        set_attn_impl(model, "torch")
        fwd_torch_ms = host_ms(lambda: model(x, inference=True), device)
        set_attn_impl(model, "auto")
    per_batch = infer_ms / 2
    busy_ms, kernels, by_name = profile_device(lambda: server.step(x), device)
    flash_ms = sum(ms for k, (ms, _) in by_name.items() if "flash" in k)
    step_kernels = sum(n for _, n in by_name.values())
    step_nms = sum(n for k, (_, n) in by_name.items() if "nms_kernel" in k)
    print(f"serving: the step runs {step_kernels} kernels, {step_nms} of them "
          "the NMS kernel", flush=True)
    stats = dict(img_per_s=len(rate_images) / (infer_ms / 1e3),
                 ms_per_batch=per_batch, forward_ms=fwd_ms, step_ms=step_ms,
                 forward_torch_attention_ms=fwd_torch_ms, launches=launches,
                 nms_launches=nms_launches, nms=nms_row,
                 iou_launches=iou_launches, iou=iou_row,
                 iou_per_image=ragged_row,
                 step_kernels=step_kernels, step_nms_kernels=step_nms,
                 launches_by_dim=by_dim, f32_kernel_forward=f32_check,
                 semantic_floor=floor,
                 batches=batches, instances=n_inst, step_device_busy_ms=busy_ms,
                 step_flash_ms=flash_ms if busy_ms else None,
                 step_flash_share=flash_ms / busy_ms if busy_ms else None,
                 step_top_kernels=kernels,
                 semantic_agreement_with_f32=agree_kf,
                 semantic_classes=n_classes,
                 max_diff_with_f32=dict(zip(("patch_tokens", "mask_proposals"),
                                            diffs["kernel vs f32"])))
    print(f"serving rate: {stats['img_per_s']:.2f} img/s sync infer, "
          f"{per_batch:.3f} ms per batch of {BATCH} (forward {fwd_ms:.3f} ms,"
          f" step with decode {step_ms:.3f} ms, forward with torch attention "
          f"{fwd_torch_ms:.3f} ms; device busy in the step "
          f"{busy_ms} ms)", flush=True)
    return stats


def eval_masks(sizes, patch: int = 16) -> dict:
    """The padded forward's kv masks for images of `sizes` in the eval
    bucket: the encoder's [b, 1 + hp * wp] (CLS and the native window) and
    the cross-attention's [b, 4 hp wp] (the upsampled window)."""
    grid = torch.tensor([(h // patch, w // patch) for h, w in sizes])
    hp, wp = EVAL_SHAPE[0] // patch, EVAL_SHAPE[1] // patch
    cls = torch.ones(len(sizes), 1, dtype=torch.int32)
    return {"encoder": torch.cat([cls, token_valid_mask(grid, hp, wp)], 1),
            "memory": token_valid_mask(grid * 2, 2 * hp, 2 * wp)}


def phase_eval_flash():
    """Flash at the three eval shapes, as the padded forward calls it
    ([b, s, h, d] views, the bench's window masks), against its plain
    version; times beside the bound of this data (the valid keys) and SDPA
    given the same mask as booleans."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    masks = {k: v.cuda() for k, v in
             eval_masks(eval_bench.bench_sizes(EVAL_BATCH)).items()}
    rows, max_err = [], 0.0
    for name, (b, h, sq, sk, d), per_forward, which in EVAL_FLASH_SHAPES:
        q, k, v = _inputs(gen, b, h, sq, sk, d, torch.bfloat16, strided=True)
        mask = None if which is None else masks[which]
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches == before + 1, f"{name}: no launch")
        want = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask)
        err = (got.float() - want).abs().max().item()
        rel = err / want.abs().max().item()
        del got, want
        print(f"kernel check {name} {[b, h, sq, sk, d]} mask {which}: "
              f"max_abs_err {err:.3e} max_rel_err {rel:.3e} "
              f"(tol {TOL_FLASH_BF16} rel)", flush=True)
        check(rel <= TOL_FLASH_BF16, f"{name}: kernel disagrees with its plain version")
        max_err = max(max_err, err)
        valid = None if mask is None else int(mask.sum())
        bound_ms, bound_by = bound(b, h, sq, sk, d, valid_keys=valid)
        attn_mask = None if mask is None else mask.bool()[:, None, None, :]
        row = dict(name=name, shape=[b, h, sq, sk, d], per_forward=per_forward,
                   mask=which, valid_keys=valid,
                   ms=cuda_ms(lambda: fa.flash_attention(q, k, v, mask)),
                   plain_ms=cuda_ms(
                       lambda: fa.flash_attention_reference(q, k, v, mask),
                       calls=3, reps=5, warmup=1),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=attn_mask)),
                   bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        print(f"kernel time {name} {[b, h, sq, sk, d]}: kernel {row['ms']:.4f} "
              f"ms, plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / row['ms']:.1%} of bound", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return rows, max_err


def _threshold(proposals: torch.Tensor) -> float:
    """A threshold at which a tenth of the random model's proposal pixels
    binarise, so that the decode has masks to work on."""
    return float(torch.quantile(proposals.flatten()[::97].float(), 0.9))


def _gt_from(preds, sizes_by_id) -> dict:
    """A COCO ground truth of one box-filled mask per prediction."""
    anns = []
    for i, p in enumerate(preds):
        h, w = sizes_by_id[p["image_id"]]
        m = np.zeros((h, w), np.uint8)
        x0, y0, x1, y1 = (int(v) for v in p["bbox"])
        m[y0:y1 + 1, x0:x1 + 1] = 1
        anns.append({"id": i + 1, "image_id": p["image_id"], "iscrowd": 0,
                     "category_id": p["category_id"],
                     "segmentation": rle.encode(m), "area": int(m.sum())})
    cats = sorted({p["category_id"] for p in preds})
    return {"images": [{"id": k, "height": h, "width": w}
                       for k, (h, w) in sizes_by_id.items()],
            "annotations": anns, "categories": [{"id": c} for c in cats]}


def _padded_equals_per_image(cfg, text, sizes, device) -> dict:
    """f32 forward_padded of three images in the eval bucket against each
    image's dense f32 forward at its native size (the f32 kernel on both),
    and the instance step's keep and categories against
    predict_instances_device per image."""
    f32 = build_model(cfg, device, torch.float32)
    rng = np.random.RandomState(3)
    images = [rng.randn(3, h, w).astype(np.float32) for h, w in sizes]
    padded, grid, pix = BE.pad_batch(images, EVAL_SHAPE, len(images), 16)
    text_d = torch.from_numpy(text).to(device)
    worst = {"patch_tokens": 0.0, "mask_proposals": 0.0}
    with torch.inference_mode():
        out_b = f32.forward_padded(torch.from_numpy(padded).to(device), grid)
        thr = _threshold(out_b["mask_proposals"][:, -1])
        res_b = BE.make_instance_step(f32, text, EVAL_SHAPE, threshold=thr,
                                      semantic_mode="none", device=device)(
            padded, grid, pix)
        n_kept = 0
        for i, (img, (H, W)) in enumerate(zip(images, sizes)):
            out_1 = f32(torch.from_numpy(img[None]).to(device), inference=True)
            h, w = out_b["native_grid"][i].tolist()
            for key, a, b in (
                    ("patch_tokens", out_b["patch_tokens"][i, :h, :w],
                     out_1["patch_tokens"][0]),
                    ("mask_proposals", out_b["mask_proposals"][i, -1, :, :h, :w],
                     out_1["mask_proposals"][0, -1])):
                rel = ((a - b).abs().max() / b.abs().max()).item()
                worst[key] = max(worst[key], rel)
                check(rel <= TOL_PADDED_F32,
                      f"padded {key} of image {i} differ from its per-image "
                      f"forward by {rel:.3e} of the largest |output|")
            one = predict_instances_device(
                out_1["mask_proposals"], out_1["patch_tokens"], text_d,
                size=(H, W), threshold=thr)
            check(torch.equal(res_b["keep"][i], one["keep"][0]),
                  f"image {i}: the instance step keeps other queries than "
                  "predict_instances_device")
            check(torch.equal(res_b["category_ids"][i], one["category_ids"][0]),
                  f"image {i}: categories differ from predict_instances_device")
            n_kept += int(one["keep"].sum())
    print(f"eval: padded vs per-image f32 (3 images {sizes}): max rel diff "
          f"{json.dumps(worst)}; keep and categories equal, {n_kept} kept",
          flush=True)
    return dict(worst, kept=n_kept)


def _decode_equals_cpu(model, text, u8, ids, sizes, thr, device) -> dict:
    """The instance decode of one batch on the card against its rerun on
    the CPU from the card's forward outputs: keep, categories, scores,
    masks, the device RLE, the COCO list and its stats must be equal."""
    padded, grid, pix = BE.pad_batch(u8, EVAL_SHAPE, EVAL_BATCH, 16, np.uint8)
    text_d = torch.from_numpy(text).to(device)
    with torch.inference_mode():
        x = BE._normalise_u8(torch.from_numpy(padded).to(device))
        out = model.forward_padded(x, grid)
        res_d = BE.decode_instances(out, text_d, pix, EVAL_SHAPE, thr)
        out_c = {k: v.cpu() for k, v in out.items()}
        t0 = time.perf_counter()
        res_c = BE.decode_instances(out_c, text_d.cpu(), pix, EVAL_SHAPE, thr)
        cpu_s = time.perf_counter() - t0
    for key in ("keep", "category_ids", "scores", "masks"):
        check(torch.equal(res_d[key].cpu(), res_c[key]),
              f"decode: {key} differ between the card and the CPU")
    for key, value in res_d["rle"].items():
        check(torch.equal(value.cpu(), res_c["rle"][key]),
              f"decode: device RLE {key} differ between the card and the CPU")
    preds = []
    for res in (res_d, res_c):
        host = {k: res[k].cpu().numpy() for k in BE.HOST_KEYS}
        host.update({k: v.cpu().numpy() for k, v in res["rle"].items()})
        preds.append(instances_to_coco_counts(host, ids, sizes,
                                              dev_masks=res["masks"]))
    check(json.dumps(preds[0]) == json.dumps(preds[1]),
          "decode: the COCO lists differ between the card and the CPU")
    gt = _gt_from(preds[1], dict(zip(ids, sizes)))
    stats = [COCOEvaluator(gt).evaluate(p) for p in preds]
    check(stats[0] == stats[1], "decode: COCO stats differ")
    n = len(preds[0])
    print(f"eval: decode on the card equals the CPU rerun bit for bit: "
          f"{int(res_d['keep'].sum())} kept, {n} COCO predictions, "
          f"{int((res_d['rle']['overflow'] & res_d['rle']['valid']).sum())} "
          f"cap overflows, stats "
          f"{json.dumps(stats[0])} (CPU decode {cpu_s:.1f} s)", flush=True)
    check(n > 0, "decode: no prediction to compare")
    return dict(kept=int(res_d["keep"].sum()), predictions=n, stats=stats[0])


@contextlib.contextmanager
def numpy_codec():
    """instances_to_coco_counts on the port's numpy codec (the COCO strings
    and the dense fallback's encode), as it ran before the C++ codec."""
    saved = instance.counts_to_strings, instance.native_encode
    instance.counts_to_strings = lambda counts, n: [
        rle._compress_counts(c[:k]) for c, k in zip(counts, n)]
    instance.native_encode = lambda m: rle.encode(m)["counts"]
    try:
        yield
    finally:
        instance.counts_to_strings, instance.native_encode = saved


def time_codecs(res, ids, sizes, stream, reps: int = 5) -> dict:
    """The host COCO assembly of one eval batch, its fetch done, on the
    numpy codec and on the C++ one, in turns, host clock, median of `reps`;
    the two lists must be equal byte for byte. Then the COCO strings alone
    from the batch's device RLE counts, both ways."""
    host = BE.fetch_to_host(res, stream).result()
    masks = BE.SideStreamView(res["masks"], stream)
    times = {"numpy": [], "native": []}
    preds = {}
    for _ in range(reps):
        for name in times:
            with numpy_codec() if name == "numpy" else contextlib.nullcontext():
                t0 = time.perf_counter()
                preds[name] = instances_to_coco_counts(host, ids, sizes,
                                                       dev_masks=masks)
                times[name].append((time.perf_counter() - t0) * 1e3)
    check(json.dumps(preds["numpy"]) == json.dumps(preds["native"]),
          "the COCO lists of the numpy and the C++ codec differ")
    slots = host["valid"] & ~host["overflow"]
    counts, n = host["counts"][slots], host["n_runs"][slots] + 1
    strings = {"numpy": [], "native": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        by_numpy = [rle._compress_counts(c[:k]) for c, k in zip(counts, n)]
        strings["numpy"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        by_native = native.counts_to_strings(counts, n)
        strings["native"].append((time.perf_counter() - t0) * 1e3)
        check(by_numpy == by_native, "the codecs' COCO strings differ")
    out = dict(assembly_numpy_ms=statistics.median(times["numpy"]),
               assembly_native_ms=statistics.median(times["native"]),
               strings_numpy_ms=statistics.median(strings["numpy"]),
               strings_native_ms=statistics.median(strings["native"]),
               n_strings=len(by_native), n_predictions=len(preds["native"]),
               chars=sum(map(len, by_native)))
    print(f"eval: COCO assembly of one batch of {len(ids)} (fetch done), "
          f"{out['n_predictions']} predictions: numpy codec "
          f"{out['assembly_numpy_ms']:.3f} ms, C++ codec "
          f"{out['assembly_native_ms']:.3f} ms (median of {reps}, in turns), "
          f"equal byte for byte; the {out['n_strings']} strings alone "
          f"({out['chars']} chars): numpy {out['strings_numpy_ms']:.3f} ms, "
          f"C++ {out['strings_native_ms']:.3f} ms", flush=True)
    return out


def check_no_sync(dispatch) -> None:
    """Fail if `dispatch` makes the host wait for the card (a copy from
    pageable memory, a read of a device value): pipelined's depth 2 could
    then overlap nothing but the host's assembly with the next batch."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fetch = dispatch()
    except RuntimeError as exc:
        fail(f"the eval's dispatch waits for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fetch.result()
    print("eval: the dispatch of a batch (upload, forward, decode, fetch "
          "start) makes no host-device synchronisation", flush=True)


def phase_eval(cfg: dict = VIT_B16, device="cuda") -> dict:
    """The bucketed eval slice at full width: flash at the eval shapes;
    padded equals per-image in f32; evaluate_instances over two batches of
    32 images in the 512 x 640 bucket (24 flash launches per padded
    forward, 18 of them masked); the card's decode against a CPU rerun; and
    the times (the tool's img/s at depth 1 and 2, forward, decode, NMS and
    host assembly, device busy, peak memory)."""
    device = torch.device(device)
    flash_rows, flash_err = phase_eval_flash()
    sizes = eval_bench.bench_sizes(EVAL_BATCH)
    text = eval_bench.text_embeddings(eval_bench.N_CATEGORIES, cfg["text_dim"])
    padded_check = _padded_equals_per_image(cfg, text, sizes[:3], device)
    torch.cuda.empty_cache()

    model = build_model(cfg, device)
    rng = np.random.RandomState(4)
    u8 = [rng.randint(0, 256, (3, h, w)).astype(np.uint8)
          for h, w in sizes + sizes]
    ids = list(range(1, EVAL_IMAGES + 1))
    padded, grid, pix = BE.pad_batch(u8[:EVAL_BATCH], EVAL_SHAPE, EVAL_BATCH,
                                     16, np.uint8)
    with torch.inference_mode():
        x = BE._normalise_u8(torch.from_numpy(padded).to(device))
        thr = _threshold(model.forward_padded(x, grid)["mask_proposals"][:, -1])
    print(f"eval: threshold {thr:.6f}", flush=True)

    counted = (fa.flash_attention, mask_nms, nms_ops.pairwise_iou,
               *PROBE_COUNTS.values())
    for w in counted:
        w.launches = 0
    fa.flash_attention.masked_launches = 0
    t0 = time.perf_counter()
    preds = BE.evaluate_instances(model, text, u8, ids, batch_images=EVAL_BATCH,
                                  depth=2, threshold=thr, device=device)
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    masked = fa.flash_attention.masked_launches
    nms_launches = mask_nms.launches
    iou_launches = nms_ops.pairwise_iou.launches
    probe_launches = sum(w.launches for w in PROBE_COUNTS.values())
    batches = EVAL_IMAGES // EVAL_BATCH
    print(f"eval: evaluate_instances on {EVAL_IMAGES} images: {len(preds)} "
          f"predictions in {wall:.2f} s, {launches} flash launches "
          f"({masked} masked) and {nms_launches} NMS launches for {batches} "
          "padded forwards", flush=True)
    check(launches == EVAL_LAUNCHES * batches,
          f"{launches} flash launches for {batches} padded forwards, expected "
          f"{EVAL_LAUNCHES} each")
    check(nms_launches == batches and iou_launches == batches,
          f"{nms_launches} NMS and {iou_launches} IoU launches for {batches} "
          "eval steps")
    check(masked == EVAL_MASKED_LAUNCHES * batches,
          f"{masked} masked flash launches, expected {EVAL_MASKED_LAUNCHES} "
          "a forward (12 encoder, 6 cross)")
    check(probe_launches == 0, "the eval launched a probe kernel")
    size_of = dict(zip(ids, sizes + sizes))
    for p in preds:
        h, w = size_of[p["image_id"]]
        check(rle.decode(p["segmentation"]).shape == (h, w)
              and tuple(p["image_size"]) == (h, w), "prediction not at its image's size")
        check(0 <= p["category_id"] < eval_bench.N_CATEGORIES, "bad category id")
        check(0.0 < p["score"] <= 1.0 and np.isfinite(p["score"]), "bad score")
        x0, y0, x1, y1 = p["bbox"]
        check(0 <= x0 <= x1 < w and 0 <= y0 <= y1 < h, "box outside its image")
    check(len(preds) > 0, "evaluate_instances returned no prediction")

    decode_check = _decode_equals_cpu(model, text, u8[:EVAL_BATCH],
                                      ids[:EVAL_BATCH], sizes, thr, device)

    # where a batch's time goes, and the rates
    step = BE.make_instance_step(model, text, EVAL_SHAPE, threshold=thr,
                                 uint8_input=True, semantic_mode="none",
                                 device=device)
    text_d = torch.from_numpy(text).to(device)
    stream = torch.cuda.Stream(device)
    with torch.inference_mode():
        out = model.forward_padded(x, grid)
        with nms_inputs() as seen, iou_inputs() as masks:
            res = BE.decode_instances(out, text_d, pix, EVAL_SHAPE, thr)
        nms_kept = check_nms_kernel(seen[0], "eval")
        nms_row = time_nms(seen[0], res["masks"], "eval")
        iou_row = time_iou(masks[0], "eval", check_iou_kernel(
            masks[0], seen[0], "eval"))
        del seen, masks
        torch.cuda.empty_cache()
        forward_ms = host_ms(lambda: model.forward_padded(x, grid), device, reps=5)
        decode_ms = host_ms(lambda: BE.decode_instances(
            out, text_d, pix, EVAL_SHAPE, thr), device, reps=5)
        nms_ms = host_ms(lambda: mask_nms(res["masks"], res["scores"],
                                          res["category_ids"]), device, reps=5)
    assembly_ms = host_ms(lambda: instances_to_coco_counts(
        BE.fetch_to_host(res, stream).result(), ids[:EVAL_BATCH], sizes,
        dev_masks=BE.SideStreamView(res["masks"], stream)), device, reps=5)
    codec = time_codecs(res, ids[:EVAL_BATCH], sizes, stream)
    step_ms = host_ms(lambda: step(padded, grid, pix), device, reps=5)
    del out, res
    check_no_sync(lambda: BE.fetch_to_host(step(padded, grid, pix), stream))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    step(padded, grid, pix)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    float64_route = _eval_on_the_float64_iou(model, x, grid, text_d, pix, thr,
                                             step, padded, device)
    busy_ms, kernels, by_name = profile_device(lambda: step(padded, grid, pix),
                                               device)
    rates = {f"depth {d}": eval_bench.run(
        EVAL_BATCH, "counts", 12, d, device, model=model, threshold=thr)["value"]
        for d in (1, 2)}
    stats = dict(img_per_s=rates, forward_ms=forward_ms, decode_ms=decode_ms,
                 nms_ms=nms_ms, nms=nms_row, nms_kept=nms_kept,
                 nms_launches=nms_launches, iou=iou_row,
                 iou_launches=iou_launches, float64_iou_route=float64_route,
                 step_kernels=sum(n for _, (_, n) in by_name.items()),
                 assembly_ms=assembly_ms, step_ms=step_ms,
                 step_device_busy_ms=busy_ms, step_top_kernels=kernels,
                 peak_memory_gib=peak_gib, threshold=thr, launches=launches,
                 masked_launches=masked, batches=batches,
                 predictions=len(preds), padded_check=padded_check,
                 decode_check=decode_check, flash_rows=flash_rows,
                 flash_max_abs_err=flash_err, codec=codec)
    print(f"eval rate: {json.dumps(rates)} img/s (counts path, batch "
          f"{EVAL_BATCH}, 12 batches); per batch: step {step_ms:.3f} ms = "
          f"forward {forward_ms:.3f} + decode {decode_ms:.3f} (NMS "
          f"{nms_ms:.3f}); host assembly {assembly_ms:.3f} ms; device busy "
          f"{busy_ms} ms; peak memory {peak_gib:.2f} GiB", flush=True)
    print(f"eval, the IoU kernel against the float64 product: mask_nms "
          f"{nms_ms:.3f} ms against {float64_route['nms_ms']:.3f} ms in this "
          f"run ({FLOAT64_IOU_EVAL['nms_ms']} before the kernel), decode "
          f"{decode_ms:.3f} against {float64_route['decode_ms']:.3f} ms "
          f"({FLOAT64_IOU_EVAL['decode_ms']}), peak memory {peak_gib:.2f} "
          f"against {float64_route['peak_memory_gib']:.2f} GiB "
          f"({FLOAT64_IOU_EVAL['peak_memory_gib']})", flush=True)
    return stats


def _eval_on_the_float64_iou(model, x, grid, text_d, pix, thr, step, padded,
                             device) -> dict:
    """The eval step's decode and mask_nms host ms and its peak memory with
    pairwise_iou's plain version (the float64 product) in the kernel's
    place on the card, in the same run."""
    with mock.patch.object(nms_ops, "pairwise_iou",
                           nms_ops.pairwise_iou_reference), \
            torch.inference_mode():
        out = model.forward_padded(x, grid)
        res = BE.decode_instances(out, text_d, pix, EVAL_SHAPE, thr)
        decode_ms = host_ms(lambda: BE.decode_instances(
            out, text_d, pix, EVAL_SHAPE, thr), device, reps=5)
        nms_ms = host_ms(lambda: mask_nms(res["masks"], res["scores"],
                                          res["category_ids"]), device, reps=5)
        del out, res
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        step(padded, grid, pix)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    torch.cuda.empty_cache()
    return dict(decode_ms=decode_ms, nms_ms=nms_ms, peak_memory_gib=peak)


# the training step: bench.py's measure_train (bench.py:174-201): ViT-B/16
# at input_resolution 224, 384 px images, batch 8, n_max 10 with the first 4
# valid, 919 text embeddings, ignore_index 1000, base_lr 5e-5 over an
# 80,000-iteration schedule; bf16 compute with f32 parameters
TRAIN_BATCH, TRAIN_N_MAX, TRAIN_VALID = 8, 10, 4
TRAIN_IGNORE, TRAIN_LR, TRAIN_ITERS = 1000, 5e-5, 80_000
TRAIN_STEPS = 10  # timed, after one warm-up step
# the Function's gradients against autograd through the plain version on f32
# copies of the same inputs, relative to each gradient's largest |value|:
# the backward recomputes in f32 and rounds each bf16 gradient once (2^-9)
TOL_GRAD_BF16 = 8e-3
TOL_GRAD_F32 = 1e-4
# one f32 step on the kernel path against the "torch" attention path: the
# f32 kernel's hi/lo splits carry ~16 mantissa bits, and the difference
# goes through 18 attention layers into every gradient
TOL_STEP_LOSS = 1e-4  # relative
TOL_STEP_GRAD = 2e-3  # of each parameter's largest |gradient|
# decoder layer 0's self-attention reads tgt = 0, so these get no gradient
# on any path (v = 0, and softmax rows sum to 1); tests/test_torch_train_step.py
ZERO_GRAD_PARAMS = ("decoder.layers.0.self_attn.in_proj_weight",
                    "decoder.layers.0.self_attn.out_proj.weight",
                    "decoder.layers.0.norm1.weight")


def train_batch(cfg: dict, image_size: int, batch: int, n_max: int,
                n_valid: int, n_categories: int, seed: int = 0):
    """bench.py:181-201's inputs from np.random.RandomState(seed) (0 in the
    bench), drawn in its order (the flax init's input first): unit-norm text
    embeddings and the batch dict of host arrays."""
    rng = np.random.RandomState(seed)
    rng.randn(1, 3, image_size, image_size)  # the bench's init input
    text = rng.randn(n_categories, cfg["text_dim"]).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    sem = rng.randint(0, n_categories, (batch, image_size, image_size))
    masks = rng.rand(batch, n_max, image_size, image_size) > 0.7
    data = {
        "image": rng.randn(batch, 3, image_size, image_size).astype(np.float32),
        "instance_masks": masks.astype(np.float32),
        "instance_valid": np.repeat(np.arange(n_max)[None] < n_valid, batch, 0),
        "semantic_mask": sem.astype(np.int32),
    }
    return text, data


@contextlib.contextmanager
def matcher_inputs(replay=None):
    """Records every (cost, col4row) of the matcher the criterion calls;
    the criterion gets `replay` instead of col4row where one is given."""
    real, seen = crit.batched_hungarian, []

    def capture(cost):
        seen.append((cost.clone(), real(cost)))
        return seen[-1][1] if replay is None else replay

    crit.batched_hungarian = capture
    try:
        yield seen
    finally:
        crit.batched_hungarian = real


def matcher_sets(costs: torch.Tensor) -> dict:
    """The step's own [P, R, C] costs and seeded sets of the same shape:
    random, integer-valued (ties), padded rows at a constant, and NaN."""
    P, R, C = costs.shape
    rng = np.random.RandomState(5)
    rand = (rng.rand(P, R, C) * 3).astype(np.float32)
    ties = rng.randint(0, 4, (P, R, C)).astype(np.float32)
    padded = rand.copy()
    padded[:, R // 2:] = 0.0
    padded[::5] = 0.0
    nan = rand.copy()
    nan[0] = np.nan
    nan[1, 2, 3] = np.nan
    sets = {"step": costs}
    for name, a in (("random", rand), ("ties", ties), ("padded rows", padded),
                    ("nan", nan)):
        sets[name] = torch.from_numpy(a).to(costs.device)
    return sets


def check_matcher(costs: torch.Tensor) -> dict:
    """The matcher kernel bit-equal to its plain version on the step's
    costs and the seeded sets (a NaN set must terminate); its time beside
    its bound, the plain version's and scipy's over the same problems."""
    from scipy.optimize import linear_sum_assignment

    for name, cost in matcher_sets(costs).items():
        got = hg.batched_hungarian(cost)
        torch.cuda.synchronize()
        want = hg.batched_hungarian_reference(cost.cpu())
        check(torch.equal(got.cpu(), want),
              f"matcher kernel differs from its plain version on {name}")
        print(f"train: matcher kernel equals its plain version bit for bit on "
              f"{name} {list(cost.shape)}", flush=True)
    P, R, C = costs.shape
    ms = cuda_ms(lambda: hg.batched_hungarian(costs))
    plain_ms = host_ms(lambda: hg.batched_hungarian_reference(costs),
                       costs.device, reps=3, warmup=1)
    host = costs.cpu().numpy()
    scipy_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for p in range(P):
            linear_sum_assignment(host[p])
        scipy_times.append((time.perf_counter() - t0) * 1e3)
    # bytes: the costs read once, col4row written once; the operations (at
    # most R (R + 1) / 2 Dijkstra steps of ~5 C flops a problem) take less
    # at the f32 rate, so bytes bound it
    bound_ms = (costs.numel() * 4 + P * R * 4) / 3.35e12 * 1e3
    row = dict(shape=[P, R, C], ms=ms, plain_ms=plain_ms,
               scipy_ms=statistics.median(scipy_times), bound_ms=bound_ms,
               bound_by="bytes")
    print(f"train: matcher kernel {list(costs.shape)}: {ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms (bytes), plain version on the card "
          f"{plain_ms:.3f} ms, scipy linear_sum_assignment on the host "
          f"{row['scipy_ms']:.3f} ms", flush=True)
    return row


def check_flash_gradients() -> float:
    """The Function's dQ, dK, dV (kernel forward, recomputing backward) at
    the three training shapes in bf16 and f32, against autograd through the
    plain version on f32 copies; returns the largest relative error."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for name, (b, h, sq, sk, d), _ in MAIN_SHAPES:
        for dtype, tol in ((torch.bfloat16, TOL_GRAD_BF16),
                           (torch.float32, TOL_GRAD_F32)):
            q, k, v = (t.requires_grad_() for t in
                       _inputs(gen, b, h, sq, sk, d, dtype, strided=True))
            g = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
            before = fa.flash_attention.launches
            fa.flash_attention(q, k, v).backward(g)
            check(fa.flash_attention.launches == before + 1,
                  f"{name}: the Function did not launch the kernel")
            refs = [t.detach().float().requires_grad_() for t in (q, k, v)]
            fa.flash_attention_reference(*refs).backward(g.float())
            errs = []
            for t, r in zip((q, k, v), refs):
                check(t.grad.dtype == dtype and t.grad.shape == t.shape,
                      f"{name}: gradient dtype or shape")
                errs.append(((t.grad.float() - r.grad).abs().max()
                             / r.grad.abs().max()).item())
            print(f"train: flash gradients {name} {[b, h, sq, sk, d]} "
                  f"{str(dtype)[6:]}: dQ {errs[0]:.2e} dK {errs[1]:.2e} dV "
                  f"{errs[2]:.2e} of the largest |gradient| (tol {tol})",
                  flush=True)
            check(max(errs) <= tol, f"{name}: Function gradients disagree")
            worst = max(worst, *errs)
            del q, k, v, g, refs
    torch.cuda.empty_cache()
    return worst


@contextlib.contextmanager
def tome_inputs(replay=None):
    """Records every token merge of the ViT (its similarity metric and
    mapping); with `replay`, an earlier run's records, each merge takes the
    recorded metric in turn, and so makes the recorded merges."""
    real, seen = vit_module.tome_merge, []

    def capture(x, metric, size, r):
        if replay is not None:
            metric = replay[len(seen)][0]
        out = real(x, metric, size, r)
        seen.append((metric.detach().clone(), out[2]))
        return out

    vit_module.tome_merge = capture
    try:
        yield seen
    finally:
        vit_module.tome_merge = real


@contextlib.contextmanager
def relu_gates(replay=None):
    """Records every F.relu's gate (x > 0) of the model; with `replay`, an
    earlier run's gates, each relu applies the recorded gate in turn (x
    times it), so that a pre-activation within rounding of 0 takes the
    same branch on both paths. Records the call's own gate either way."""
    real, seen = F.relu, []

    def gate(x, inplace=False):
        own = x > 0
        out = real(x) if replay is None else x * replay[len(seen)]
        seen.append(own)
        return out

    F.relu = gate
    try:
        yield seen
    finally:
        F.relu = real


def f32_paths_agree(cfg, text, data, n_categories, device,
                    levers=None) -> dict:
    """One f32 step on the kernel path and on the "torch" attention path,
    from the same seeded weights, with the model's `levers` (tome_r,
    decoder_pool). Where the model merges tokens, the torch path's own
    merges are first compared with the kernel path's (a near-tie of merge
    scores can flip one), and it then replays the kernel path's; with
    levers it also replays the kernel path's ReLU gates (`relu_gates`),
    counting the pre-activations whose sign differs on its own: one such
    near-tie in a decoder FFN can move that FFN's gradients by ~1e-2 of
    their largest (PERF.md). Each path's
    matching is compared on both
    paths' costs: where the two differ, each must be optimal on the other
    path's costs to within what the costs themselves differ by (a near-tie;
    bench.py's GT masks are random noise, so every query costs nearly the
    same against them). The torch path then replays the kernel path's
    matching, so that the loss and every parameter's gradient compare the
    attention paths alone. Every parameter gets a nonzero gradient, except
    ZERO_GRAD_PARAMS (zero on both paths): the check that catches a graph
    cut at the kernel."""
    model = ZUTIS(**cfg, **(levers or {}), dtype=torch.float32,
                  device=device).init_params(torch.Generator().manual_seed(0))
    text_d = torch.from_numpy(text).to(device)
    runs, seen, merges, gates = {}, {}, {}, {}
    for impl in ("auto", "torch"):
        set_attn_impl(model, impl)
        model.zero_grad(set_to_none=True)
        if impl == "torch" and merges["auto"]:  # its own merges, then replay
            with torch.no_grad(), tome_inputs() as own:
                model(data["image"])
            merges["torch own"] = own
        # the torch path replays the kernel path's matching and merges,
        # and with levers its ReLU gates
        replay_gates = gates.get("auto") if levers else None
        with matcher_inputs(seen.get("auto", (None, None))[1]) as calls, \
                tome_inputs(merges.get("auto")) as merged, \
                relu_gates(replay_gates) as gated:
            out = model(data["image"])
            loss = crit.criterion_loss(
                out["mask_proposals"], data["instance_masks"],
                data["instance_valid"], out["patch_tokens"],
                data["semantic_mask"], text_d, ignore_index=TRAIN_IGNORE)
            loss["loss"].backward()
        seen[impl] = calls[-1]
        merges[impl] = merged
        gates[impl] = gated
        runs[impl] = (loss["loss"].item(),
                      {n: None if p.grad is None else p.grad.clone()
                       for n, p in model.named_parameters()})
        del out, loss

    merges_differ = 0
    if merges["auto"]:
        merges_differ = sum(not torch.equal(a[1], b[1]) for a, b in
                            zip(merges["auto"], merges["torch own"]))
        moved = sum(int((a[1] != b[1]).sum()) for a, b in
                    zip(merges["auto"], merges["torch own"]))
        print(f"train: f32 ToMe merges: {merges_differ} of "
              f"{len(merges['auto'])} blocks' mappings differ between the "
              f"kernel and torch paths ({moved} token slots); the torch "
              "path replays the kernel path's merges", flush=True)
        check(all(torch.equal(a[1], b[1]) for a, b in
                  zip(merges["auto"], merges["torch"])),
              "the torch path did not replay the kernel path's merges")
    gate_flips = sum(int((a != b).sum())
                     for a, b in zip(gates["auto"], gates["torch"]))
    gate_count = sum(g.numel() for g in gates["auto"])
    print(f"train: f32 ReLU gates: {gate_flips} of {gate_count} differ "
          f"between the kernel and torch paths" + (
              "; the torch path replays the kernel path's" if levers else ""),
          flush=True)
    (ck, mk), (ct, mt) = seen["auto"], seen["torch"]
    mk, mt = mk.long(), mt.long()

    def total(c, m):
        return c.gather(-1, m[..., None])[..., 0].sum(-1)  # [P]

    cost_diff = (ck - ct).abs().max().item()
    n_differ = int((mk != mt).any(-1).sum())
    gap = max((total(ct, mk) - total(ct, mt)).max().item(),
              (total(ck, mt) - total(ck, mk)).max().item())
    allowed = 2 * ck.shape[1] * cost_diff + 1e-5
    print(f"train: f32 matchings: {n_differ} of {ck.shape[0]} problems differ "
          f"between the kernel and torch paths; costs differ by up to "
          f"{cost_diff:.3e}, and each path's matching is within {gap:.3e} of "
          f"the optimum on the other's costs (allowed {allowed:.3e})",
          flush=True)
    check(gap <= allowed, "a path's matching is not optimal on the other "
          "path's costs: more than a near-tie")

    (lk, gk), (lt, gt) = runs["auto"], runs["torch"]
    loss_rel = abs(lk - lt) / abs(lt)
    check(loss_rel <= TOL_STEP_LOSS,
          f"f32 losses differ by {loss_rel:.2e} (kernel {lk}, torch {lt})")
    worst = 0.0
    for name in gt:
        a, b = gk[name], gt[name]
        a_zero = a is None or not bool(a.abs().max() > 0)
        b_zero = b is None or not bool(b.abs().max() > 0)
        if name in ZERO_GRAD_PARAMS:
            check(a_zero and b_zero, f"{name} got a gradient")
            continue
        check(not a_zero, f"{name} gets no gradient on the kernel path")
        check(not b_zero, f"{name} gets no gradient on the torch path")
        err = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, err)
        check(err <= TOL_STEP_GRAD, f"{name}: f32 gradients differ by {err:.2e}")
    n = len(gt) - len(ZERO_GRAD_PARAMS)
    print(f"train: f32 kernel path vs torch attention on one matching: loss "
          f"{lk:.6f} vs {lt:.6f} ({loss_rel:.2e} rel), {n} parameters with "
          f"nonzero gradients on both, largest gradient difference {worst:.2e}"
          f" of the parameter's largest |gradient| (tol {TOL_STEP_GRAD})",
          flush=True)
    del model
    return dict(loss_kernel=lk, loss_torch=lt, loss_rel=loss_rel,
                grad_rel=worst, params_checked=n, matchings_differ=n_differ,
                cost_diff=cost_diff, matching_gap=gap,
                merges_differ=merges_differ, relu_gates_differ=gate_flips)


def phase_train(cfg: dict = VIT_B16, image_size: int = IMAGE_SIZE,
                batch: int = TRAIN_BATCH, n_categories: int = N_CATEGORIES,
                n_max: int = TRAIN_N_MAX, n_valid: int = TRAIN_VALID,
                steps: int = TRAIN_STEPS, base_lr: float = TRAIN_LR,
                device="cuda") -> dict:
    """The training step at full width (bench.py:174-201): a warm-up step
    and `steps` timed ones on one batch, every launch count set to 0 before
    and read per step (24 flash launches and one matcher launch a step, no
    probe); a finite loss that falls after the first update; bench.py's
    window rate; one step's dispatch from host arrays without a host sync;
    the Function's gradients; the matcher
    kernel against its plain version; the step's times, spans, device busy
    and peak memory; an f32 step on both attention paths."""
    t_phase = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    text, host = train_batch(cfg, image_size, batch, n_max, n_valid,
                             n_categories)
    data = upload_batch(host, device)
    model = ZUTIS(**cfg, dtype=torch.bfloat16, device=device).init_params(
        torch.Generator().manual_seed(0))
    state = TrainState.create(model, base_lr=base_lr, n_iters=TRAIN_ITERS)
    step = make_train_step(model, text, n_categories,
                           ignore_index=TRAIN_IGNORE, device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    counted = counted_wrappers()
    zero_counts()
    losses, step_ms, per_step = [], [], []
    for _ in range(steps + 1):  # the first warms up
        before = {n: w.launches for n, w in counted.items()}
        sync()
        t0 = time.perf_counter()
        m = step(state, data)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        per_step.append({n: w.launches - before[n] for n, w in counted.items()})
    launches = {n: w.launches for n, w in counted.items()}
    print(f"train: {steps + 1} steps, losses {json.dumps(losses)}", flush=True)
    print(f"train: launches in {steps + 1} steps: {json.dumps(launches)}",
          flush=True)
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(m["confusion"].sum().item() == data["semantic_mask"].lt(
        n_categories).sum().item(), "the confusion histogram misses pixels")
    if on_card:
        for n in per_step:
            check(n["flash_attention"] == LAUNCHES_PER_FORWARD,
                  f"{n['flash_attention']} flash launches in a step, expected "
                  f"{LAUNCHES_PER_FORWARD}")
            check(n["batched_hungarian"] == 1,
                  f"{n['batched_hungarian']} matcher launches in a step")
            check(sum(n[p] for p in PROBES) == 0, "a step launched a probe")

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = step(state, host)
        except RuntimeError as exc:
            fail(f"a training step's dispatch waits for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        m["loss"].item()
        print("train: a step's dispatch from host arrays (pinned uploads, "
              "forward, criterion with the matcher, backward, AdamW, PolyLR, "
              "confusion) makes no host-device synchronisation", flush=True)

    # bench.py:207-213's rate: `steps` steps queued back to back on the
    # batch already on the device, one read of the loss at the end
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, data)
    m["loss"].item()
    window_s = time.perf_counter() - t0

    # spans of one step, each ended by a synchronise (median of 3)
    text_d = torch.from_numpy(text).to(device)
    spans = {k: [] for k in ("forward", "criterion", "backward", "optimiser")}
    with matcher_inputs() as calls:
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            out = model(data["image"])
            sync()
            t1 = time.perf_counter()
            loss = crit.criterion_loss(
                out["mask_proposals"], data["instance_masks"],
                data["instance_valid"], out["patch_tokens"],
                data["semantic_mask"], text_d, ignore_index=TRAIN_IGNORE)
            sync()
            t2 = time.perf_counter()
            state.optimizer.zero_grad(set_to_none=True)
            loss["loss"].backward()
            sync()
            t3 = time.perf_counter()
            state.optimizer.step()
            state.scheduler.step()
            sync()
            t4 = time.perf_counter()
            for key, a, b in (("forward", t0, t1), ("criterion", t1, t2),
                              ("backward", t2, t3), ("optimiser", t3, t4)):
                spans[key].append((b - a) * 1e3)
            del out, loss
    spans = {k: statistics.median(v) for k, v in spans.items()}
    costs = calls[-1][0]
    check(tuple(costs.shape) == (cfg["n_decoder_layers"] * batch, n_max,
                                 cfg["n_queries"]),
          f"the matcher got {tuple(costs.shape)} in one call")

    stats = dict(losses=losses, launches=launches, spans_ms=spans,
                 step_ms=statistics.median(step_ms[1:]),
                 step_ms_all=step_ms, train_step_its_per_sec=steps / window_s)
    stats["iters_per_s"] = 1e3 / stats["step_ms"]
    if on_card:
        stats["flash_grad_max_rel_err"] = check_flash_gradients()
        stats["matcher"] = check_matcher(costs)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        step(state, data)
        torch.cuda.synchronize()
        stats["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        busy, top, by_name = profile_device(lambda: step(state, data), device,
                                            grad=True)
        stats.update(step_device_busy_ms=busy, step_top_kernels=top,
                     flash_in_step_ms=sum(ms for k, (ms, _) in by_name.items()
                                          if "flash" in k),
                     matcher_in_step_ms=sum(ms for k, (ms, _) in by_name.items()
                                            if "hungarian" in k))
    stats["f32_check"] = f32_paths_agree(cfg, text, data, n_categories, device)
    stats["phase_s"] = time.perf_counter() - t_phase
    # the first AdamW step (sign-like, every parameter at once) can raise
    # the loss; from there it must fall over the next four steps, and the
    # last step must end below the first
    check(losses[5] < losses[1] and losses[-1] < losses[0],
          f"the loss did not fall: {losses}")
    print(f"train rate: train_step_its_per_sec "
          f"{stats['train_step_its_per_sec']:.3f} ({steps} steps back to back, "
          f"one synchronise, as bench.py); {stats['iters_per_s']:.3f} iters/s "
          f"from the step's {stats['step_ms']:.3f} ms (host clock + sync each "
          f"step, median of {steps}); "
          f"spans {json.dumps(spans)} ms; device busy "
          f"{stats.get('step_device_busy_ms')} ms (flash "
          f"{stats.get('flash_in_step_ms')} ms, matcher "
          f"{stats.get('matcher_in_step_ms')} ms); peak memory "
          f"{stats.get('peak_memory_gib')} GiB; phase {stats['phase_s']:.1f} s",
          flush=True)
    return stats


# the opt-in levers (phase_levers): (tome_r, decoder_pool) pairs served at
# the serving cell, beside the pair without levers
LEVER_PAIRS = [(0, 1), (16, 1), (0, 2), (16, 2)]
LEVER_REQUESTS = 16  # two batch forwards a pair, and one synchronous infer
# the JAX eval tool's lever values (tools/instance_eval_bench.py:36-40)
EVAL_LEVERS = dict(tome_r=90, decoder_pool=2)
# the f32 padded forward with the levers, kernel path against the "torch"
# path on the same merges, relative to the largest |output|: the f32
# kernel's hi/lo splits carry ~16 mantissa bits through 12 merged blocks
TOL_LEVERS_F32 = 1e-3
# bench.py:174-201's training step with both levers
TRAIN_LEVERS = dict(tome_r=16, decoder_pool=2)
TRAIN_LEVER_STEPS = 2  # one warm-up, one more


def set_levers(model: ZUTIS, tome_r: int, decoder_pool: int) -> None:
    """The levers are plain attributes: one model serves every pair."""
    model.tome_r = model.encoder.tome_r = tome_r
    model.decoder_pool = decoder_pool


def merged_sizes(b: int, s0: int, r: int, blocks: int, valid=None,
                 seed: int = 0) -> torch.Tensor:
    """Token sizes [b, s0 - merged] after `blocks` merges of up to r tokens
    from sizes `valid` (ones without), on seeded random similarities: the
    sizes a ToMe encoder's last block attends with."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    size = (torch.ones(b, s0, device="cuda") if valid is None
            else valid.float().cuda())
    for r_eff in vit_module.merge_schedule(s0, r, blocks):
        s = size.shape[1]
        metric = torch.randn(b, s, 16, generator=gen, device="cuda")
        _, size, _ = vit_module.tome_merge(metric, metric, size, r_eff)
    return size


def pooled_counts(valid: torch.Tensor, hp: int, wp: int, p: int):
    """(kv_mask [b, cells], key_bias [b, cells]) of the padded pooled
    cross-attention for the memory's validity [b, hp * wp]."""
    b = valid.shape[0]
    count = valid.reshape(b, hp // p, p, wp // p, p).float().sum((2, 4))
    count = count.reshape(b, -1)
    return (count > 0).int(), torch.log(count.clamp(min=1.0))


def lever_flash_cases() -> list:
    """(name, [b, h, sq, sk, d], kv_mask or None, key_bias or None) of the
    levers' flash calls: the serving encoder under ToMe r 16 at its first
    and last block (577 and 401 tokens), the pooled cross-attention of
    decoder_pool 2 (576 keys, no bias), the eval encoder under ToMe r 90
    (1281 and 291 tokens, masked) and the padded pooled cross (1280 keys,
    masked, log(count))."""
    ones = torch.ones(BATCH, 577, device="cuda")
    last = merged_sizes(BATCH, 577, 16, 11)
    masks = {k: v.cuda() for k, v in
             eval_masks(eval_bench.bench_sizes(EVAL_BATCH)).items()}
    eval_last = merged_sizes(EVAL_BATCH, 1281, 90, 11, masks["encoder"])
    hp, wp = (2 * n // 16 for n in EVAL_SHAPE)
    cross_mask, cross_bias = pooled_counts(masks["memory"], hp, wp, 2)

    def prop(size):
        return torch.log(size.clamp(min=1.0))

    return [
        ("tome encoder self first", (BATCH, 12, 577, 577, 64), None,
         prop(ones)),
        ("tome encoder self last", (BATCH, 12, 401, 401, 64), None,
         prop(last)),
        ("pooled cross", (BATCH, 8, 100, 576, 96), None, None),
        ("eval tome encoder self first", (EVAL_BATCH, 12, 1281, 1281, 64),
         masks["encoder"], prop(masks["encoder"].float())),
        ("eval tome encoder self last", (EVAL_BATCH, 12, 291, 291, 64),
         (eval_last > 0).int(), prop(eval_last)),
        ("eval pooled cross", (EVAL_BATCH, 8, 100, 1280, 96), cross_mask,
         cross_bias),
    ]


def phase_levers_flash() -> tuple:
    """Each lever flash call against its plain version in bf16 (8e-3 of
    the largest |output|) and f32 (1e-4; split and unsplit), then timed in
    bf16 in a CUDA graph beside its bound (the valid keys; the bias's
    bytes), the plain version and SDPA given the same float mask (the bias,
    -inf where masked: a yardstick only)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, max_err = [], 0.0
    for name, (b, h, sq, sk, d), mask, bias in lever_flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _inputs(gen, b, h, sq, sk, d, dtype, strided=True)
            want = fa.flash_attention_reference(q.float(), k.float(),
                                                v.float(), mask, bias)
            scale = want.abs().max().item()
            splits = ([None] if dtype == torch.bfloat16
                      else [1, max(2, fa.key_splits(b, h, sq, sk, d))])
            for n in splits:
                got = fa._flash_forward(q, k, v, mask, n, key_bias=bias)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                ok = (err <= TOL_FLASH_BF16 * scale if dtype == torch.bfloat16
                      else err <= TOL_F32)
                print(f"kernel check {name} {[b, h, sq, sk, d]} "
                      f"{str(dtype)[6:]} splits {n}: max_abs_err {err:.3e} "
                      f"max_rel_err {err / scale:.3e}", flush=True)
                check(ok and bool(torch.isfinite(got).all()),
                      f"{name}: biased kernel disagrees with its plain version")
                max_err = max(max_err, err)
                del got
            del want
        # q, k, v in bf16 from here
        valid = b * sk if mask is None else int(mask.sum())
        bound_ms, bound_by = bound(b, h, sq, sk, d, valid_keys=valid,
                                   extra_bytes=0 if bias is None else 4 * b * sk)
        float_mask = None
        if bias is not None or mask is not None:
            float_mask = (torch.zeros(b, sk, device="cuda") if bias is None
                          else bias.clone())
            if mask is not None:
                float_mask = float_mask.masked_fill(mask == 0, float("-inf"))
            float_mask = float_mask[:, None, None, :].to(torch.bfloat16)
        big = b >= EVAL_BATCH
        row = dict(
            name=name, shape=[b, h, sq, sk, d], masked=mask is not None,
            biased=bias is not None, valid_keys=valid,
            ms=cuda_ms(lambda: fa.flash_attention(q, k, v, mask, bias)),
            plain_ms=cuda_ms(
                lambda: fa.flash_attention_reference(q, k, v, mask, bias),
                **(dict(calls=3, reps=5, warmup=1) if big else {})),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=float_mask)),
            bound_ms=bound_ms, bound_by=bound_by)
        if bias is not None:  # the same call without the bias, beside it
            row["unbiased_ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v,
                                                                    mask))
        rows.append(row)
        print(f"kernel time {name} {[b, h, sq, sk, d]}: kernel "
              f"{row['ms']:.4f} ms (unbiased {row.get('unbiased_ms')}), "
              f"plain {row['plain_ms']:.4f} ms, sdpa with the float mask "
              f"{row['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / row['ms']:.1%} of bound", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return rows, max_err


def _semantic_agreement(model, ref, x, text_d) -> tuple:
    """(kernel vs f32, torch path vs f32, f32 blocks merging otherwise)
    semantic agreement of one batch: `model` bf16 on the kernel and the
    "torch" paths, `ref` the f32 forward of the same weights on exact
    attention. Under ToMe the bf16 and f32 keys pick other merges (their
    own f32 merges are counted), so the torch path and the f32 forward
    replay the kernel path's."""
    def semantic(out):
        return torch.einsum("nc,bhwc->bnhw", text_d,
                            out["patch_tokens"]).argmax(1)

    with torch.inference_mode():
        with tome_inputs() as merges:
            sem_k = semantic(model(x, inference=True))
        replay = merges or None
        set_attn_impl(model, "torch")
        with tome_inputs(replay):
            sem_t = semantic(model(x, inference=True))
        set_attn_impl(model, "auto")
        differ = 0
        if merges:
            with tome_inputs() as own:
                ref(x, inference=True)
            differ = sum(not torch.equal(a[1], b[1])
                         for a, b in zip(merges, own))
        with tome_inputs(replay):
            sem_f = semantic(ref(x, inference=True))
    return ((sem_k == sem_f).float().mean().item(),
            (sem_t == sem_f).float().mean().item(), differ)


def phase_levers_serving(cfg: dict = VIT_B16, image_size: int = IMAGE_SIZE,
                         n_categories: int = N_CATEGORIES,
                         device="cuda") -> dict:
    """The serving cell with each lever pair: requests through the server
    with every launch count set to 0 before and read after (24 flash
    launches a batch forward, 12 of them biased under ToMe, no probe), the
    kernel path's semantic map against the f32 forward, the decode against
    a CPU rerun, and the rate, device busy and top kernels of a step."""
    device = torch.device(device)
    rng = np.random.RandomState(0)
    model = build_model(cfg, device)
    ref = ZUTIS(**cfg, dtype=torch.float32, attn_impl="torch", device=device)
    ref.load_state_dict(model.state_dict())
    text = rng.randn(n_categories, cfg["text_dim"]).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    text_d = torch.from_numpy(text).to(device)
    images = [rng.randn(3, image_size, image_size).astype(np.float32)
              for _ in range(LEVER_REQUESTS)]
    x = torch.from_numpy(np.stack(images[:BATCH])).to(device)
    out = {}
    for tome_r, pool in LEVER_PAIRS:
        key = f"tome_r {tome_r} decoder_pool {pool}"
        set_levers(model, tome_r, pool)
        set_levers(ref, tome_r, pool)
        with torch.inference_mode():
            proposals = model(x, inference=True)["mask_proposals"][:, -1]
        threshold = float(torch.quantile(proposals.flatten()[::7].float(), 0.9))
        server = InferenceServer(model, text, image_size=image_size,
                                 batch_size=BATCH, threshold=threshold,
                                 max_wait_ms=50, device=device)
        zero_counts()
        server.start()
        futures = [server.submit(im) for im in images]
        results = [f.result(timeout=600) for f in futures]
        server.stop()
        sync = server.infer(images[:BATCH])
        counts, masked = read_counts()
        biased = fa.flash_attention.biased_launches
        batches = server.batches
        check(len(results) == LEVER_REQUESTS and len(sync) == BATCH,
              f"{key}: not every request was answered")
        for a, b in zip(results[:BATCH], sync):
            check(np.array_equal(a["semantic"], b["semantic"])
                  and len(a["instances"]) == len(b["instances"]),
                  f"{key}: sync and async answers differ for the same batch")
        if device.type == "cuda":
            check(counts["flash_attention"] == LAUNCHES_PER_FORWARD * batches,
                  f"{key}: {counts['flash_attention']} flash launches for "
                  f"{batches} batch forwards")
            check(biased == (12 * batches if tome_r else 0) and masked == 0,
                  f"{key}: {biased} biased and {masked} masked launches for "
                  f"{batches} batch forwards")
            check(sum(counts[p] for p in PROBES) == 0,
                  f"{key}: serving launched a probe kernel")
            check(counts["mask_nms"] == batches
                  and counts["pairwise_iou"] == batches,
                  f"{key}: {counts['mask_nms']} NMS and "
                  f"{counts['pairwise_iou']} IoU launches for {batches} "
                  "serving steps")
        agree_kf, agree_tf, differ = _semantic_agreement(model, ref, x,
                                                         text_d)
        print(f"levers serving {key}: {batches} batch forwards, "
              f"{counts['flash_attention']} flash launches ({biased} biased); "
              f"semantic agreement with the f32 forward on the kernel path's "
              f"merges: kernel path {agree_kf:.4%}, torch path "
              f"{agree_tf:.4%} (f32 merging otherwise on its own in "
              f"{differ} blocks)", flush=True)
        check(agree_kf >= MIN_SEMANTIC_AGREEMENT,
              f"{key}: kernel path's semantic map disagrees with the f32 forward")
        check(agree_kf >= agree_tf - SEMANTIC_SLACK,
              f"{key}: kernel path further from the f32 forward than torch's")
        binary = proposals > threshold
        decoded = []
        with torch.inference_mode():
            tokens = model(x, inference=True)["patch_tokens"]
            for dev in (device, torch.device("cpu")):
                conf, cats = classify_proposals(
                    proposals.to(dev), binary.to(dev), tokens.to(dev),
                    text_d.to(dev), server.temperature)
                keep, scores = mask_nms(binary.to(dev), conf, cats,
                                        nms_threshold=server.nms_threshold)
                decoded.append((keep.cpu(), cats.cpu(), scores.cpu()))
        (keep_d, cats_d, _), (keep_c, cats_c, _) = decoded
        check(torch.equal(keep_d, keep_c) and torch.equal(cats_d, cats_c),
              f"{key}: the card's decode differs from the CPU rerun")
        infer_ms = host_ms(lambda: server.infer(images[:2 * BATCH]), device,
                           reps=3, warmup=1)
        busy, top, by_name = profile_device(lambda: server.step(x), device,
                                            top=6)
        out[key] = dict(
            img_per_s=2 * BATCH / (infer_ms / 1e3), ms_per_batch=infer_ms / 2,
            step_device_busy_ms=busy, step_top_kernels=top,
            flash_in_step_ms=sum(ms for k, (ms, _) in by_name.items()
                                 if "flash" in k),
            launches=counts["flash_attention"], biased_launches=biased,
            nms_launches=counts["mask_nms"],
            iou_launches=counts["pairwise_iou"],
            batches=batches, agreement_kernel_f32=agree_kf,
            agreement_torch_f32=agree_tf, f32_blocks_merging_otherwise=differ,
            kept=int(keep_d.sum()))
        print(f"levers serving rate {key}: {out[key]['img_per_s']:.2f} img/s "
              f"sync infer, device busy in a step {busy} ms (flash "
              f"{out[key]['flash_in_step_ms']} ms)", flush=True)
    del model, ref
    torch.cuda.empty_cache()
    return out


def phase_levers_eval(cfg: dict = VIT_B16, device="cuda") -> dict:
    """The bucketed eval with the JAX tool's levers: the f32 padded forward
    on the kernel path against the "torch" path on the kernel path's merges
    (their own merges compared first); 64 images through evaluate_instances
    with every launch count set to 0 before and read after (24 flash
    launches a padded forward, 18 masked and 18 biased); the tool's img/s
    at depth 1."""
    device = torch.device(device)
    sizes = eval_bench.bench_sizes(EVAL_BATCH)
    text = eval_bench.text_embeddings(eval_bench.N_CATEGORIES, cfg["text_dim"])
    rng = np.random.RandomState(3)
    images = [rng.randn(3, h, w).astype(np.float32) for h, w in sizes[:3]]
    padded, grid, _ = BE.pad_batch(images, EVAL_SHAPE, 3, 16)
    f32 = build_model(cfg, device, torch.float32, **EVAL_LEVERS)
    xs = torch.from_numpy(padded).to(device)
    with torch.inference_mode(), tome_inputs() as merges_k:
        out_k = f32.forward_padded(xs, grid)
    set_attn_impl(f32, "torch")
    with torch.inference_mode(), tome_inputs() as own:
        f32.forward_padded(xs, grid)
    with torch.inference_mode(), tome_inputs(merges_k):
        out_t = f32.forward_padded(xs, grid)
    del f32
    differ = sum(not torch.equal(a[1], b[1]) for a, b in zip(merges_k, own))
    worst = {}
    for key in ("patch_tokens", "mask_proposals"):
        a, b = out_k[key], out_t[key]
        worst[key] = ((a - b).abs().max() / b.abs().max()).item()
    print(f"levers eval: f32 padded forward with {EVAL_LEVERS}, kernel path "
          f"against the torch path: {differ} of {len(merges_k)} blocks' "
          f"merges differ on their own (replayed); max rel diff "
          f"{json.dumps(worst)} (tol {TOL_LEVERS_F32})", flush=True)
    check(max(worst.values()) <= TOL_LEVERS_F32,
          "the f32 padded forward with the levers differs between paths")
    del out_k, out_t
    torch.cuda.empty_cache()

    model = build_model(cfg, device, **EVAL_LEVERS)
    rng = np.random.RandomState(4)
    u8 = [rng.randint(0, 256, (3, h, w)).astype(np.uint8)
          for h, w in sizes + sizes]
    ids = list(range(1, EVAL_IMAGES + 1))
    pad8, grid8, pix8 = BE.pad_batch(u8[:EVAL_BATCH], EVAL_SHAPE, EVAL_BATCH,
                                     16, np.uint8)
    with torch.inference_mode():
        x = BE._normalise_u8(torch.from_numpy(pad8).to(device))
        thr = _threshold(model.forward_padded(x, grid8)["mask_proposals"][:, -1])
    zero_counts()
    preds = BE.evaluate_instances(model, text, u8, ids,
                                  batch_images=EVAL_BATCH, depth=2,
                                  threshold=thr, device=device)
    counts, masked = read_counts()
    biased = fa.flash_attention.biased_launches
    batches = EVAL_IMAGES // EVAL_BATCH
    print(f"levers eval: evaluate_instances with {EVAL_LEVERS} on "
          f"{EVAL_IMAGES} images: {len(preds)} predictions, "
          f"{counts['flash_attention']} flash launches ({masked} masked, "
          f"{biased} biased) for {batches} padded forwards", flush=True)
    if device.type == "cuda":
        check(counts["flash_attention"] == EVAL_LAUNCHES * batches,
              f"{counts['flash_attention']} flash launches for {batches} "
              "padded forwards")
        check(masked == 18 * batches and biased == 18 * batches,
              f"{masked} masked and {biased} biased launches: expected 18 "
              "and 18 a forward (12 encoder, 6 pooled cross)")
        check(sum(counts[p] for p in PROBES) == 0, "the eval launched a probe")
        check(counts["mask_nms"] == batches
              and counts["pairwise_iou"] == batches,
              f"{counts['mask_nms']} NMS and {counts['pairwise_iou']} IoU "
              f"launches for {batches} eval steps")
    check(len(preds) > 0, "evaluate_instances returned no prediction")
    rate = eval_bench.run(EVAL_BATCH, "counts", 12, 1, device, model=model,
                          threshold=thr)["value"]
    step = BE.make_instance_step(model, text, EVAL_SHAPE, threshold=thr,
                                 uint8_input=True, semantic_mode="none",
                                 device=device)
    busy, top, by_name = profile_device(lambda: step(pad8, grid8, pix8),
                                        device, top=6)
    del model
    torch.cuda.empty_cache()
    return dict(img_per_s_depth_1=rate, launches=counts["flash_attention"],
                masked_launches=masked, biased_launches=biased,
                nms_launches=counts["mask_nms"],
                iou_launches=counts["pairwise_iou"],
                batches=batches, predictions=len(preds),
                f32_check=dict(worst, merges_differ=differ),
                step_device_busy_ms=busy, step_top_kernels=top,
                flash_in_step_ms=sum(ms for k, (ms, _) in by_name.items()
                                     if "flash" in k))


def phase_levers_train(cfg: dict = VIT_B16, image_size: int = IMAGE_SIZE,
                       batch: int = TRAIN_BATCH,
                       n_categories: int = N_CATEGORIES,
                       device="cuda") -> dict:
    """bench.py:174-201's training step with both levers: finite losses
    and the launches of each step (24 flash, 12 biased, 1 matcher, no
    probe), its time; then one f32 step on the kernel and the "torch"
    paths, on the same merges and matching, at phase 7's tolerances."""
    device = torch.device(device)
    text, host = train_batch(cfg, image_size, batch, TRAIN_N_MAX,
                             TRAIN_VALID, n_categories)
    data = upload_batch(host, device)
    model = ZUTIS(**cfg, **TRAIN_LEVERS, dtype=torch.bfloat16,
                  device=device).init_params(torch.Generator().manual_seed(0))
    state = TrainState.create(model, base_lr=TRAIN_LR, n_iters=TRAIN_ITERS)
    step = make_train_step(model, text, n_categories,
                           ignore_index=TRAIN_IGNORE, device=device)
    counted = counted_wrappers()
    zero_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_LEVER_STEPS):
        before = {n: w.launches for n, w in counted.items()}
        biased_before = fa.flash_attention.biased_launches
        _sync(device)
        t0 = time.perf_counter()
        m = step(state, data)
        losses.append(m["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        n = {k: w.launches - before[k] for k, w in counted.items()}
        biased = fa.flash_attention.biased_launches - biased_before
        if device.type == "cuda":
            check(n["flash_attention"] == LAUNCHES_PER_FORWARD
                  and biased == 12 and n["batched_hungarian"] == 1
                  and sum(n[p] for p in PROBES) == 0,
                  f"a lever step launched {n} ({biased} biased flash)")
    check(all(np.isfinite(losses)), f"a lever step's loss is not finite: {losses}")
    launches = {k: w.launches for k, w in counted.items()}
    print(f"levers train {TRAIN_LEVERS}: losses {json.dumps(losses)}, "
          f"launches {json.dumps(launches)}, step {step_ms[-1]:.3f} ms",
          flush=True)
    del model, state, step
    torch.cuda.empty_cache()
    f32_check = f32_paths_agree(cfg, text, data, n_categories, device,
                                levers=TRAIN_LEVERS)
    return dict(losses=losses, launches=launches, step_ms=step_ms[-1],
                biased_launches=fa.flash_attention.biased_launches,
                f32_check=f32_check)


def phase_levers(device="cuda") -> dict:
    """The opt-in levers (tome_r, decoder_pool) on the card: their flash
    calls against the plain version and timed, the serving cell with each
    lever pair, the bucketed eval and a training step with them."""
    t0 = time.perf_counter()
    rows, max_err = phase_levers_flash()
    out = dict(flash_rows=rows, flash_max_abs_err=max_err,
               serving=phase_levers_serving(device=device),
               eval=phase_levers_eval(device=device),
               train=phase_levers_train(device=device))
    zero_counts()  # the lever paths are read; later phases count from 0
    out["phase_s"] = time.perf_counter() - t0
    print(f"levers: phase {out['phase_s']:.1f} s", flush=True)
    return out


# the Trainer at the shipped config configs/coco2017_val_imagenet_pass_n500_
# vit_b_16.yaml (ViT-B/16, 384 px, batch 8, coco81, ignore_index 255, bf16),
# with a 6-iteration schedule that logs, evaluates and checkpoints twice;
# mesh_axes dropped (phase_parallel trains the CLI on a mesh of one)
TRAINER_CONFIG = Path(__file__).resolve().parent / "configs" / (
    "coco2017_val_imagenet_pass_n500_vit_b_16.yaml")
TRAINER_SCHEDULE = dict(n_iters=6, iter_log=2, iter_eval=3,
                        checkpoint_every=3)
TRAINER_VAL_IMAGES = 16
TRAINER_SEED = 1000  # batch t is train_batch(..., seed=TRAINER_SEED + t)
# the resumed run against the straight one, as a multiple of the largest
# parameter difference between two straight runs (atomics in the backward);
# equal to the bit where the straight runs are
RESUME_SPREAD_FACTOR = 4.0


class _CocoVal:
    """coco2017 validation samples in memory at the eval bench's native
    sizes: normalised random images, two or three boxes each with COCO
    categories as the semantic mask and as GT instances, whose annotations
    go to a JSON file under `root`."""
    name = "coco2017"

    def __init__(self, root: str, n: int, n_categories: int):
        self.n_categories = n_categories
        rng = np.random.RandomState(8)
        self.samples, images, anns = [], [], []
        for i, (h, w) in enumerate(eval_bench.bench_sizes(n)):
            sem = np.zeros((h, w), np.int32)
            for _ in range(2 + i % 2):
                cat = int(rng.randint(1, n_categories))
                y0, x0 = rng.randint(0, h - 64), rng.randint(0, w - 64)
                y1, x1 = y0 + rng.randint(32, 200), x0 + rng.randint(32, 200)
                m = np.zeros((h, w), np.uint8)
                m[y0:y1, x0:x1] = 1
                sem[m > 0] = cat
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": new_label_id_to_old_label_id[cat],
                             "iscrowd": 0, "segmentation": rle.encode(m),
                             "area": int(m.sum())})
            self.samples.append({
                "image": rng.randn(3, h, w).astype(np.float32),
                "semantic_mask": sem, "image_id": i + 1})
            images.append({"id": i + 1, "height": h, "width": w})
        self.p_annotations = os.path.join(root, "instances_val2017.json")
        with open(self.p_annotations, "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": new_label_id_to_old_label_id[c]}
                                      for c in range(1, n_categories)]}, f)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f.read().split("\n")]


def _max_param_diff(a: torch.nn.Module, b: torch.nn.Module) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a.state_dict().values(),
                               b.state_dict().values()))


FIGURE_STEMS = ("semantic", "queries", "matched")


def figure_names(log_points, matched=None) -> list:
    """The JAX Trainer's figure files at these log points; `matched`: the
    log points with a matched-pairs figure (all of them by default)."""
    matched = log_points if matched is None else matched
    return [f"{stem}_{k:05d}.png" for k in log_points for stem in FIGURE_STEMS
            if stem != "matched" or k in matched]


def check_figures(run_dir: str, names: list, image_hw: tuple,
                  proposal_hw: tuple, n_queries: int, n_max: int) -> None:
    """Each figure decodes through read_png to a size its layout gives:
    the triptych of three images, the query grid of n_queries tiles ten to
    a row, matched pairs of 1 to n_max rows of two images (under titles
    of any query index, which may be wider than small images)."""
    (h, w), (ph, pw) = image_hw, proposal_hw
    cells = {"semantic": [visualiser.layout([(t, h, w) for t in (
                 "input", "ground truth", "prediction")], 3)[0]],
             "queries": [visualiser.layout(
                 [(str(i), ph, pw) for i in range(n_queries)]
                 + [None] * (-n_queries % 10), 10)[0]],
             "matched": [visualiser.layout(
                 [("gt 0", h, w), (f"query {q}", h, w)] * n, 2)[0]
                 for n in range(1, n_max + 1) for q in (0, 10, 100)
                 if q < n_queries]}
    for name in names:
        image = read_png(os.path.join(run_dir, name))
        check(image.dtype == np.uint8 and image.ndim == 3
              and image.shape[:2] in cells[name.split("_")[0]],
              f"{name} decodes to {image.dtype} {image.shape}")


@contextlib.contextmanager
def figure_record():
    """While open, each `Trainer._visualise_train` call (a log point's
    figures, `Trainer.fit`'s or a CLI's) appends a record to the yielded
    list: its iteration; whether the batch's first image has a valid
    instance, and so a matched-pairs figure is due; the flash and matcher
    launches it made (the counts read before and after it, not zeroed);
    its seconds. On the writer also its files, matched rows and the host
    ms of its parts, its matcher's assignment held to the plain version on
    the same costs (on the card where the Trainer runs)."""
    calls, real = [], Trainer._visualise_train

    def recorded(self, batch, num_iter, ignore_index):
        valid = batch["instance_valid"][0]
        matched = bool((valid.cpu().numpy() if torch.is_tensor(valid)
                        else np.asarray(valid)).any())
        before = read_counts()[0]
        t0 = time.perf_counter()
        real(self, batch, num_iter, ignore_index)
        _sync(self.device)
        seconds = time.perf_counter() - t0
        after = read_counts()[0]
        call = dict(num_iter=num_iter, matched=matched, seconds=seconds,
                    launches={k: after[k] - before[k]
                              for k in ("flash_attention",
                                        "batched_hungarian")})
        if self._writer:
            rec = self.last_visualisation
            check(rec is not None and rec["num_iter"] == num_iter,
                  f"Trainer.fit drew no figures at log point {num_iter}")
            check((rec["cost"] is not None) == matched,
                  f"matched pairs at {num_iter}: due {matched}, drawn "
                  f"{rec['cost'] is not None}")
            if matched:
                plain = hg.batched_hungarian_reference(
                    rec["cost"]).cpu().numpy()
                check(np.array_equal(plain, rec["assignment"][None]),
                      f"the figures' matcher at {num_iter}: "
                      f"{rec['assignment']} against the plain version's "
                      f"{plain}")
            call.update(
                files=[os.path.basename(f) for f in rec["files"]],
                rows=int(rec["cost"].shape[-2]) if matched else 0,
                **{f"{part}_ms": rec[f"{part}_s"] * 1e3
                   for part in ("forward", "matcher", "compose", "write")})
        calls.append(call)

    Trainer._visualise_train = recorded
    try:
        yield calls
    finally:
        Trainer._visualise_train = real


def check_figure_launches(figures: list, where: str) -> None:
    """Each log point's figures launched flash 24 times (their forward)
    and the matcher once where matched pairs were due, else not."""
    for f in figures:
        want = {"flash_attention": LAUNCHES_PER_FORWARD,
                "batched_hungarian": int(f["matched"])}
        check(f["launches"] == want, f"{where}: the figures at log point "
              f"{f['num_iter']} launched {f['launches']}, expected {want}")


def rate_without_figures(log: dict, figures: list,
                         start_iter: int = 0) -> float:
    """A training_metrics.json record's iters_per_sec with the seconds of
    the same run's figures drawn before it (a log point's figures follow
    its record) taken out of its window."""
    n = log["num_iter"] - start_iter
    return n / (n / log["iters_per_sec"] - sum(
        f["seconds"] for f in figures if f["num_iter"] < log["num_iter"]))


def phase_trainer(train_stats: dict, model_cfg: dict = VIT_B16,
                  image_size: int = 0, val_images: int = TRAINER_VAL_IMAGES,
                  device="cuda") -> dict:
    """Trainer.fit and evaluate at the shipped config's widths: the main
    run (6 iterations; logs with the figures at 2, 4, 6; evaluations and
    full-state checkpoints at 3 and 6, each evaluation 16 images through
    the bucketed eval and COCO scoring) with every launch count set to 0
    before and read after, its quiet iterations after the first under the
    sync debug mode "error"; at each log point the figures' matcher held
    to its plain version, and each figure decoded;
    a second straight run for the spread; the run resumed from the main
    run's step-3 checkpoint in a fresh model, held to that spread; a
    checkpoint's write and restore seconds and bytes, and an .npz
    export's; peak memory.
    `model_cfg` and `image_size` (0: the config's) shrink it for a
    rehearsal on the CPU, where the card's checks are left out."""
    t_phase = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = Config.load(str(TRAINER_CONFIG), skip_pretrained=True)
    cfg = dataclasses.replace(cfg, mesh_axes={}, **TRAINER_SCHEDULE)
    batch = cfg.train_dataloader_kwargs["batch_size"]
    check((cfg.clip_arch, cfg.train_image_size, batch, cfg.n_categories,
           len(cfg.categories), cfg.ignore_index, cfg.compute_dtype)
          == ("ViT-B/16", 384, 8, 81, 81, 255, "bfloat16")
          and cfg.extras == {"skip_pretrained": True},
          f"the shipped config loaded as {cfg}")
    dtype = getattr(torch, cfg.compute_dtype)
    text = eval_bench.text_embeddings(cfg.n_categories,
                                      model_cfg["text_dim"], seed=5)
    batches = [train_batch(model_cfg, image_size or cfg.train_image_size,
                           batch, TRAIN_N_MAX, TRAIN_VALID, cfg.n_categories,
                           seed=TRAINER_SEED + t)[1]
               for t in range(cfg.n_iters)]
    fit_kw = dict(n_iters=cfg.n_iters, n_categories=cfg.n_categories,
                  ignore_index=cfg.ignore_index,
                  weight_ce_loss=cfg.weight_ce_loss, iter_log=cfg.iter_log)

    def quiet(k):  # an iteration with no log, evaluation or checkpoint
        return k <= cfg.n_iters and all(
            k % e for e in (cfg.iter_log, cfg.iter_eval, cfg.checkpoint_every))

    def sync_mode(next_iter):
        """The next iteration runs under the sync debug mode "error" if it
        is quiet: its step and the lag-2 loss read must not sync."""
        if on_card:
            torch.cuda.set_sync_debug_mode("error" if quiet(next_iter)
                                           else "default")

    def fresh():
        model = ZUTIS(**model_cfg, dtype=dtype, device=device).init_params(
            torch.Generator().manual_seed(0))
        return model, TrainState.create(model, base_lr=TRAIN_LR,
                                        n_iters=cfg.n_iters)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def fit(trainer, state, **kw):
        """`trainer.fit` with the quiet iterations after the first under
        the sync debug mode "error" (the first initialises AdamW's
        state)."""
        sync()
        try:
            return trainer.fit(state, iter(batches[state.step:]),
                               eval_every_cb=lambda k, _: sync_mode(k + 1),
                               **fit_kw, **kw)
        except RuntimeError as exc:
            if "synchroniz" in str(exc):
                fail(f"a quiet iteration of Trainer.fit waits for the card: "
                     f"{exc}")
            raise
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        dir_ckpt, ckpt = os.path.join(root, "run"), os.path.join(root, "ckpt")
        os.makedirs(dir_ckpt)
        val = _CocoVal(root, val_images, cfg.n_categories)
        model_a, state_a = fresh()
        trainer = Trainer(model_a, text, dir_ckpt=dir_ckpt, device=device)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        t0 = time.perf_counter()
        with figure_record() as visualised:
            fit(trainer, state_a, iter_eval=cfg.iter_eval, val_dataset=val,
                checkpoint_every=cfg.checkpoint_every, checkpoint_dir=ckpt,
                visualise=True)
        sync()
        fit_s = time.perf_counter() - t0
        launches, masked = read_counts()
        peak_gib = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                    if on_card else None)
        n_evals = cfg.n_iters // cfg.iter_eval
        log_points = list(range(cfg.iter_log, cfg.n_iters + 1, cfg.iter_log))
        check([v["num_iter"] for v in visualised] == log_points,
              f"figures at {[v['num_iter'] for v in visualised]}")
        print(f"trainer: fit of {cfg.n_iters} iterations in {fit_s:.3f} s; "
              f"launches {json.dumps(launches)} ({masked} masked flash)",
              flush=True)
        if on_card:
            check(launches["flash_attention"] == LAUNCHES_PER_FORWARD * (
                cfg.n_iters + n_evals + len(log_points)),
                f"{launches['flash_attention']} flash launches: expected "
                f"{LAUNCHES_PER_FORWARD} a step, a padded forward and a "
                "log point's figures")
            check(masked == EVAL_MASKED_LAUNCHES * n_evals,
                  f"{masked} masked flash launches in {n_evals} evaluations")
            check(launches["batched_hungarian"] == cfg.n_iters
                  + len(log_points), "one matcher launch a step and a log "
                  "point's figures")
            check(sum(launches[p] for p in PROBES) == 0,
                  "fit launched a probe")
            check_figure_launches(visualised, "Trainer.fit")

        # the artifacts, as the JAX Trainer writes them
        names = sorted(os.listdir(dir_ckpt))
        check(names == sorted(
            ["best_model.npz", "eval_coco_style_metrics.json",
             "eval_metrics.json", "final_model.npz", "latest_model.npz",
             "training_metrics.json"] + [
                f"instance_predictions_{k:05d}.json"
                for k in range(cfg.iter_eval, cfg.n_iters + 1, cfg.iter_eval)]
              + figure_names(log_points)), f"the run wrote {names}")
        size = image_size or cfg.train_image_size
        tokens = 2 * size // model_cfg["patch_size"]
        check_figures(dir_ckpt, figure_names(log_points), (size, size),
                      (tokens, tokens), model_cfg["n_queries"], TRAIN_N_MAX)
        check(all(v["matched"] and v["rows"] == TRAIN_VALID
                  for v in visualised),
              f"matched rows {[v['rows'] for v in visualised]}")
        logs = _read_jsonl(os.path.join(dir_ckpt, "training_metrics.json"))
        check([r["num_iter"] for r in logs] == list(
            range(cfg.iter_log, cfg.n_iters + 1, cfg.iter_log)),
            "training_metrics.json's iterations")
        for r in logs:
            check(all(np.isfinite(r[k]) for k in ("loss", "ce_loss",
                                                   "mask_loss")),
                  f"a logged loss is not finite: {r}")
            check({"Mean IoU", "Pixel Acc", "0", "80"} <= set(r),
                  "training_metrics.json lacks a score")
        evals = _read_jsonl(os.path.join(dir_ckpt, "eval_metrics.json"))
        coco = _read_jsonl(os.path.join(dir_ckpt,
                                        "eval_coco_style_metrics.json"))
        check(len(evals) == len(coco) == n_evals
              and all("index error" not in c for c in coco),
              f"evaluations: {evals} {coco}")
        n_preds = []
        for k in range(cfg.iter_eval, cfg.n_iters + 1, cfg.iter_eval):
            with open(os.path.join(
                    dir_ckpt, f"instance_predictions_{k:05d}.json")) as f:
                n_preds.append(len(json.load(f)))
        with np.load(os.path.join(dir_ckpt, "final_model.npz")) as final:
            check(sorted(final.files) == sorted(model_a.state_dict()),
                  "final_model.npz keys")
            for k in ("encoder.proj", "query_embed"):
                check(np.array_equal(final[k], model_a.state_dict()[k].cpu()
                                     .float().numpy()), f"final_model.npz {k}")

        # a checkpoint's write and restore
        t0 = time.perf_counter()
        save_train_state(os.path.join(root, "timed"), state_a)
        write_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(os.path.join(root, "timed", "state.pt"))
        shutil.rmtree(os.path.join(root, "timed"))
        # and one reference-layout export, as fit writes latest_model.npz
        t0 = time.perf_counter()
        trainer.save_checkpoint(state_a, "timed_export")
        export_s = time.perf_counter() - t0
        export = os.path.join(dir_ckpt, "timed_export.npz")
        export_bytes = os.path.getsize(export)
        os.remove(export)

        # the spread of two straight runs, then the resumed one
        model_b, state_b = fresh()
        fit(Trainer(model_b, text, device=device), state_b)
        spread = _max_param_diff(model_a, model_b)
        del model_b, state_b
        model_r, state_r = fresh()
        sync()
        t0 = time.perf_counter()
        check(restore_train_state(os.path.join(ckpt, "step_3"), state_r)
              is state_r and state_r.step == 3, "restore from step_3")
        sync()
        restore_s = time.perf_counter() - t0
        fit(Trainer(model_r, text, device=device), state_r)
        diff = _max_param_diff(model_a, model_r)
        bound = RESUME_SPREAD_FACTOR * spread
        print(f"trainer: resume: the run restored from step 3 differs from "
              f"the straight run by {diff:.3e} at most (parameters after "
              f"{cfg.n_iters} steps); two straight runs differ by "
              f"{spread:.3e}; bound {'0 (bit-equal)' if spread == 0 else f'{RESUME_SPREAD_FACTOR} x spread = {bound:.3e}'}",
              flush=True)
        check(diff <= bound if spread > 0 else diff == 0.0,
              "the resumed run left the straight runs' spread")
        del model_r, state_r

    rate = logs[-1]["iters_per_sec"]
    out = dict(config=str(TRAINER_CONFIG.name), fit_s=fit_s,
               fit_iters_per_sec=rate,
               fit_iters_per_sec_without_figures=rate_without_figures(
                   logs[-1], visualised),
               train_step_its_per_sec=train_stats["train_step_its_per_sec"],
               step_iters_per_s=train_stats["iters_per_s"],
               eval_images_per_sec=[e["eval_images_per_sec"] for e in evals],
               eval_predictions=n_preds, coco=coco[-1],
               losses=[r["loss"] for r in logs],
               checkpoint_write_s=write_s, checkpoint_restore_s=restore_s,
               checkpoint_bytes=ckpt_bytes, export_s=export_s,
               export_bytes=export_bytes, resume_max_diff=diff,
               straight_spread=spread, resume_bound=bound,
               launches=launches, masked_launches=masked,
               visualised=visualised, peak_memory_gib=peak_gib,
               phase_s=time.perf_counter() - t_phase)
    print(f"trainer rate: fit {rate:.3f} iters/s over {cfg.n_iters} "
          f"iterations with {len(logs)} logs, {n_evals} evaluations and "
          f"{n_evals} checkpoints, "
          f"{out['fit_iters_per_sec_without_figures']:.3f} without the "
          f"figures' seconds before the last log (phase_train: "
          f"{out['train_step_its_per_sec']:.3f} steps/s back to back, "
          f"{out['step_iters_per_s']:.3f} synchronised); eval "
          f"{json.dumps(out['eval_images_per_sec'])} img/s; checkpoint "
          f"{ckpt_bytes} bytes, write {write_s:.3f} s, restore "
          f"{restore_s:.3f} s; an .npz export {export_bytes} bytes, "
          f"{export_s:.3f} s; peak memory {peak_gib} GiB; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


# the two CLIs on images from disk: a fixture dataset built from the
# committed JPEGs (tests/torch_fixtures), the shipped config's model and
# Trainer schedule (TRAINER_SCHEDULE), its categories through a text-
# embedding .npz and no CLIP weights (skip_pretrained)
FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures"
CLI_CATEGORIES = ("person", "dog", "kite", "cup")  # of the config's coco81
CLI_PER_CATEGORY = 6  # 24 training images at ImageNet's 500 x 375
CLI_VAL_IMAGES = 16  # every fourth the 640 x 480 fixture, the rest 500 x 375
CLI_BATCH_IMAGES = 16  # the eval CLI's batch, as Trainer.evaluate's
CLI_OVERLAYS = 2  # the eval CLI's --visualise_first
LOADER_SAMPLES = 12  # IndexDataset.sample timed one at a time
LOADER_PARTS = {  # a sample's parts: (file, function) under cProfile
    "resample": ("transforms.py", "_pass"),
    "decode": ("image.py", "decode_jpeg_rgb"),
    "hue": ("image.py", "hue_shift"),
    "blur": ("image.py", "gaussian_blur"),
    "pseudo-mask RLE": ("rle.py", "decode"),
    "crop": ("augment.py", "random_crop"),
    "copy_paste": ("augment.py", "copy_paste"),
}


def check_fixture_decodes(reps: int = 20) -> dict:
    """Every committed fixture image through the port's decoder, held to
    Pillow's pinned SHA-256 (tests/torch_fixtures/expected.json); the decode
    time of the 500 x 375 4:2:0 JPEG and of the largest fixture."""
    from zutis_tpu_torch.data.image_io import read_png, read_rgb

    expected = json.loads((FIXTURES / "expected.json").read_text())
    for name, want in sorted(expected.items()):
        path = FIXTURES / name
        arr = np.ascontiguousarray(
            read_png(path) if path.suffix == ".png" else read_rgb(path))
        got = (list(arr.shape), str(arr.dtype),
               hashlib.sha256(arr.tobytes()).hexdigest())
        check(got == (want["shape"], want["dtype"], want["sha256"]),
              f"the decoder disagrees with Pillow on {name}: {got[:2]} "
              f"against {want['shape']} {want['dtype']}")
    jpegs = [n for n in expected if n.endswith(".jpg")]
    largest = max(jpegs, key=lambda n: expected[n]["shape"][0]
                  * expected[n]["shape"][1])
    timed = {}
    for name in ("photo_0_420_q75.jpg", largest):
        path = FIXTURES / name
        read_rgb(path)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            read_rgb(path)
            times.append((time.perf_counter() - t0) * 1e3)
        timed[name] = statistics.median(times)
    print(f"cli: decoder: {len(expected)} fixtures equal Pillow's pinned "
          f"hashes; decode ms (median of {reps}): {json.dumps(timed)}",
          flush=True)
    return {"fixtures": len(expected), "decode_ms": timed}


def _polygon(rng, h: int, w: int) -> list:
    cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
    r = rng.uniform(0.08, 0.3) * min(h, w)
    angles = np.sort(rng.uniform(0, 2 * np.pi, 9))
    radii = r * rng.uniform(0.6, 1.0, 9)
    xs = np.clip(cx + radii * np.cos(angles), 0, w - 1)
    ys = np.clip(cy + radii * np.sin(angles), 0, h - 1)
    return [float(v) for xy in zip(xs, ys) for v in xy]


def build_cli_fixture(root: Path, retrieval: dict) -> dict:
    """On disk under `root`, beside phase_retrieval's files: a
    coco2017-layout val set of 16 committed JPEGs with polygon annotations
    and the same images in the coco20k layout. No pseudo-mask is written:
    the training CLI makes them."""
    rng = np.random.default_rng(2026)
    photos = sorted(FIXTURES.glob("photo_*_420_q75.jpg"))
    largest = FIXTURES / "largest_640x480_422_q80_progressive.jpg"
    library = retrieval["library"]

    dir_val, dir_20k = root / "coco2017", root / "coco20k"
    for d in (dir_val / "val2017", dir_val / "annotations",
              dir_20k / "train2014", dir_20k / "annotations"):
        d.mkdir(parents=True)
    images, anns = [], []
    for i in range(CLI_VAL_IMAGES):
        src, (h, w) = ((largest, (480, 640)) if i % 4 == 3
                       else (photos[i % len(photos)], (375, 500)))
        name = f"{i + 1:012d}.jpg"
        shutil.copyfile(src, dir_val / "val2017" / name)
        shutil.copyfile(src, dir_20k / "train2014" / name)
        images.append({"id": i + 1, "height": h, "width": w,
                       "file_name": name})
        for _ in range(2 + i % 2):
            poly = _polygon(rng, h, w)
            mask = rle.polygons_to_mask([poly], h, w)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": new_label_id_to_old_label_id[
                             int(rng.integers(1, 81))],
                         "segmentation": [poly], "iscrowd": 0,
                         "area": float(mask.sum()),
                         "bbox": rle.to_bbox(mask)})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": new_label_id_to_old_label_id[c]}
                         for c in range(1, 81)]}
    (dir_val / "annotations" / "instances_val2017.json").write_text(
        json.dumps(gt))
    (dir_20k / "annotations" / "instances_train2014_sel20k.json").write_text(
        json.dumps(gt))
    return {"cat_fp": library["cat_fp"], "dir_train": library["dir_train"],
            "banks": library["banks"], "assets_dir": retrieval["assets_dir"],
            "dir_val": dir_val, "dir_20k": dir_20k,
            "val_sizes": [(im["height"], im["width"]) for im in images]}


def cli_config(root: Path, paths: dict, model_kwargs=None,
               image_size: int = 0) -> Path:
    """The shipped config with the Trainer cell's cuts (TRAINER_SCHEDULE,
    mesh_axes dropped) and skip_pretrained, pointed at the fixture: the
    retrieval's banks and category JSON, and its assets directory (the
    synthetic ViT-B/16 checkpoint and merges file) for the text
    embeddings; `model_kwargs` and `image_size` shrink it for a rehearsal
    on the CPU."""
    from zutis_tpu_torch.core.config import parse_yaml

    raw = parse_yaml(TRAINER_CONFIG.read_text())
    raw.pop("mesh_axes")
    raw.update(dir_ckpt=str(root / "ckpt"),
               dir_train_dataset=[str(d) for d in paths["dir_train"]],
               p_filename_to_image_embedding=paths["banks"],
               dir_val_dataset=str(paths["dir_val"]),
               category_to_p_images_fp=str(paths["cat_fp"]),
               clip_assets_dir=str(paths["assets_dir"]),
               skip_pretrained=True, **TRAINER_SCHEDULE)
    if model_kwargs:
        raw.update(model_kwargs=model_kwargs, train_image_size=image_size)
    fp = root / "cli.yaml"
    fp.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
    check(parse_yaml(fp.read_text()) == raw, "the derived YAML reads back")
    return fp


def time_loader(dataset, batch: int, device) -> dict:
    """IndexDataset.sample one at a time on this thread, then the batch
    iterator's samples/s at 1, 2 and os.cpu_count() threads, each timed
    from its start over 2 x threads batches (3 at least)."""
    from zutis_tpu_torch.data.index_dataset import batch_iterator

    times, objects = [], []
    for i in range(LOADER_SAMPLES):
        t0 = time.perf_counter()
        sample = dataset.sample(i, epoch=1)
        times.append((time.perf_counter() - t0) * 1e3)
        objects.append(int(sample["instance_valid"].sum()))
    # the same samples again under cProfile: each part's share of the time
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for i in range(LOADER_SAMPLES):
        dataset.sample(i, epoch=1)
    prof.disable()
    wall = time.perf_counter() - t0
    cumulative = {}
    for (path, _, func), (_, _, _, ct, _) in pstats.Stats(prof).stats.items():
        cumulative[(Path(path).name, func)] = ct
    split = {part: cumulative.get(key, 0.0) / wall
             for part, key in LOADER_PARTS.items()}
    rates = {}
    for threads in sorted({1, 2, os.cpu_count() or 1}):
        n_batches = max(3, 2 * threads)
        t0 = time.perf_counter()
        it = batch_iterator(dataset, batch, seed=77, num_threads=threads,
                            device=device)
        for _ in range(n_batches):
            next(it)
        rates[threads] = n_batches * batch / (time.perf_counter() - t0)
        it.close()
    return {"sample_ms": statistics.median(times), "sample_ms_all": times,
            "split": split,
            "objects_per_sample": float(np.mean(objects)),
            "loader_samples_per_s": rates, "cpu_count": os.cpu_count()}


@contextlib.contextmanager
def loader_waits():
    """While open, every `batch_iterator` the CLI makes records the
    seconds its consumer waits for each batch into the yielded list."""
    from zutis_tpu_torch.data import index_dataset

    waits, real = [], index_dataset.batch_iterator

    def timed(*args, **kwargs):
        it = real(*args, **kwargs)
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(it)
                waits.append(time.perf_counter() - t0)
                yield batch
        finally:
            it.close()

    index_dataset.batch_iterator = timed
    try:
        yield waits
    finally:
        index_dataset.batch_iterator = real


@contextlib.contextmanager
def generation_record():
    """While open, each `generate_pseudo_masks` call (the training CLI's)
    appends its image count, flash launches (and those split into key
    ranges) and seconds to the yielded list."""
    from zutis_tpu_torch.data import pseudo_masks

    calls, real = [], pseudo_masks.generate_pseudo_masks

    def recorded(p_images, *args, **kwargs):
        before = fa.flash_attention.launches
        split_before = fa.flash_attention.split_launches
        t0 = time.perf_counter()
        result = real(p_images, *args, **kwargs)
        _sync(kwargs.get("device", "cuda"))
        calls.append(dict(
            images=len(p_images), seconds=time.perf_counter() - t0,
            launches=fa.flash_attention.launches - before,
            split_launches=fa.flash_attention.split_launches - split_before))
        return result

    pseudo_masks.generate_pseudo_masks = recorded
    try:
        yield calls
    finally:
        pseudo_masks.generate_pseudo_masks = real


def phase_cli(trainer_stats: dict, retrieval: dict, device="cuda",
              model_kwargs=None, image_size: int = 0, parallel=None) -> dict:
    """The two CLIs on images from disk, fed by phase_retrieval. The
    decoder against Pillow's pinned hashes; the loader's rates over the
    images combined_retrieval chose; `cli.main.main` training 6 iterations
    of the shipped config (logs at 2, 4, 6; evaluations of the 16 val JPEGs
    and full checkpoints at 3 and 6) with every launch count set to 0
    before and read after, its text embeddings computed from the synthetic
    ViT-B/16 checkpoint into the JAX CLI's cache file (equal to
    phase_retrieval's), its artifacts and figures, and the run resumed from
    step 3 (which reads the cache) against the straight one;
    `cli.coco20k_eval.main` on the trained final_model.npz, batched at
    depth 1 and 2 and per image, each drawing the overlays of its first 2
    images; then `parallel(root, cfg_fp, straight final parameters,
    phase_trainer's spread)` where given (phase_parallel). `model_kwargs`
    and `image_size` shrink the model for a rehearsal on the CPU, where the
    card's checks are left out."""
    from zutis_tpu_torch.cli import coco20k_eval as cli_eval
    from zutis_tpu_torch.cli import main as cli_main
    from zutis_tpu_torch.core.config import checkpoint_dir
    from zutis_tpu_torch.data.datasets import get_eval_dataset
    from zutis_tpu_torch.data.pseudo_masks import pseudo_mask_path

    t_phase = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    decoder = check_fixture_decodes()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = Path(tmp)
        paths = build_cli_fixture(root, retrieval)
        cfg_fp = cli_config(root, paths, model_kwargs, image_size)
        cfg = Config.load(str(cfg_fp))
        check(cfg.extras.get("skip_pretrained") and not cfg.mesh_axes
              and cfg.n_iters == TRAINER_SCHEDULE["n_iters"],
              f"the derived config: {cfg}")
        batch = cfg.train_dataloader_kwargs["batch_size"]
        # every retrieved image, none with a pseudo-mask yet
        with open(cfg.category_to_p_images_fp) as f:
            retrieved = sorted({p for ps in json.load(f).values() for p in ps})
        masks = {p: pseudo_mask_path(os.path.join(os.path.dirname(
            cfg.category_to_p_images_fp), "pseudo_masks"), p)
            for p in retrieved}
        check(not any(os.path.exists(m) for m in masks.values()),
              "a pseudo-mask exists before the training CLI runs")

        # the buckets of the val images: one padded forward each per
        # evaluation (16 images a batch)
        forwards = len({BE.bucket_shape(h, w) for h, w in paths["val_sizes"]})
        n_evals = cfg.n_iters // cfg.iter_eval
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        args = ["--p_config", str(cfg_fp), "--device", str(device)]
        zero_counts()
        sync()
        t0 = time.perf_counter()
        with loader_waits() as waits, generation_record() as generated, \
                figure_record() as drawn:
            cli_main.main(args)
        sync()
        fit_s = time.perf_counter() - t0
        launches, masked = read_counts()
        # the pseudo-masks the CLI made before training
        check(len(generated) == 1 and generated[0]["images"] == len(
            retrieved) and all(os.path.exists(m) for m in masks.values()),
            f"the training CLI generated {generated} for {len(retrieved)} "
            "images")
        gen = generated[0]
        mask_stamps = {m: os.stat(m).st_mtime_ns for m in masks.values()}
        print(f"cli: pseudo-masks: the training CLI made {gen['images']} "
              f"from the assets' selfmask_nq20.pt in {gen['seconds']:.3f} s "
              f"({gen['launches']} flash launches, {gen['split_launches']} "
              "split into key ranges)", flush=True)
        peak_gib = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                    if on_card else None)
        # the text embeddings the CLI computed and cached
        cache_fp = cli_main.text_embeddings_cache_path(cfg)
        check(os.path.exists(cache_fp), f"the CLI wrote no {cache_fp}")
        cache_mtime = os.stat(cache_fp).st_mtime_ns
        with np.load(cache_fp, allow_pickle=True) as f:
            check(list(f["categories"]) == list(cfg.categories),
                  "the cache's categories")
            text_diff = float(np.abs(f["embeddings"]
                                     - retrieval["head_embeddings"]).max())
        print(f"cli: text: {os.path.basename(cache_fp)} written from the "
              f"synthetic checkpoint; {len(cfg.categories)} embeddings "
              f"differ from phase_retrieval's by {text_diff:.3e}", flush=True)
        check(text_diff <= 1e-6, "the CLI's text embeddings differ from the "
              "same tower's in phase_retrieval")
        print(f"cli: train: {cfg.n_iters} iterations in {fit_s:.3f} s "
              f"(model build and loader start included), of which "
              f"{sum(waits):.3f} s waiting for batches (by step: "
              f"{json.dumps([round(w, 4) for w in waits])}); launches "
              f"{json.dumps(launches)} ({masked} masked flash)", flush=True)
        run = checkpoint_dir(cfg)
        # the figures at every log point, matched pairs where the batch's
        # first image has a valid instance: one matcher launch each
        log_points = list(range(cfg.iter_log, cfg.n_iters + 1, cfg.iter_log))
        matched = [f["num_iter"] for f in drawn if f["matched"]]
        check([f["num_iter"] for f in drawn] == log_points and matched,
              f"the training CLI drew figures at {drawn}: expected at "
              f"{log_points}, matched pairs at one at least")
        figures = figure_names(log_points, matched)
        if on_card:
            check(gen["launches"] == SELFMASK_LAUNCHES * gen["images"],
                  f"{gen['launches']} flash launches for {gen['images']} "
                  f"pseudo-masks: expected {SELFMASK_LAUNCHES} an image")
            check(gen["split_launches"]
                  == SELFMASK_SPLIT_LAUNCHES * gen["images"],
                  f"{gen['split_launches']} split flash launches for "
                  f"{gen['images']} pseudo-masks")
            check(launches["flash_attention"] - gen["launches"]
                  == LAUNCHES_PER_FORWARD * (cfg.n_iters + forwards * n_evals
                                             + len(log_points)),
                  f"{launches['flash_attention']} flash launches: expected "
                  f"{LAUNCHES_PER_FORWARD} a step, a padded forward and a "
                  "log point's figures")
            check(masked == EVAL_MASKED_LAUNCHES * forwards * n_evals,
                  f"{masked} masked flash launches")
            check(launches["batched_hungarian"] == cfg.n_iters + len(matched),
                  "one matcher launch a step and a matched-pairs figure")
            check(sum(launches[p] for p in PROBES) == 0, "the CLI launched "
                  "a probe")
            check_figure_launches(drawn, "the training CLI")
        names = sorted(os.listdir(run))
        check(names == sorted(
            ["best_model.npz", "checkpoints", "config.json",
             "eval_coco_style_metrics.json", "eval_metrics.json",
             "final_model.npz", "latest_model.npz", "training_metrics.json"]
            + [f"instance_predictions_{k:05d}.json"
               for k in range(cfg.iter_eval, cfg.n_iters + 1,
                              cfg.iter_eval)] + figures),
            f"the CLI wrote {names}")
        check(sorted(os.listdir(os.path.join(run, "checkpoints"))) == [
            f"step_{k}" for k in range(cfg.checkpoint_every, cfg.n_iters + 1,
                                       cfg.checkpoint_every)],
            "full checkpoints at 3 and 6")
        logs = _read_jsonl(os.path.join(run, "training_metrics.json"))
        check([r["num_iter"] for r in logs] == list(
            range(cfg.iter_log, cfg.n_iters + 1, cfg.iter_log)),
            "training_metrics.json's iterations")
        check(all(np.isfinite(r["loss"]) for r in logs), f"losses {logs}")
        evals = _read_jsonl(os.path.join(run, "eval_metrics.json"))
        coco = _read_jsonl(os.path.join(run, "eval_coco_style_metrics.json"))
        check(len(evals) == len(coco) == n_evals
              and all("index error" not in c for c in coco),
              f"evaluations: {evals} {coco}")
        final = os.path.join(run, "final_model.npz")
        with np.load(final) as f:
            straight = {k: f[k] for k in f.files}
        check(all(np.isfinite(v).all() for v in straight.values()),
              "final_model.npz holds a non-finite parameter")

        index = cli_main.build_index_dataset(cfg, 0, device)
        size, arch = image_size or cfg.train_image_size, model_kwargs or VIT_B16
        tokens = 2 * size // arch["patch_size"]
        check_figures(run, figures, (size, size), (tokens, tokens),
                      arch["n_queries"], index.max_n_masks)
        loader = time_loader(index, batch, device)
        print(f"cli: loader: IndexDataset.sample {loader['sample_ms']:.1f} "
              f"ms (median of {LOADER_SAMPLES}, "
              f"{loader['objects_per_sample']:.2f} objects a sample; "
              f"shares under cProfile {json.dumps(loader['split'])}); "
              f"batch_iterator samples/s by threads "
              f"{json.dumps(loader['loader_samples_per_s'])} on "
              f"os.cpu_count() = {loader['cpu_count']}", flush=True)

        # what an evaluation pays on the host for each val item: decode,
        # normalise, the semantic mask and the instance masks rendered
        # from the polygons
        val = get_eval_dataset(cfg.dataset_name, cfg.dir_val_dataset)
        item_ms = []
        for i in range(len(val)):
            t0 = time.perf_counter()
            val[i]
            item_ms.append((time.perf_counter() - t0) * 1e3)
        loader["val_item_ms"] = statistics.median(item_ms)
        print(f"cli: val: COCO2017Dataset item {loader['val_item_ms']:.1f} "
              f"ms (median of {len(val)})", flush=True)

        # the same evaluation with no loader thread beside it
        model = cli_main.build_model(cfg, device, init=False)
        model.load_state_dict(load_params_any(final), strict=True)
        quiet_eval = Trainer(model,
                             cli_main.build_text_embeddings(cfg, device),
                             device=device).evaluate(model, val)
        del model
        print(f"cli: val: evaluation of the {len(val)} val JPEGs inside fit "
              f"{json.dumps([e['eval_images_per_sec'] for e in evals])} "
              f"img/s, after it with no loader thread running "
              f"{quiet_eval['eval_images_per_sec']:.2f}", flush=True)

        # the resumed run: drop step 6 and the final model, run again
        os.remove(final)
        shutil.rmtree(os.path.join(run, "checkpoints", f"step_{cfg.n_iters}"))
        zero_counts()
        t0 = time.perf_counter()
        with generation_record() as generated_again, \
                figure_record() as drawn_again:
            cli_main.main(args)
        sync()
        resume_s = time.perf_counter() - t0
        resumed_launches, _ = read_counts()
        check(os.stat(cache_fp).st_mtime_ns == cache_mtime,
              "the resumed run rewrote the text-embedding cache")
        check(not generated_again and {m: os.stat(m).st_mtime_ns
                                       for m in masks.values()}
              == mask_stamps, "the resumed run made pseudo-masks again")
        resumed_steps = cfg.n_iters - cfg.checkpoint_every
        # its batches are the straight run's: matched pairs where that
        # run drew them
        resumed_logs = [k for k in log_points if k > cfg.checkpoint_every]
        resumed_matched = [k for k in matched if k > cfg.checkpoint_every]
        check([f["num_iter"] for f in drawn_again] == resumed_logs
              and [f["num_iter"] for f in drawn_again if f["matched"]]
              == resumed_matched,
              f"the resumed run drew figures at {drawn_again}: expected at "
              f"{resumed_logs}, matched pairs at {resumed_matched}")
        resumed_evals = sum(k % cfg.iter_eval == 0 for k in range(
            cfg.checkpoint_every + 1, cfg.n_iters + 1))
        if on_card:
            check(resumed_launches["batched_hungarian"]
                  == resumed_steps + len(resumed_matched)
                  and resumed_launches["flash_attention"]
                  == LAUNCHES_PER_FORWARD * (resumed_steps + len(resumed_logs)
                                             + forwards * resumed_evals),
                  f"the resumed run took {resumed_launches} launches")
            check_figure_launches(drawn_again, "the resumed training CLI")
        logs_after = _read_jsonl(os.path.join(run, "training_metrics.json"))
        check([r["num_iter"] for r in logs_after] == [
            r["num_iter"] for r in logs] + [
                k for k in range(cfg.checkpoint_every + 1, cfg.n_iters + 1)
                if k % cfg.iter_log == 0],
            f"the resumed run's logs: {[r['num_iter'] for r in logs_after]}")
        with np.load(final) as f:
            diff = max(float(np.abs(f[k] - v).max())
                       for k, v in straight.items())
        spread = trainer_stats.get("straight_spread", 0.0)
        bound = RESUME_SPREAD_FACTOR * spread
        print(f"cli: resume: restored from step {cfg.checkpoint_every}, "
              f"{resumed_steps} steps in {resume_s:.3f} s; final parameters "
              f"differ from the straight run's by {diff:.3e} (phase_trainer's "
              f"straight runs: {spread:.3e})", flush=True)
        check(diff <= bound if spread > 0 else diff == 0.0,
              "the resumed CLI run left the straight runs' spread")

        # the eval CLI on the trained weights, batched at depth 1 and 2 and
        # per image, each drawing the overlays of its first images
        eval_rates, eval_launches = {}, {}
        val_hw = {i + 1: hw for i, hw in enumerate(paths["val_sizes"])}
        for mode in (1, 2, "per_image"):
            zero_counts()
            batched = mode != "per_image"
            res = cli_eval.main([
                "--p_config", str(cfg_fp), "--p_state_dict", final,
                "--dir_dataset", str(paths["dir_20k"]),
                "--dir_ckpt", str(root / f"eval_{mode}"),
                "--batch_images", str(CLI_BATCH_IMAGES if batched else 1),
                "--pipeline_depth", str(mode if batched else 1),
                "--suffix", str(mode), "--visualise_first",
                str(CLI_OVERLAYS), "--device", str(device)])
            sync()
            eval_launches[mode], eval_masked = read_counts()
            eval_rates[mode] = res["eval_images_per_sec"]
            written = {fn: os.path.join(dp, fn) for dp, _, fns in
                       os.walk(root / f"eval_{mode}") for fn in fns}
            overlays = sorted(fn for fn in written if fn.startswith("overlay_"))
            check(len(written) == 1 + CLI_OVERLAYS
                  and f"coco20k_metrics_vit_b_16_nms_hard_{mode}.json"
                  in written and len(overlays) == CLI_OVERLAYS,
                  f"the eval CLI wrote {sorted(written)}")
            for fn in overlays:
                image = read_png(written[fn])
                check(image.shape == (*val_hw[int(fn[8:-4])], 3),
                      f"{fn} decodes to {image.shape}")
            check(all(np.isfinite(res[k]) for k in ("AP", "AR_100")),
                  f"the eval CLI's metrics: {res}")
            if on_card:
                want = ((LAUNCHES_PER_FORWARD * forwards,
                         EVAL_MASKED_LAUNCHES * forwards) if batched
                        else (LAUNCHES_PER_FORWARD * CLI_VAL_IMAGES, 0))
                check((eval_launches[mode]["flash_attention"], eval_masked)
                      == want, f"the eval CLI ({mode}) launched "
                      f"{eval_launches[mode]}, {eval_masked} masked")
        print(f"cli: eval: coco20k_eval on {CLI_VAL_IMAGES} JPEGs with "
              f"{CLI_OVERLAYS} overlays, img/s "
              f"{json.dumps({str(m): r for m, r in eval_rates.items()})} "
              f"(batched by depth, per image); AP {res['AP']:.4f}",
              flush=True)
        par = None
        if parallel is not None:
            par = parallel(root, cfg_fp, straight,
                           trainer_stats.get("straight_spread", 0.0))

    rate = logs[-1]["iters_per_sec"]
    out = dict(decoder=decoder, loader=loader, fit_s=fit_s,
               pseudo_masks=gen,
               loader_wait_s=waits,
               fit_iters_per_sec=rate,
               fit_iters_per_sec_without_figures=rate_without_figures(
                   logs[-1], drawn),
               trainer_fit_iters_per_sec_without_figures=trainer_stats.get(
                   "fit_iters_per_sec_without_figures"),
               trainer_fit_iters_per_sec=trainer_stats.get(
                   "fit_iters_per_sec"),
               trainer_fit_s=trainer_stats.get("fit_s"),
               train_step_its_per_sec=trainer_stats.get(
                   "train_step_its_per_sec"),
               fit_eval_images_per_sec=[e["eval_images_per_sec"]
                                        for e in evals],
               quiet_eval_images_per_sec=quiet_eval["eval_images_per_sec"],
               eval_images_per_sec=eval_rates, launches=launches,
               masked_launches=masked, resumed_launches=resumed_launches,
               figures=drawn, resumed_figures=drawn_again,
               eval_launches=eval_launches, resume_max_diff=diff,
               resume_s=resume_s, losses=[r["loss"] for r in logs],
               peak_memory_gib=peak_gib, val_forwards_per_eval=forwards,
               parallel=par, phase_s=time.perf_counter() - t_phase)
    print(f"cli rate: fit {rate:.3f} iters/s on batches from disk against "
          f"{out['trainer_fit_iters_per_sec']} on synthetic batches "
          f"(phase_trainer, same schedule), without the figures' seconds "
          f"before the last log {out['fit_iters_per_sec_without_figures']:.3f}"
          f" against {out['trainer_fit_iters_per_sec_without_figures']} (bare "
          f"step "
          f"{out['train_step_its_per_sec']} steps/s); loader "
          f"{json.dumps(loader['loader_samples_per_s'])} samples/s by "
          f"threads (a step takes {batch} samples); eval CLI "
          f"{json.dumps(eval_rates)} img/s by depth; peak memory {peak_gib} "
          f"GiB; phase {out['phase_s']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------- retrieval

CLIP_MERGES = 48894  # CLIP's merges: 512 byte units + 48,894 + SOT, EOT
CLIP_VOCAB = 49408


def synthetic_merges(texts, n_merges: int = CLIP_MERGES) -> list:
    """A deterministic BPE merges table: the merges learned from `texts`
    (byte units split by CLIP's regex, the most frequent pair first, ties
    by the pair), then padded with unique merges of the non-ASCII byte
    units up to `n_merges`, so that the vocabulary has CLIP's size."""
    from itertools import count, product

    from zutis_tpu_torch.data import tokenizer as T

    units = T.bytes_to_unicode()
    words = {}
    for text in texts:
        clean = T.whitespace_clean(T.basic_clean(text)).lower()
        for tok in re.findall(T._PAT, clean):
            w = [units[b] for b in tok.encode("utf-8")]
            key = tuple(w[:-1] + [w[-1] + "</w>"])
            words[key] = words.get(key, 0) + 1
    merges = []
    while len(merges) < n_merges:
        pairs = {}
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] = pairs.get(pair, 0) + c
        if not pairs:
            break
        best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        merged = {}
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + c
        words = merged
    seen = set(merges)
    tokens = {a + b for a, b in merges}
    high = [units[b] for b in range(128, 256)]

    def pads():
        for a, b in product(high, high):
            yield a, b
            yield a, b + "</w>"
        for n in count():
            yield high[n % 128] + high[n // 128 % 128], high[n // 16384 % 128]
    for pair in pads():
        if len(merges) >= n_merges:
            break
        if pair not in seen and "".join(pair) not in tokens:
            seen.add(pair)
            tokens.add("".join(pair))
            merges.append(pair)
    return merges


def write_merges(path, merges) -> None:
    """`merges` as CLIP's bpe_simple_vocab file: gzip, a version header."""
    import gzip

    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("".join(f"{a} {b}\n" for a, b in merges))


RETRIEVAL_ARCH = "ViT-L/14@336px"  # the retrieval towers (SURVEY step 1)
HEAD_ARCH = "ViT-B/16"  # the shipped config's clip_arch: the head's text
BANK_ENCODER = dict(width=1024, layers=24, heads=16, patch_size=14,
                    output_dim=768, input_resolution=336)
BANK_BATCH = 32
BANK_COPIES = 4  # each committed fixture image under 4 names: 92
BANK_FLASH_SHAPE = (32, 16, 577, 577, 64)  # encode_image's attention
IMAGENET_TRAIN_ROWS = 1_281_167
PASS_ROWS = 1_440_000
TOPK_K = 500  # n_images of the shipped configs
TOPK_BANKS = {  # name -> (categories, bank rows)
    "coco": (80, IMAGENET_TRAIN_ROWS + PASS_ROWS),
    "imagenet-s": (919, IMAGENET_TRAIN_ROWS),
}
TOPK_SHARED = 4096  # last rows that copy the first: images both archives hold
TOPK_CHECKED = 4  # categories of each bank held against a CPU rerun
TOL_TOPK = 1e-5  # a swap's two scores may differ by this much (f32, d 768)
TOL_TEXT = 1e-4  # the tower on the card against the CPU, of the largest |x|
TOL_BANK_TORCH = 1e-3  # unit-norm f32 embeddings, flash against "torch"
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# flash's f32 path: each product is three bf16 tensor-core MMAs on hi/lo
# splits (csrc/flash_attention.cu), so a third of the bf16 peak
PEAK_F32_FLASH_FLOPS = kernel_tune.PEAK_BF16_FLOPS / 3
LIBRARY_IMAGES = 16  # fixture photos in each archive of the library path
LIBRARY_WNIDS = ("n00000001", "n00000002", "n00000003", "n00000004")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _seconds(fn, device):
    """(fn(), host seconds including a device synchronise)."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def flash_only_launches(what: str) -> int:
    """Flash's launches since zero_counts; fails if any other counted
    kernel (the probes, the matcher) launched: retrieval runs none."""
    launches, _ = read_counts()
    others = {n: c for n, c in launches.items()
              if n != "flash_attention" and c}
    check(not others, f"{what} launched {others}: retrieval runs flash only")
    return launches["flash_attention"]


def retrieval_tokenizer(path: Path):
    """The synthetic CLIP-sized merges file at `path`, learned from the 80
    COCO names and the 85 templates, and its tokenizer."""
    from zutis_tpu_torch.data.category_lists import COCO81_CATEGORIES
    from zutis_tpu_torch.data.tokenizer import CLIPTokenizer
    from zutis_tpu_torch.retrieval.prompts import PROMPT_TEMPLATES

    write_merges(path, synthetic_merges(list(COCO81_CATEGORIES[1:])
                                        + PROMPT_TEMPLATES))
    tok = CLIPTokenizer.from_file(str(path))
    check(len(tok.encoder) == CLIP_VOCAB and tok.eot_id == CLIP_VOCAB - 1
          and tok.sot_id == CLIP_VOCAB - 2,
          f"the synthetic vocabulary: {len(tok.encoder)} entries, EOT "
          f"{tok.eot_id}")
    return tok


def flash_rows(gen, cases, label: str) -> list:
    """Flash at each (name, [b, h, sq, sk, d], dtype, launches a forward[,
    biased]) case as the model passes it ([b, s, h, d] views) against its
    plain version (of the largest |output|: 1e-4 f32, 8e-3 bf16); times
    beside the plain version, SDPA and the bound at the rate of the path the
    kernel takes (bf16: 989 TFLOP/s; f32: 989 / 3, its three bf16 MMAs a
    product), bytes counting q and o [b, h, sq, d], k and v [b, h, sk, d]
    once each. A biased case takes a key bias, the log of counts 1 to 4,
    whose bytes the bound counts and which SDPA takes as a float mask. An
    f32 row carries its key ranges (`key_splits`) and, where there are
    several, the same call on one range (`unsplit_ms`)."""
    rows = []
    for name, (b, h, sq, sk, d), dtype, per_forward, *biased in cases:
        f32 = dtype == torch.float32
        tol = TOL_F32 if f32 else TOL_FLASH_BF16
        peak = PEAK_F32_FLASH_FLOPS if f32 else kernel_tune.PEAK_BF16_FLOPS
        q, k, v = _inputs(gen, b, h, sq, sk, d, dtype, strided=True)
        bias = float_mask = None
        if biased and biased[0]:
            bias = torch.randint(1, 5, (b, sk), generator=gen,
                                 device="cuda").float().log()
            float_mask = bias[:, None, None, :].to(dtype)
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, key_bias=bias)
        torch.cuda.synchronize()
        check(fa.flash_attention.launches == before + 1,
              f"{label} flash: no launch")
        want = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                            key_bias=bias)
        err = (got.float() - want).abs().max().item()
        rel = err / want.abs().max().item()
        del got, want
        print(f"kernel check {label} {name} {[b, h, sq, sk, d]}: max_abs_err "
              f"{err:.3e} max_rel_err {rel:.3e} (tol {tol} rel)", flush=True)
        check(rel <= tol, f"{label} flash {name} disagrees with its plain "
              "version")
        flops = 4 * b * h * sq * sk * d
        nbytes = q.element_size() * 2 * b * h * (sq + sk) * d
        if bias is not None:
            nbytes += 4 * b * sk
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / kernel_tune.PEAK_BYTES * 1e3
        splits = fa.key_splits(b, h, sq, sk, d) if f32 else 1
        row = dict(name=name, shape=[b, h, sq, sk, d],
                   dtype=str(dtype)[6:], per_forward=per_forward,
                   biased=bias is not None,
                   max_abs_err=err, max_rel_err=rel, splits=splits,
                   ms=cuda_ms(lambda: fa.flash_attention(q, k, v,
                                                         key_bias=bias)),
                   plain_ms=cuda_ms(
                       lambda: fa.flash_attention_reference(
                           q, k, v, key_bias=bias),
                       calls=3, reps=5, warmup=1),
                   library_ms=cuda_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=float_mask),
                       calls=3, reps=5, warmup=1),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   peak_flops=peak)
        if splits > 1:
            row["unsplit_ms"] = cuda_ms(
                lambda: fa._flash_forward(q, k, v, None, 1, key_bias=bias))
        rows.append(row)
        print(f"kernel time {label} {name} {[b, h, sq, sk, d]}"
              f"{' biased' if bias is not None else ''}: kernel "
              f"{row['ms']:.4f} ms ({splits} key range(s); one range "
              f"{row.get('unsplit_ms', row['ms']):.4f} ms), plain "
              f"{row['plain_ms']:.4f} ms, sdpa "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; operations at {peak / 1e12:.1f} "
              f"TFLOP/s, bytes at {kernel_tune.PEAK_BYTES / 1e12} TB/s), "
              f"{row['bound_ms'] / row['ms']:.1%} of bound", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _topk_swaps(idx, idx_cpu, vals_cpu, bank_cpu, text_cpu) -> int:
    """Positions where the card's top-k differs from the CPU's; fails
    unless each such pair scores within TOL_TOPK of each other (on the
    CPU) and each index found in one list only scores within TOL_TOPK of
    the k-th value."""
    swaps = 0
    for c in range(len(idx)):
        a, b = idx[c], idx_cpu[c]
        sa, sb = bank_cpu[a] @ text_cpu[c], bank_cpu[b] @ text_cpu[c]
        moved = a != b
        swaps += int(moved.sum())
        check(bool(((sa - sb).abs()[moved] <= TOL_TOPK).all()),
              f"top-k category {c}: a swap across scores more than "
              f"{TOL_TOPK} apart")
        only = torch.tensor(sorted(set(a.tolist()) ^ set(b.tolist())),
                            dtype=torch.int64)
        if len(only):
            s = bank_cpu[only] @ text_cpu[c]
            check(bool(((s - vals_cpu[c, -1]).abs() <= TOL_TOPK).all()),
                  f"top-k category {c}: an image away from the k-th score "
                  "in one list only")
    return swaps


def topk_bank(n_rows: int, dim: int, device, seed: int) -> torch.Tensor:
    """A seeded unit-norm [n_rows, dim] bank made on the device, its last
    TOPK_SHARED rows copies of its first (images both archives hold)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bank = torch.randn(n_rows, dim, generator=gen, device=device)
    bank /= torch.linalg.vector_norm(bank, dim=1, keepdim=True)
    shared = min(TOPK_SHARED, n_rows // 4)
    bank[n_rows - shared:] = bank[:shared]
    _sync(device)
    return bank


def time_topk(name, text, n_rows, device, seed) -> dict:
    """Top-k over a seeded unit-norm bank of `n_rows` x 768 made on the
    device, its last TOPK_SHARED rows copies of its first (images both
    archives hold); ms, peak memory and bounds; the first TOPK_CHECKED
    categories against a CPU rerun."""
    from zutis_tpu_torch.retrieval.bank import topk_local

    on_card = device.type == "cuda"
    bank = topk_bank(n_rows, text.shape[1], device, seed)
    peak = None
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    vals, idx = topk_local(text, bank, TOPK_K)
    _sync(device)
    if on_card:
        peak = torch.cuda.max_memory_allocated(device) - base
    ms = host_ms(lambda: topk_local(text, bank, TOPK_K), device, reps=5,
                 warmup=1)
    c, dim = text.shape
    t_bytes = 4 * n_rows * dim / kernel_tune.PEAK_BYTES * 1e3
    t_ops = 2 * c * n_rows * dim / PEAK_F32_FLOPS * 1e3
    bank_cpu, text_cpu = bank.cpu(), text[:TOPK_CHECKED].cpu()
    vals_cpu, idx_cpu = topk_local(text_cpu, bank_cpu, TOPK_K)
    swaps = _topk_swaps(idx[:TOPK_CHECKED].cpu(), idx_cpu, vals_cpu,
                        bank_cpu, text_cpu)
    check(bool(torch.isfinite(vals).all()) and int(idx.min()) >= 0,
          f"top-k {name}: non-finite scores or missing rows")
    ties = int((vals[:, 1:] == vals[:, :-1]).sum())
    out = dict(categories=c, rows=n_rows, k=TOPK_K, ms=ms,
               bank_bytes=4 * n_rows * dim, sims_bytes=4 * c * n_rows,
               peak_bytes_over_bank=peak, bound_bytes_ms=t_bytes,
               bound_f32_ops_ms=t_ops, equal_neighbours=ties,
               cpu_checked=TOPK_CHECKED, cpu_swaps=swaps)
    print(f"retrieval: top-{TOPK_K} {name}: {c} categories over {n_rows} x "
          f"{dim} in {ms:.3f} ms (bounds: bank bytes {t_bytes:.3f} ms, "
          f"f32 product {t_ops:.3f} ms at 67 TFLOP/s); peak "
          f"{None if peak is None else round(peak / 2 ** 30, 3)} GiB over "
          f"the {4 * n_rows * dim / 2 ** 30:.3f} GiB bank; "
          f"{TOPK_CHECKED} categories against a CPU rerun: {swaps} swaps, "
          f"each within {TOL_TOPK} of its pair or of the k-th score; "
          f"{ties} equal neighbours in the lists", flush=True)
    del bank, bank_cpu
    if on_card:
        torch.cuda.empty_cache()
    return out


def library_path(root: Path, encoder, text: dict, device) -> dict:
    """The retrieval library at a small size: an ImageNet-layout archive
    and a PASS archive of fixture photos, their banks from the port's
    encoder (extract_image_embeddings; PASS.ensure_bank on encode_images),
    combined_retrieval over both with no cache (CLI_PER_CATEGORY images
    for each CLI category) and ImageNet1KDataset retrieving with no cache;
    each JSON cache written and read back equal."""
    from functools import partial

    from zutis_tpu_torch.data.imagenet_index import (
        PASS,
        ImageNet1KDataset,
        combined_retrieval,
        imagenet_filename_to_path,
    )
    from zutis_tpu_torch.retrieval.image_embeddings import (
        encode_images,
        extract_image_embeddings,
    )

    photos = sorted(FIXTURES.glob("photo_*_420_q75.jpg"))
    dir_in, dir_pass = root / "ImageNet2012", root / "pass"
    paths = []
    for i in range(LIBRARY_IMAGES):
        wnid = LIBRARY_WNIDS[i % len(LIBRARY_WNIDS)]
        p = dir_in / "train" / wnid / f"{wnid}_{i}.JPEG"
        p.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(photos[i % len(photos)], p)
        paths.append(str(p))
        q = dir_pass / "images" / str(i % 2) / f"pass_{i}.jpg"
        q.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(photos[(i + 2) % len(photos)], q)
    zero_counts()
    bank = extract_image_embeddings(paths, encoder, batch_size=BANK_BATCH)
    bank_in = dir_in / "filename_to_ViT_L_14_336px_train_img_embedding.pkl"
    with open(bank_in, "wb") as f:
        pickle.dump({os.path.basename(p): e for p, e in bank.items()}, f)
    pass_ = PASS(str(dir_pass))
    pass_.ensure_bank(partial(encode_images, visual_encoder=encoder),
                      batch_size=BANK_BATCH)
    launches = flash_only_launches("the library path's banks")
    cat_fp = root / "index_dataset" / "category_to_p_images.json"
    cat_fp.parent.mkdir()
    wanted = {c: text[c] for c in CLI_CATEGORIES}
    resolvers = [lambda fn: imagenet_filename_to_path(str(dir_in), fn),
                 lambda fn: os.path.join(pass_.dir_images, fn)]
    fps = [str(bank_in), pass_.bank_fp]
    got = combined_retrieval(wanted, fps, resolvers, CLI_PER_CATEGORY,
                             cache_fp=str(cat_fp), device=device)
    check(json.loads(cat_fp.read_text()) == got and combined_retrieval(
        {}, fps, resolvers, cache_fp=str(cat_fp)) == got,
        "combined_retrieval's cache JSON reads back unequal")
    check(all(len(v) == CLI_PER_CATEGORY for v in got.values()),
          f"combined_retrieval: {got}")
    in_fp = root / "imagenet_category_to_p_images.json"
    categories = ["background", *CLI_CATEGORIES]
    ds = ImageNet1KDataset(str(dir_in), categories,
                           category_to_p_images_fp=str(in_fp),
                           cat_to_text_embedding=wanted, n_images=3,
                           device=device)
    again = ImageNet1KDataset(str(dir_in), categories,
                              category_to_p_images_fp=str(in_fp))
    check(json.loads(in_fp.read_text()) == ds.category_to_p_images
          == again.category_to_p_images,
          "ImageNet1KDataset's cache JSON reads back unequal")
    from_pass = sum(p.startswith(pass_.dir_images) for v in got.values()
                    for p in v)
    print(f"retrieval: library: banks of {len(paths)} ImageNet-layout and "
          f"{len(pass_.image_paths())} PASS fixture photos ({launches} flash "
          f"launches); combined_retrieval gave {CLI_PER_CATEGORY} images to "
          f"each of {list(got)} ({from_pass} from PASS); ImageNet1KDataset "
          f"retrieved {len(ds.p_images)} images; both JSON caches written "
          f"and read back equal", flush=True)
    images = sorted(set(paths) | set(pass_.image_paths()))
    return dict(cat_fp=cat_fp, images=images, launches=launches,
                dir_train=[dir_in / "train", dir_pass / "images"],
                banks=fps, from_pass=from_pass)


def phase_retrieval(root: Path, device="cuda", text_tower=None,
                    bank_encoder: dict = BANK_ENCODER,
                    topk_banks: dict = TOPK_BANKS) -> dict:
    """The retrieval stage at full width, its files under `root`: the
    tokenizer on a CLIP-sized synthetic merges file; prompt-engineered
    embeddings of the 80 COCO categories from the ViT-L/14@336px text
    tower (27 batches of 256, no flash launch: the causal mask takes the
    "torch" path), its first and last batch against a CPU rerun; the 81
    training categories' plain embeddings from the ViT-B/16 tower, whose
    weights go into a synthetic OpenAI-layout checkpoint for phase_cli;
    the image bank at ViT-L/14@336px over the committed fixtures (92
    images, batch 32) in f32 and bf16, 24 flash launches a batch, f32
    against the "torch" path, the host's and the card's share; flash at
    [32,16,577,577,64] against its plain version; the library path
    (`library_path`); top-k at full bank size (`time_topk`). `text_tower`
    (a CLIPTextEncoder), `bank_encoder` and `topk_banks` shrink it for a
    rehearsal on the CPU, where the card's checks and times are left
    out."""
    from zutis_tpu_torch.data.category_lists import COCO81_CATEGORIES
    from zutis_tpu_torch.models.vit import CLIPViT
    from zutis_tpu_torch.retrieval import image_embeddings as IE
    from zutis_tpu_torch.retrieval import text_embeddings as TE
    from zutis_tpu_torch.retrieval.prompts import PROMPT_TEMPLATES

    t_phase = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    out = {}
    assets = root / "assets"
    assets.mkdir(parents=True)
    tok, out["merges_s"] = _seconds(
        lambda: retrieval_tokenizer(assets / "bpe_simple_vocab_16e6.txt.gz"),
        "cpu")
    coco80 = list(COCO81_CATEGORIES[1:])
    prompts = [t.format(c) for c in coco80 for t in PROMPT_TEMPLATES]
    ids, out["tokenize_s"] = _seconds(lambda: tok.tokenize(prompts), "cpu")
    check(ids.shape == (len(prompts), 77) and int(ids.max()) == tok.eot_id,
          f"tokens {ids.shape}")

    # the retrieval text tower: 6,800 prompts, 27 batches of 256
    if text_tower is None:
        text_tower = factory.build_text_encoder(RETRIEVAL_ARCH, device=device)
    text_tower.init_params(torch.Generator().manual_seed(21))
    zero_counts()
    pe, out["prompt_engineered_s"] = _seconds(
        lambda: TE.prompt_engineered_embeddings(text_tower, tok, coco80),
        device)
    check(flash_only_launches("the text tower") == 0,
          "the text tower launched flash: its causal bias must take the "
          "torch path")
    check(list(pe) == coco80 and all(
        abs(float(np.linalg.norm(e)) - 1.0) < 1e-5 for e in pe.values()),
        "prompt-engineered embeddings: not 80 unit vectors")
    n_batches = -(-len(prompts) // 256)
    batch0 = torch.from_numpy(ids[:256])
    with torch.no_grad():
        out["text_batch_ms"] = host_ms(lambda: text_tower(batch0), device,
                                       reps=5, warmup=1)
    if on_card:
        cpu_tower = factory.build_text_encoder(RETRIEVAL_ARCH, device="cpu")
        cpu_tower.load_state_dict(text_tower.state_dict())
        errs = []
        with torch.no_grad():
            for sl in (slice(0, 256), slice((n_batches - 1) * 256, None)):
                got = text_tower(ids[sl]).cpu()
                want = cpu_tower(ids[sl])
                errs.append(float((got - want).abs().max()
                                  / want.abs().max()))
        del cpu_tower
        out["text_cpu_max_rel_err"] = max(errs)
        check(max(errs) <= TOL_TEXT, f"the text tower on the card against "
              f"the CPU: {errs} (tol {TOL_TEXT} of the largest |output|)")
    print(f"retrieval: text: synthetic merges ({CLIP_MERGES}, vocabulary "
          f"{len(tok.encoder)}, EOT {tok.eot_id}) in {out['merges_s']:.2f} "
          f"s; {len(prompts)} prompts tokenized in {out['tokenize_s']:.2f} "
          f"s; prompt_engineered_embeddings of {len(coco80)} categories "
          f"({n_batches} batches of 256) in "
          f"{out['prompt_engineered_s']:.3f} s, {out['text_batch_ms']:.3f} "
          f"ms a batch of 256 on the tower alone; first and last batch "
          f"against the CPU: max rel err {out.get('text_cpu_max_rel_err')} "
          f"(tol {TOL_TEXT}); flash launches 0", flush=True)

    # the head's plain embeddings at ViT-B/16's width, and the checkpoint
    # that phase_cli's training CLI computes them from
    head = factory.build_text_encoder(HEAD_ARCH, device=device)
    head.init_params(torch.Generator().manual_seed(22))
    with torch.no_grad():
        for p in head.parameters():  # as the fp16 checkpoint holds them
            p.copy_(p.half().float())
    out["head_embeddings"] = TE.plain_category_embeddings(
        head, tok, list(COCO81_CATEGORIES))
    check(out["head_embeddings"].shape == (81, 512),
          f"plain embeddings {out['head_embeddings'].shape}")
    torch.save({k: v.half().cpu() for k, v in head.state_dict().items()},
               assets / (HEAD_ARCH.replace("/", "-") + ".pt"))
    del head

    # the image bank: every fixture under BANK_COPIES names, 3 batches
    bank_dir = root / "bank_images"
    bank_dir.mkdir()
    paths = []
    for n in range(BANK_COPIES):
        for src in sorted(FIXTURES.glob("*.*g")):
            dst = bank_dir / f"{n}_{src.name}"
            shutil.copyfile(src, dst)
            paths.append(str(dst))
    n_bank_batches = -(-len(paths) // BANK_BATCH)
    enc = CLIPViT(**bank_encoder, device=device)
    enc.init_params(torch.Generator().manual_seed(23))
    enc_bf16 = CLIPViT(**bank_encoder, dtype=torch.bfloat16, device=device)
    enc_bf16.load_state_dict(enc.state_dict())
    banks, launches = {}, {}
    for name, e in (("f32", enc), ("bf16", enc_bf16)):
        zero_counts()
        banks[name], out[f"bank_{name}_s"] = _seconds(
            lambda: IE.extract_image_embeddings(paths, e,
                                                batch_size=BANK_BATCH),
            device)
        launches[name] = flash_only_launches(f"the {name} bank")
        if on_card:
            check(launches[name] == bank_encoder["layers"] * n_bank_batches,
                  f"bank {name}: {launches[name]} flash launches, expected "
                  f"{bank_encoder['layers']} a batch")
        mat = np.stack(list(banks[name].values()))
        check(mat.shape == (len(paths), bank_encoder["output_dim"])
              and np.isfinite(mat).all(), f"bank {name}: {mat.shape}")
    out["bank_launches"] = launches
    set_attn_impl(enc, "torch")
    torch_bank = IE.extract_image_embeddings(paths, enc, batch_size=BANK_BATCH)
    set_attn_impl(enc, "auto")
    f32 = np.stack(list(banks["f32"].values()))
    out["bank_f32_vs_torch"] = float(np.abs(
        f32 - np.stack(list(torch_bank.values()))).max())
    check(out["bank_f32_vs_torch"] <= TOL_BANK_TORCH,
          f"the f32 bank against the torch attention path: "
          f"{out['bank_f32_vs_torch']} (tol {TOL_BANK_TORCH})")
    out["bank_bf16_min_cos"] = float(
        (f32 * np.stack(list(banks["bf16"].values()))).sum(1).min())

    # where a bank image's time goes: the host, and the card's batch
    photos = sorted(FIXTURES.glob("photo_*_420_q75.jpg"))
    host = []
    for _ in range(3):
        for p in photos:
            t0 = time.perf_counter()
            IE.clip_preprocess(p, bank_encoder["input_resolution"])
            host.append((time.perf_counter() - t0) * 1e3)
    out["host_ms_per_image"] = statistics.median(host)
    x = torch.from_numpy(np.stack([
        IE.clip_preprocess(p, bank_encoder["input_resolution"])
        for p in paths[:BANK_BATCH]])).to(device)
    card, busy = {}, {}
    for name, e in (("f32", enc), ("bf16", enc_bf16)):
        with torch.no_grad():
            card[name] = host_ms(lambda: e.encode_image(x), device, reps=5,
                                 warmup=1)
        if on_card:
            by_name = device_kernels(lambda: e.encode_image(x))
            busy[name] = dict(
                busy_ms=sum(ms for ms, _ in by_name.values()),
                flash_ms=sum(ms for k, (ms, _) in by_name.items()
                             if "flash" in k))
    out["card_ms_per_batch"], out["card_busy"] = card, busy
    n_images = IMAGENET_TRAIN_ROWS + PASS_ROWS
    out["projected_hours"] = {
        name: dict(serial=n_images * (out["host_ms_per_image"]
                                      + ms / BANK_BATCH) / 3.6e6,
                   card_only=n_images * ms / BANK_BATCH / 3.6e6)
        for name, ms in card.items()}
    print(f"retrieval: bank: {len(paths)} images ({n_bank_batches} batches "
          f"of {BANK_BATCH}) in {out['bank_f32_s']:.3f} s f32, "
          f"{out['bank_bf16_s']:.3f} s bf16; flash launches "
          f"{json.dumps(launches)}; f32 against the torch path "
          f"{out['bank_f32_vs_torch']:.3e} (tol {TOL_BANK_TORCH}); bf16 "
          f"against f32: min cosine {out['bank_bf16_min_cos']:.5f}; decode "
          f"+ preprocess {out['host_ms_per_image']:.2f} ms a 500 x 375 JPEG "
          f"on the host; encode_image {json.dumps(card)} ms a batch of "
          f"{BANK_BATCH} (device busy, flash: {json.dumps(busy)}); "
          f"{n_images} images would take "
          f"{json.dumps(out['projected_hours'])} hours", flush=True)

    if on_card:
        # flash at encode_image's shape, f32 and bf16
        out["flash_rows"] = flash_rows(
            torch.Generator(device="cuda").manual_seed(24),
            [(f"bank encoder self {str(dtype)[6:]}", BANK_FLASH_SHAPE, dtype,
              BANK_ENCODER["layers"])
             for dtype in (torch.float32, torch.bfloat16)], "bank")
    out["library"] = library_path(root, enc, pe, device)
    del enc, enc_bf16, x
    if on_card:
        torch.cuda.empty_cache()

    # top-k at full bank size: COCO over ImageNet-train + PASS, ImageNet-S
    # over ImageNet-train
    text = torch.from_numpy(np.stack([pe[c] for c in coco80])).to(device)
    out["topk"] = {}
    for i, (name, (n_cat, rows)) in enumerate(topk_banks.items()):
        t = text
        if n_cat != len(coco80):
            g = torch.Generator(device=device).manual_seed(25)
            t = torch.randn(n_cat, text.shape[1], generator=g, device=device)
            t /= torch.linalg.vector_norm(t, dim=1, keepdim=True)
        out["topk"][name] = time_topk(name, t, rows, device, seed=30 + i)
    out["assets_dir"] = assets
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"retrieval: phase {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------- pseudo-masks

PSEUDO_SEED = 40
# the three attention shapes of a retrieved 500 x 375 photo (and of the
# 640 x 480 fixture): 683 x 512 after the resize, 688 x 512 padded, a
# 64 x 86 token grid; launches an image
SELFMASK_FLASH_SHAPES = [
    ("selfmask encoder self", (1, 6, 5505, 5505, 64), 12),
    ("selfmask decoder self", (1, 6, 20, 20, 64), 6),
    ("selfmask decoder cross", (1, 6, 20, 5504, 64), 6),
]
# the kernel path against the "torch" attention path, f32: mask
# probabilities apart, and objectness of its largest |value|; a best query
# or mask pixel may differ only within this of a tie
SELFMASK_LAUNCHES = sum(n for _, _, n in SELFMASK_FLASH_SHAPES)
# of those, the calls the f32 kernel splits into key ranges (the cross's)
SELFMASK_SPLIT_LAUNCHES = sum(n for _, shape, n in SELFMASK_FLASH_SHAPES
                              if fa.key_splits(*shape) > 1)
TOL_SELFMASK_TORCH = 1e-3
TOL_BILATERAL = 1e-9  # the card's soft output against the CPU rerun's
RETRIEVED_SETS = {"COCO / CoCA n500": 80 * 500, "ImageNet-S n500": 919 * 500}


def _best_mask(out: dict, h: int, w: int):
    """best_masks' steps on a forward's output -> (mask [h, w] bool, the
    chosen query's probabilities [h, w], the objectness margin of the best
    query over the second)."""
    from zutis_tpu_torch.ops.resize import interpolate

    up = interpolate(out["mask_pred"], scale_factor=4, mode="bilinear")
    obj = out["objectness"][0]
    top = torch.topk(obj, 2).values
    prob = up[0, int(obj.argmax())][:h, :w].cpu().numpy()
    return prob > 0.5, prob, float(top[0] - top[1])


def phase_pseudo_masks(root: Path, retrieval: dict, device="cuda",
                       selfmask_cfg: dict = None) -> dict:
    """Pseudo-labelling at full width over phase_retrieval's bank images
    (the committed 500 x 375 photos and the 640 x 480 fixture, first
    copy): a seeded SelfMask (DeiT-S/8, 20 queries, 6 decoder layers, f32)
    saved as a reference-layout `selfmask_nq20.pt` in the retrieval's
    assets directory (where phase_cli's training CLI looks) and loaded
    back through `load_selfmask`; `generate_pseudo_masks` at 512 px with
    every launch count set to 0 before and read after (flash 24 an image,
    nothing else); a second run written byte-equal; per image the
    SelfMask forward on the kernel path against the "torch" path, and the
    bilateral solve on the card against a CPU rerun on the same mask;
    flash f32 at the three SelfMask shapes; per-image host and card times,
    flash's share of SelfMask's device time, peak memory, hours projected
    for the retrieved sets. `selfmask_cfg` shrinks SelfMask for a
    rehearsal on the CPU, where the card's checks and times are left
    out."""
    from zutis_tpu_torch.data import pseudo_masks as PM
    from zutis_tpu_torch.data.transforms import normalize_image
    from zutis_tpu_torch.models.selfmask import SelfMask, pad_to_patch_multiple
    from zutis_tpu_torch.models.weights import (load_selfmask,
                                                selfmask_reference_state_dict)
    from zutis_tpu_torch.ops import bilateral

    t_phase = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    out = {}
    seeded = SelfMask(**(selfmask_cfg or {}), device=device).init_params(
        torch.Generator().manual_seed(PSEUDO_SEED))
    p_ckpt = retrieval["assets_dir"] / "selfmask_nq20.pt"
    torch.save(selfmask_reference_state_dict(seeded), p_ckpt)
    model = load_selfmask(str(p_ckpt), device=device,
                          **({"heads": selfmask_cfg["heads"]}
                             if selfmask_cfg else {}))
    check(all(torch.equal(a, b) for a, b in zip(
        seeded.state_dict().values(), model.state_dict().values())),
        "load_selfmask gave other weights than were saved")
    del seeded
    per_image = len(model.encoder.blocks) + 2 * len(model.decoder.layers)
    bank = root / "bank_images"
    images = [str(p) for p in sorted(bank.glob("0_photo_*_420_q75.jpg"))]
    images.append(str(bank / "0_largest_640x480_422_q80_progressive.jpg"))

    # generation, counted from 0, and again for determinism
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    written, gen_s = _seconds(lambda: PM.generate_pseudo_masks(
        images, str(root / "pseudo_masks_a"), model, device=device), device)
    out["launches"] = flash_only_launches("pseudo-mask generation")
    _, out["masked_launches"] = read_counts()
    out["split_launches"] = fa.flash_attention.split_launches
    out["peak_memory_gib"] = (torch.cuda.max_memory_allocated(device)
                              / 2 ** 30 if on_card else None)
    if on_card:
        check(out["launches"] == per_image * len(images),
              f"{out['launches']} flash launches for {len(images)} images: "
              f"expected {per_image} an image")
        check(out["masked_launches"] == 0, "SelfMask's flash took a mask")
        check(out["split_launches"] == SELFMASK_SPLIT_LAUNCHES * len(images),
              f"{out['split_launches']} split flash launches for "
              f"{len(images)} images: expected {SELFMASK_SPLIT_LAUNCHES} an "
              "image")
    again = PM.generate_pseudo_masks(images, str(root / "pseudo_masks_b"),
                                     model, device=device)
    check(all(Path(written[p]).read_bytes() == Path(again[p]).read_bytes()
              for p in images), "two runs wrote different pseudo-masks")
    areas = [float(rle.decode(json.loads(Path(written[p]).read_text()))
                   .mean()) for p in images]
    out.update(n_images=len(images), generate_s=gen_s, mask_areas=areas)
    print(f"pseudo: generate_pseudo_masks over {len(images)} images in "
          f"{gen_s:.3f} s ({out['launches']} flash launches, "
          f"{out['masked_launches']} masked, {out['split_launches']} split "
          f"into key ranges, no other kernel); a second run "
          f"wrote byte-equal JSON; mask areas {json.dumps(areas)}; peak "
          f"memory {out['peak_memory_gib']} GiB", flush=True)

    # per image: the kernel path against the torch path, the card's solve
    # against the CPU's, and where the time goes
    parts = {k: [] for k in ("decode_resize_ms", "bilateral_card_ms",
                             "bilateral_cpu_ms", "grid_keys_ms", "label_ms",
                             "resize_back_rle_ms")}
    agreement = []
    for i, p in enumerate(images):
        (size, resized), t = _seconds(lambda: PM.load_resized(p), "cpu")
        parts["decode_resize_ms"].append(t * 1e3)
        h, w = resized.shape[:2]
        x = torch.from_numpy(pad_to_patch_multiple(
            normalize_image(resized)[None], model.patch_size)).to(device)
        outs = {}
        with torch.inference_mode():
            for impl in ("torch", "auto"):
                set_attn_impl(model, impl)
                outs[impl] = model(x)
        mask_k, _, _ = _best_mask(outs["auto"], h, w)
        mask_t, prob_t, margin = _best_mask(outs["torch"], h, w)
        obj_scale = float(outs["torch"]["objectness"].abs().max())
        row = dict(
            image=os.path.basename(p),
            mask_pred_max_abs_diff=float((outs["auto"]["mask_pred"]
                                          - outs["torch"]["mask_pred"])
                                         .abs().max()),
            objectness_max_rel_diff=float(
                (outs["auto"]["objectness"] - outs["torch"]["objectness"])
                .abs().max()) / obj_scale,
            best_query_margin=margin / obj_scale,
            best_query_equal=bool(outs["auto"]["objectness"].argmax()
                                  == outs["torch"]["objectness"].argmax()),
            pixels_differ=int((mask_k != mask_t).sum()),
            nearest_tie=float(np.abs(prob_t - 0.5).min()))
        del outs
        agreement.append(row)
        check(row["mask_pred_max_abs_diff"] <= TOL_SELFMASK_TORCH
              and row["objectness_max_rel_diff"] <= TOL_SELFMASK_TORCH,
              f"SelfMask on the kernel path against the torch path: {row}")
        check(row["best_query_equal"]
              or row["best_query_margin"] <= TOL_SELFMASK_TORCH,
              f"the best query differs away from a tie: {row}")
        if row["best_query_equal"]:
            check((np.abs(prob_t[mask_k != mask_t] - 0.5)
                   <= TOL_SELFMASK_TORCH).all(),
                  f"best masks differ away from 0.5: {row}")

        mask = PM.selfmask_mask(model, resized, device).astype(np.float64)
        if i == 0:  # the solver's first call on a device pays its warm-up
            bilateral.bilateral_solver_output(resized, mask, device=device)
        (soft, refined), t = _seconds(lambda: bilateral.bilateral_solver_output(
            resized, mask, device=device), device)
        parts["bilateral_card_ms"].append(t * 1e3)
        (soft_cpu, refined_cpu), t = _seconds(
            lambda: bilateral.bilateral_solver_output(resized, mask,
                                                      device="cpu"), "cpu")
        parts["bilateral_cpu_ms"].append(t * 1e3)
        err = float(np.abs(soft - soft_cpu).max())
        row.update(bilateral_max_abs_err=err,
                   bilateral_near_half=int((np.abs(soft_cpu - 0.5)
                                            <= TOL_BILATERAL).sum()))
        check(err <= TOL_BILATERAL and np.array_equal(refined, refined_cpu),
              f"the bilateral solve on {device} against the CPU: {row}")
        _, t = _seconds(lambda: bilateral.grid_keys(resized), "cpu")
        parts["grid_keys_ms"].append(t * 1e3)
        _, t = _seconds(lambda: bilateral.refine_mask(soft), "cpu")
        parts["label_ms"].append(t * 1e3)
        _, t = _seconds(lambda: PM.write_mask(PM.to_original_size(
            refined.astype(np.uint8), size), str(root / "timed.json")), "cpu")
        parts["resize_back_rle_ms"].append(t * 1e3)
    out["agreement"] = agreement
    print("pseudo: kernel path against the torch path, card solve against "
          f"the CPU, per image: {json.dumps(agreement)}", flush=True)

    # SelfMask on the card, one 683 x 512 image: host clock and device
    _, resized = PM.load_resized(images[0])
    out["selfmask_ms"] = host_ms(lambda: PM.selfmask_mask(model, resized,
                                                          device),
                                 device, reps=5, warmup=1)
    if on_card:
        x = torch.from_numpy(pad_to_patch_multiple(
            normalize_image(resized)[None], model.patch_size)).to(device)
        by_name = device_kernels(lambda: model(x))
        busy = sum(ms for ms, _ in by_name.values())
        flash = sum(ms for k, (ms, _) in by_name.items() if "flash" in k)
        out.update(selfmask_busy_ms=busy, selfmask_flash_ms=flash,
                   selfmask_flash_share=flash / busy if busy else None)
        out["flash_rows"] = flash_rows(
            torch.Generator(device="cuda").manual_seed(41),
            [(n, shape, torch.float32, k)
             for n, shape, k in SELFMASK_FLASH_SHAPES], "selfmask")
    out["parts_ms"] = {k: statistics.median(v) for k, v in parts.items()}
    serial = (out["parts_ms"]["decode_resize_ms"] + out["selfmask_ms"]
              + out["parts_ms"]["bilateral_card_ms"]
              + out["parts_ms"]["resize_back_rle_ms"])
    out["serial_ms_per_image"] = serial
    out["projected_hours"] = {name: n * serial / 3.6e6
                              for name, n in RETRIEVED_SETS.items()}
    del model
    if on_card:
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"pseudo: per image (median of {len(images)}): decode + resize "
          f"{out['parts_ms']['decode_resize_ms']:.2f} ms on the host; "
          f"SelfMask {out['selfmask_ms']:.3f} ms host clock + sync (device "
          f"busy {out.get('selfmask_busy_ms')} ms, flash "
          f"{out.get('selfmask_flash_ms')} ms, share "
          f"{out.get('selfmask_flash_share')}); bilateral solve "
          f"{out['parts_ms']['bilateral_card_ms']:.2f} ms on {device}, "
          f"{out['parts_ms']['bilateral_cpu_ms']:.2f} ms on the host CPU "
          f"(of each: the grid's keys on the host "
          f"{out['parts_ms']['grid_keys_ms']:.2f} ms, fill + label + choice "
          f"{out['parts_ms']['label_ms']:.2f} ms); NEAREST back + RLE + JSON "
          f"{out['parts_ms']['resize_back_rle_ms']:.2f} ms; serially "
          f"{serial:.2f} ms an image: {json.dumps(out['projected_hours'])} "
          f"hours; phase {out['phase_s']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------------ phase 13
# the ResNet encoders, the DINO arm and the decoders at every head dim the
# factory gives: label -> (clip_arch, encoder_type, image size, flash
# launches a batch forward by head dim, the paths run). RN50: attnpool over
# 1 + 24 x 24 tokens at d 64, then 6 decoder self- and 6 cross-attentions at
# d 256 (2048 channels over 8 heads); the RN50x4 / x16 / x64 decoders at d
# 320, 384, 512 (2560, 3072, 4096 channels); ViT-L/14@336px: 24 encoder
# blocks at d 64 over 577 tokens, the decoder at d 128 (1024 channels) over
# 48 x 48 memory keys; the DINO arm: DINO ViT-B/16's 12 blocks at d 64, the
# decoder at the arch's text dim (ViT-B/16's 512: d 64; RN50x4's 640: d 80)
ENCODER_ARCHS = {
    "RN50": ("RN50", "clip", IMAGE_SIZE, {64: 1, 256: 12},
             ("serving", "eval", "train")),
    "DINO": ("ViT-B/16", "dino", IMAGE_SIZE, {64: 24},
             ("serving", "eval", "train")),
    "ViT-L/14@336px": ("ViT-L/14@336px", "clip", 336, {64: 24, 128: 12},
                       ("serving", "train")),
    "RN50x4": ("RN50x4", "clip", IMAGE_SIZE, {64: 1, 320: 12},
               ("serving", "train")),
    "RN50x16": ("RN50x16", "clip", IMAGE_SIZE, {64: 1, 384: 12}, ("serving",)),
    "RN50x64": ("RN50x64", "clip", IMAGE_SIZE, {64: 1, 512: 12},
                ("serving", "train")),
    "DINO@RN50x4": ("RN50x4", "dino", IMAGE_SIZE, {64: 12, 80: 12},
                    ("serving",)),
}
DILATED_ARCH = ("dilatedRN50", {64: 1, 256: 12})  # no x2 upsample: 12 x 12 tokens
# build_zutis at its default f32 on the kernel path: the arch and its
# launches a forward by head dim
FACTORY_F32_ARCH = ("RN50", {64: 1, 256: 12})
# head dims of the kernels' earlier slices: an arch with another one is
# held by phase_serving's `new_arch` gates and trains without the falling-
# loss check (finite losses over NEW_ARCH_TRAIN_STEPS)
EARLIER_HEAD_DIMS = (64, 96, 256)
NEW_ARCH_TRAIN_STEPS = 2  # after one warm-up
# learning rates other than TRAIN_LR: at 5e-5 (and at 5e-6) the seeded
# RN50x64's mask loss goes non-finite by its third step on the kernel and
# the "torch" attention path alike (PERF.md §6), so its steps take a rate
# its 4096-wide decoder survives
ARCH_TRAIN_LR = {"RN50x64": 1e-6}
# the d 256 kernel at the RN50 decoder's shapes: (name, shape, mask,
# dtype, strided)
ENCODER_FLASH_CASES = [
    ("RN50 decoder self d256", (BATCH, 8, 100, 100, 256), None,
     torch.bfloat16, False),
    ("RN50 decoder cross d256", (BATCH, 8, 100, 576, 256), None,
     torch.bfloat16, False),
    ("RN50 decoder self d256 strided", (BATCH, 8, 100, 100, 256), None,
     torch.bfloat16, True),
    ("RN50 decoder cross d256 strided", (BATCH, 8, 100, 576, 256), None,
     torch.bfloat16, True),
    # a ragged last chunk (577 keys) under a mask with an all-masked item
    ("d256 ragged kv_mask", (BATCH, 8, 100, 577, 256), "mask",
     torch.bfloat16, True),
]
# the encoder paths' new attention shapes, timed: (name, shape, dtype,
# launches a batch forward)
ENCODER_FLASH_SHAPES = [
    ("RN50 attnpool", (BATCH, 32, 577, 577, 64), torch.bfloat16, 1),
    ("RN50 decoder self", (BATCH, 8, 100, 100, 256), torch.bfloat16, 6),
    ("RN50 decoder cross", (BATCH, 8, 100, 576, 256), torch.bfloat16, 6),
    ("DINO decoder cross", (BATCH, 8, 100, 2304, 64), torch.bfloat16, 6),
]
# the kernels' new (dtype, head dim) pairs with the memory keys of their
# decoder's cross-attention: ViT-L/14@336px (d 128) and DINO@RN50x4 (d 80)
# over 48 x 48 tokens, RN50x4 / x16 / x64 (d 320, 384, 512) over 24 x 24 at
# 384 px; f32 at d 256 is RN50's
WIDE_DIMS = ([(torch.bfloat16, d, sk) for d, sk in (
    (80, 2304), (128, 2304), (320, 576), (384, 576), (512, 576))]
    + [(torch.float32, d, sk) for d, sk in (
        (80, 2304), (128, 2304), (256, 576), (320, 576), (384, 576),
        (512, 576))])
WIDE_ARCH_OF = {80: "DINO@RN50x4", 128: "ViT-L/14@336px", 256: "RN50",
                320: "RN50x4", 384: "RN50x16", 512: "RN50x64"}


def wide_flash_cases() -> list:
    """check_flash_case's (name, shape, mask, dtype, strided, biased) for
    each new (dtype, d): the decoder's self- and cross-attention at batch 8,
    the cross as [b, s, h, d] views, a ragged last chunk (577 keys) under a
    kv_mask with an all-masked item, and the cross masked and biased; in
    f32 also the cross of two images, masked and biased, whose 32 blocks
    take split keys (checked against the unsplit launch too); in bf16 at
    HALVES_HEAD_DIMS also one 32-key chunk, two chunks (fewer than the
    ring's stages at d 320 and 384) under a mask, and 2,304 keys wrapping
    the ring, masked and biased."""
    cases = []
    for dtype, d, sk in WIDE_DIMS:
        tag = f"{str(dtype)[6:]} d{d}"
        cases += [
            (f"{tag} self", (BATCH, 8, 100, 100, d), None, dtype, False, False),
            (f"{tag} cross", (BATCH, 8, 100, sk, d), None, dtype, False, False),
            (f"{tag} cross strided", (BATCH, 8, 100, sk, d), None, dtype, True,
             False),
            (f"{tag} ragged kv_mask", (BATCH, 8, 100, 577, d), "mask", dtype,
             True, False),
            (f"{tag} cross biased", (BATCH, 8, 100, sk, d), "mask", dtype, True,
             True)]
        if dtype == torch.float32:
            cases.append((f"{tag} cross split", (2, 8, 100, sk, d), "mask",
                          dtype, True, True))
        elif d in fa.HALVES_HEAD_DIMS:
            cases += [
                (f"{tag} one chunk", (BATCH, 8, 100, 20, d), None, dtype,
                 True, False),
                (f"{tag} two chunks kv_mask", (BATCH, 8, 100, 40, d), "mask",
                 dtype, True, False),
                (f"{tag} long biased", (2, 8, 100, 2304, d), "mask", dtype,
                 True, True)]
    return cases


# the new pairs' calls, timed: a batch forward's self- and cross-attention
# in both dtypes; and RN50x4's bf16 cross given a key bias (the log of a
# pooled memory token's count), which no forward on the paths launches
WIDE_FLASH_SHAPES = [
    (f"{WIDE_ARCH_OF[d]} decoder {kind}"
     + (" f32" if dtype == torch.float32 else ""), (BATCH, 8, 100, s, d),
     dtype, 6)
    for dtype, d, sk in WIDE_DIMS
    for kind, s in (("self", 100), ("cross", sk))] + [
    ("RN50x4 decoder cross biased", (BATCH, 8, 100, 576, 320),
     torch.bfloat16, 0, True)]
ENCODER_REQUESTS = 16  # two batch forwards and one synchronous infer
ENCODER_TRAIN_STEPS = 5  # after one warm-up
ENCODER_EVAL_SIZES = [(384, 384)] * 4 + [(352, 480)] * 4
ENCODER_EVAL_BATCH = 4
ENCODER_EVAL_CATEGORIES = 81
BN_STATS = ("running_mean", "running_var")


class _SemanticVal:
    """An in-memory semantic val set ("coca": no instances) of seeded
    images and labels."""

    def __init__(self, sizes, n_categories: int, seed: int = 0):
        self.name, self.n_categories = "coca", n_categories
        rng = np.random.RandomState(seed)
        self.samples = [{"image": rng.randn(3, h, w).astype(np.float32),
                         "semantic_mask": rng.randint(0, n_categories, (h, w))
                         .astype(np.int32)} for h, w in sizes]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def perturb_batchnorm(model: torch.nn.Module, seed: int) -> None:
    """BatchNorm's statistics and affine drawn off the identity (a seeded
    CPU generator), so that loading and freezing them show."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) * 1.5 + 0.5)
            elif name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)


def synthetic_encoder_checkpoint(model: ZUTIS, path: Path) -> dict:
    """The encoder's tensors in the layout of its family's published
    checkpoint, written to `path`: OpenAI's CLIP archive (`visual.*` in
    fp16; for an RN, torch BatchNorm's `num_batches_tracked` beside each
    BatchNorm) or an official DINO one (the fused `attn.qkv` / `attn.proj`,
    f32, and a head). Returns the dict written."""
    sd = {}
    for k, v in model.encoder.state_dict().items():
        if model.encoder_family != "dino":
            sd[f"visual.{k}"] = v.detach().to("cpu", torch.float16)
            if k.endswith("running_mean"):
                sd[f"visual.{k[:-len('running_mean')]}num_batches_tracked"] = \
                    torch.tensor(1000)
        else:
            k = (k.replace(".attn.in_proj_", ".attn.qkv.")
                 .replace(".attn.out_proj.", ".attn.proj."))
            sd[k] = v.detach().to("cpu", torch.float32)
    if model.encoder_family == "dino":
        sd["head.weight"] = torch.zeros(4, model.encoder.embed_dim)
    torch.save(sd, path)
    return sd


def load_encoder_checkpoint(model: ZUTIS, path: Path, written: dict) -> int:
    """Zero the encoder, load `path` through the family's loader
    (`load_clip_visual` for a ViT or RN, `load_dino_encoder`) and check
    every tensor is the file's; returns the tensors checked."""
    with torch.no_grad():
        for t in model.encoder.state_dict().values():
            t.zero_()
    if model.encoder_family != "dino":
        factory.load_clip_visual(model, str(path))
        want = {k[len("visual."):]: v for k, v in written.items()
                if not k.endswith("num_batches_tracked")}
    else:
        factory.load_dino_encoder(model, str(path))
        want = {(k.replace(".attn.qkv.", ".attn.in_proj_")
                 .replace(".attn.proj.", ".attn.out_proj.")): v
                for k, v in written.items() if not k.startswith("head.")}
    got = model.encoder.state_dict()
    check(sorted(got) == sorted(want), "the checkpoint's keys are not the "
          "encoder's")
    for k, v in want.items():
        check(torch.equal(got[k].cpu(), v.to(got[k].dtype)),
              f"{k} differs from the checkpoint after loading")
    return len(want)


def encoder_train(cfg: dict, image_size: int, n_categories: int,
                  per_forward: int, device, steps: int = ENCODER_TRAIN_STEPS,
                  n_max: int = TRAIN_N_MAX, require_fall: bool = True,
                  lr: float = TRAIN_LR) -> dict:
    """bench.py:174-201's training step on an encoder family (at learning
    rate `lr`): a warm-up and `steps` more on one batch, each with
    `per_forward` flash launches and one matcher launch; finite losses that
    fall (unless not `require_fall`); BatchNorm's statistics bit-unchanged
    and its affine moved (RN)."""
    on_card = device.type == "cuda"
    text, host = train_batch(cfg, image_size, TRAIN_BATCH, n_max, TRAIN_VALID,
                             n_categories)
    data = upload_batch(host, device)
    model = ZUTIS(**cfg, dtype=torch.bfloat16, device=device).init_params(
        torch.Generator().manual_seed(0))
    perturb_batchnorm(model, 3)
    stats0 = {k: v.clone() for k, v in model.named_buffers()
              if k.endswith(BN_STATS)}
    affine0 = {k: p.detach().clone() for k, p in model.named_parameters()
               if ".bn" in k or "downsample.1." in k}
    state = TrainState.create(model, base_lr=lr, n_iters=TRAIN_ITERS)
    step = make_train_step(model, text, n_categories,
                           ignore_index=TRAIN_IGNORE, device=device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, ms, per_step, by_dim = [], [], [], {}
    counted = counted_wrappers()
    for _ in range(steps + 1):
        zero_counts()
        m, s = _seconds(lambda: step(state, data), device)
        ms.append(s * 1e3)
        losses.append(m["loss"].item())
        per_step.append({n: w.launches for n, w in counted.items()})
        for d, n in fa.flash_attention.launches_by_dim.items():
            by_dim[d] = by_dim.get(d, 0) + n
    check(all(np.isfinite(losses)), f"a training loss is not finite: {losses}")
    if require_fall:
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    if on_card:
        for n in per_step:
            check(n["flash_attention"] == per_forward and
                  n["batched_hungarian"] == 1 and
                  sum(n[p] for p in PROBES) == 0,
                  f"a step's launches {n}, expected {per_forward} flash and "
                  "one matcher")
    for k, v in model.named_buffers():
        if k in stats0:
            check(torch.equal(v, stats0[k]), f"{k} moved in training")
    moved = sum(not torch.equal(p.detach(), affine0[k])
                for k, p in model.named_parameters() if k in affine0)
    check(moved == len(affine0), f"{len(affine0) - moved} of BatchNorm's "
          "weights and biases did not move")
    out = dict(losses=losses, lr=lr, step_ms=statistics.median(ms[1:]),
               launches=sum(n["flash_attention"] for n in per_step),
               launches_by_dim=by_dim,
               frozen_statistics=len(stats0), affine_moved=moved)
    if on_card:
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del state, step, model
    return out


def encoder_eval(model: ZUTIS, per_forward: int, device, sizes=ENCODER_EVAL_SIZES,
                 batch: int = ENCODER_EVAL_BATCH,
                 n_categories: int = ENCODER_EVAL_CATEGORIES) -> dict:
    """Trainer.evaluate in batches of one exact shape against the per-image
    regime: the scores, the launches, and on one batch the semantic maps
    of the stacked forward against each image's own. cuDNN may pick other
    convolution algorithms for a batch of 4 than for one image, so the two
    regimes agree to bf16 rounding, not bit for bit: the maps are held to
    MIN_SEMANTIC_AGREEMENT, the bar of the smoke's other bf16 paths."""
    text = np.random.RandomState(5).randn(n_categories, model.text_dim)
    text = (text / np.linalg.norm(text, axis=1, keepdims=True)).astype(
        np.float32)
    ds = _SemanticVal(sizes, n_categories)
    trainer = Trainer(model, text, device=device)
    scores, launches, by_dim = {}, {}, {}
    for b in (batch, 1):
        zero_counts()
        scores[b] = trainer.evaluate(None, ds, batch_images=b)
        launches[b] = fa.flash_attention.launches
        for d, n in fa.flash_attention.launches_by_dim.items():
            by_dim[d] = by_dim.get(d, 0) + n
    if device.type == "cuda":
        groups = sum(-(-sizes.count(s) // batch) for s in set(sizes))
        for b, n in ((batch, groups), (1, len(sizes))):
            check(launches[b] == per_forward * n, f"evaluate(batch_images="
                  f"{b}): {launches[b]} flash launches, expected "
                  f"{per_forward} x {n}")
    # the first shape's images, stacked as the batched regime stacks them
    x = torch.from_numpy(np.stack([s["image"] for s in ds.samples if s[
        "image"].shape == ds.samples[0]["image"].shape][:batch]))
    text_d = torch.from_numpy(text).to(device)
    with torch.inference_mode():
        stacked = model(x.to(device), inference=True)["patch_tokens"]
        single = torch.cat([model(x[i:i + 1].to(device), inference=True)
                            ["patch_tokens"] for i in range(len(x))])
    agree = (torch.einsum("nc,bhwc->bnhw", text_d, stacked).argmax(1)
             == torch.einsum("nc,bhwc->bnhw", text_d, single).argmax(1)
             ).float().mean().item()
    diff = (stacked - single).abs().max().item()
    d_miou = abs(scores[batch]["Mean IoU"] - scores[1]["Mean IoU"])
    d_acc = abs(scores[batch]["Pixel Acc"] - scores[1]["Pixel Acc"])
    print(f"encoders: eval exact-batched ({batch} a batch) against per "
          f"image: Mean IoU {scores[batch]['Mean IoU']:.6f} / "
          f"{scores[1]['Mean IoU']:.6f} (diff {d_miou:.3e}), Pixel Acc diff "
          f"{d_acc:.3e}; one batch's patch tokens max diff {diff:.3e}, "
          f"semantic agreement {agree:.4%} (tol {MIN_SEMANTIC_AGREEMENT:.1%});"
          f" img/s {scores[batch]['eval_images_per_sec']:.2f} / "
          f"{scores[1]['eval_images_per_sec']:.2f}", flush=True)
    check(agree >= MIN_SEMANTIC_AGREEMENT, "a batch's semantic map disagrees "
          "with its images' own")
    return dict(mean_iou={b: s["Mean IoU"] for b, s in scores.items()},
                mean_iou_diff=d_miou, pixel_acc_diff=d_acc,
                patch_tokens_max_diff=diff, semantic_agreement=agree,
                img_per_s={b: s["eval_images_per_sec"]
                           for b, s in scores.items()},
                launches=sum(launches.values()), launches_by_batch=launches,
                launches_by_dim=by_dim)


def kernel_instantiation(dtype, d: int) -> str:
    """The flash kernel that (dtype, head dim d) launches."""
    if dtype == torch.bfloat16:
        return (f"flash_halves_kernel<{d}>" if d in fa.HALVES_HEAD_DIMS
                else f"flash_wgmma_kernel<{d}>")
    if d in fa.F32_WIDE_HEAD_DIMS:
        return f"flash_f32_wide_kernel<{d}>"
    return f"flash_f32_kernel<{d},{fa.block_rows(2 * fa.KEY_CHUNK, d) // 64}>"


def f32_factory_forward(arch: str, image_size: int, device,
                        by_dim: dict) -> dict:
    """`factory.build_zutis(arch)` at its default dtype (f32), seeded: one
    batch-8 forward on the kernel path, `by_dim` flash launches by head
    dim, against the "torch" path (f32_kernel_forward)."""
    device = torch.device(device)
    model = factory.build_zutis(arch, device=device).init_params(
        torch.Generator().manual_seed(0)).eval()
    check(next(model.parameters()).dtype == torch.float32,
          f"build_zutis({arch!r}) is not f32 by default")
    x = torch.from_numpy(np.random.RandomState(2).randn(
        BATCH, 3, image_size, image_size).astype(np.float32)).to(device)
    set_attn_impl(model, "torch")
    with torch.inference_mode():
        want = model(x, inference=True)
    out = f32_kernel_forward(model, x, want, f"build_zutis({arch!r}) f32")
    if device.type == "cuda":
        check(out["launches_by_dim"] == by_dim, f"build_zutis({arch!r}) f32: "
              f"flash launches by head dim {out['launches_by_dim']}, "
              f"expected {by_dim}")
    del model
    return out


def phase_encoders(device="cuda", archs=None, image_size: int = IMAGE_SIZE,
                   n_categories: int = N_CATEGORIES, train_n_max: int = TRAIN_N_MAX,
                   eval_sizes=ENCODER_EVAL_SIZES,
                   factory_f32=FACTORY_F32_ARCH) -> dict:
    """The RN and DINO families and the wide decoders at full width
    (`ENCODER_ARCHS`; `archs` maps a label to (ZUTIS keyword arguments,
    image size, flash launches a forward by head dim, paths of "serving",
    "eval", "train" or "forward") to run other sizes, as on the CPU): the
    d 256 flash kernel and every (dtype, d) the wide decoders add against
    their plain version, their attention shapes timed (on a card); each
    model's encoder through a synthetic checkpoint of its family's published
    layout; InferenceServer with the launch counts by head dim, the semantic
    map against an f32 "torch"-path forward and the decode against a CPU
    rerun (an arch at a new head dim also its f32 forward on the kernel
    path); dilatedRN50's forward; training steps; the Trainer's exact-shape
    batched evaluation against per image; and `factory_f32` (arch, launches
    by head dim; None to skip) built by build_zutis at f32."""
    t_phase = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    if archs is None:
        archs = {label: (factory.zutis_config(arch, enc), size, by_dim, paths)
                 for label, (arch, enc, size, by_dim, paths)
                 in ENCODER_ARCHS.items()}
        d_arch, d_dims = DILATED_ARCH
        archs["dilatedRN50"] = (factory.zutis_config(d_arch), image_size,
                                d_dims, ("forward",))
    out = dict(flash_rows=[], wide_flash_rows=[], flash_max_abs_err=0.0,
               wide_max_abs_err={})
    if on_card:
        gen = torch.Generator(device="cuda").manual_seed(13)
        for case in ENCODER_FLASH_CASES:
            out["flash_max_abs_err"] = max(out["flash_max_abs_err"],
                                           check_flash_case(gen, *case))
        out["flash_rows"] = flash_rows(gen, ENCODER_FLASH_SHAPES, "encoders")
        for case in wide_flash_cases():
            key = case[0].split()[0] + " " + case[0].split()[1]  # "bf16 d80"
            err = check_flash_case(gen, *case)
            out["wide_max_abs_err"][key] = max(
                out["wide_max_abs_err"].get(key, 0.0), err)
        out["wide_flash_rows"] = flash_rows(gen, WIDE_FLASH_SHAPES,
                                            "wide heads")
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    for label, (cfg, size, by_dim, paths) in archs.items():
        t0 = time.perf_counter()
        per_forward = sum(by_dim.values())
        new_arch = bool(set(by_dim) - set(EARLIER_HEAD_DIMS))
        model = build_model(cfg, device)
        res = {}
        if "forward" in paths:
            # dilatedRN50: one batch forward, attnpool over 1 + 12 x 12
            # tokens, the cross-attention over 144 keys
            x = torch.from_numpy(np.random.RandomState(1).randn(
                BATCH, 3, size, size).astype(np.float32)).to(device)
            zero_counts()
            with torch.inference_mode():
                o = model(x, inference=True)
            _sync(device)
            grid = size // 32
            check(tuple(o["patch_tokens"].shape[1:3]) == (grid, grid),
                  f"{label}: a {tuple(o['patch_tokens'].shape)} token grid")
            check(all(bool(torch.isfinite(v).all()) for v in o.values()),
                  f"{label}: non-finite outputs")
            res["launches"] = fa.flash_attention.launches
            res["launches_by_dim"] = dict(fa.flash_attention.launches_by_dim)
            if on_card:
                check(res["launches_by_dim"] == by_dim, f"{label}: flash "
                      f"launches by head dim {res['launches_by_dim']} a "
                      f"forward, expected {by_dim}")
        else:
            family = cfg.get("encoder_family", "vit")
            if family == "rn":
                perturb_batchnorm(model, 2)
            with tempfile.TemporaryDirectory(dir=build) as tmp:
                path = Path(tmp) / ("dino_vitbase16_pretrain.pth"
                                    if family == "dino" else "clip.pt")
                written = synthetic_encoder_checkpoint(model, path)
                res["checkpoint_tensors"] = load_encoder_checkpoint(
                    model, path, written)
                res["checkpoint_bytes"] = path.stat().st_size
                del written
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            res["serving"] = phase_serving(
                cfg, size, n_categories, ENCODER_REQUESTS, device,
                launches_per_forward=per_forward, dims_per_forward=by_dim,
                model=model, new_arch=new_arch, nms_checks=False)
            if on_card:
                res["serving"]["peak_memory_gib"] = (
                    torch.cuda.max_memory_allocated(device) / 2 ** 30)
            if "eval" in paths:
                res["eval"] = encoder_eval(model, per_forward, device,
                                           sizes=eval_sizes)
            del model
            if on_card:
                torch.cuda.empty_cache()
            if "train" in paths:
                res["train"] = encoder_train(
                    cfg, size, n_categories, per_forward, device,
                    steps=NEW_ARCH_TRAIN_STEPS if new_arch else ENCODER_TRAIN_STEPS,
                    n_max=train_n_max, require_fall=not new_arch,
                    lr=ARCH_TRAIN_LR.get(label, TRAIN_LR))
        if on_card:
            torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        out[label] = res
        s, tr = res.get("serving", {}), res.get("train", {})
        print(f"encoders: {label}: {json.dumps({k: v for k, v in res.items() if k not in ('serving', 'eval', 'train')})}; "
              f"serving {s.get('img_per_s')} img/s sync, device busy "
              f"{s.get('step_device_busy_ms')} ms a step (flash "
              f"{s.get('step_flash_ms')} ms, share {s.get('step_flash_share')})"
              f", peak {s.get('peak_memory_gib')} GiB; train step "
              f"{tr.get('step_ms')} ms, losses {tr.get('losses')}, peak "
              f"{tr.get('peak_memory_gib')} GiB; {res['seconds']:.1f} s",
              flush=True)
    if factory_f32 is not None:
        zero_counts()
        out["factory_f32"] = f32_factory_forward(*factory_f32[:1], image_size,
                                                 device, factory_f32[1])
    zero_counts()  # the encoder paths are read; later phases count from 0
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"encoders: phase {out['phase_s']:.1f} s", flush=True)
    return out


def encoder_launches_by_dim(enc: dict, dtype: str) -> dict:
    """{path: {d: launches}} of flash on phase_encoders' paths in `dtype`
    ("bfloat16": each arch's serving, evaluation and training steps and
    dilatedRN50's forward; "float32": the f32 forwards on the kernel path,
    an arch at a new head dim's in serving and build_zutis's)."""
    out = {}
    for label, res in enc.items():
        if not (isinstance(res, dict) and "seconds" in res):
            continue
        if dtype == "bfloat16":
            parts = [res] + [res.get(p, {}) for p in ("serving", "eval", "train")]
        else:
            parts = [res.get("serving", {}).get("f32_kernel_forward") or {}]
        by_dim = {}
        for part in parts:
            for d, n in part.get("launches_by_dim", {}).items():
                by_dim[d] = by_dim.get(d, 0) + n
        out[label] = by_dim
    if dtype == "float32" and "factory_f32" in enc:
        out["factory_f32"] = enc["factory_f32"]["launches_by_dim"]
    return out


def encoder_launches(enc: dict) -> dict:
    """Flash's launches on phase_encoders' paths, both dtypes, by path."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        for path, by_dim in encoder_launches_by_dim(enc, dtype).items():
            out[path] = out.get(path, 0) + sum(by_dim.values())
    return out


def encoder_kernel_entries(enc: dict, flash_occ: dict, sass: dict) -> list:
    """The kernel record's entry for each flash instantiation past the
    earlier slices' d 64 and 96 (bf16 d 256 and every WIDE_DIMS pair): its
    launches on the encoder paths by path, its check cases' largest error,
    the calls of one forward beside their bound (a bf16 batch forward's 6
    self- and 6 cross-attentions; the f32 forward's 6 cross), occupancy and
    SASS counts. Fails for an instantiation no encoder path launched."""
    entries = []
    for dt, d in [(torch.bfloat16, 256)] + [(dt, d) for dt, d, _ in WIDE_DIMS]:
        dtype, instantiation = str(dt)[6:], kernel_instantiation(dt, d)
        base = instantiation.split("<")[0]
        kernel_names = {base, base.replace("_kernel", "_bias_kernel")}
        rows = [r for r in enc["flash_rows"] + enc["wide_flash_rows"]
                if r["shape"][4] == d and r["dtype"] == dtype]
        bytes_ms = sum(r["bound_ms"] * r["per_forward"] for r in rows
                       if r["bound_by"] == "bytes")
        all_ms = sum(r["bound_ms"] * r["per_forward"] for r in rows)
        launches = {path: n[d] for path, n in
                    encoder_launches_by_dim(enc, dtype).items() if n.get(d)}
        first = (dtype, d) == ("bfloat16", 256)  # the earlier slice's
        entry = {
            "name": "flash_attention d256" if first
            else f"flash_attention {dtype} d{d}",
            "route": "cuda",
            "source": "zutis_tpu_torch/csrc/flash_attention.cu",
            "replaces": "zutis_tpu/ops/flash_attention.py:53",
            "instantiation": instantiation,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": (enc["flash_max_abs_err"] if first
                            else enc["wide_max_abs_err"][f"{dtype} d{d}"]),
            "ms": sum(r["ms"] * r["per_forward"] for r in rows),
            "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in rows),
            "bound_ms": all_ms,
            "bound_by": "bytes" if bytes_ms >= all_ms - bytes_ms
            else "operations",
            "library_ms": sum(r["library_ms"] * r["per_forward"] for r in rows),
            "occupancy": {k: o for k, o in flash_occ.items()
                          if ("f32" in k.split()) == (dtype == "float32")
                          and f"d{d}" in k.split()},
            "sass": {k: c for k, c in sass.items()
                     if k.split("<")[0] in kernel_names
                     and re.match(rf"{d}\b", k.split("<")[1])},
            "shapes": rows,
        }
        check(entry["launches"] > 0, f"{entry['name']}: no launch on the "
              "encoder paths")
        entries.append(entry)
    return entries


# -------------------------------------------------------------- parallel

PARALLEL_MESH = {"data": 1, "model": 1}  # one card: NCCL at world size 1
PARALLEL_TURNS = ("plain", "mesh", "mesh", "plain")
PARALLEL_STEPS = 5  # a turn: a warm-up step, then 5 back to back
PARALLEL_REQUESTS = 16  # two batch forwards, and one synchronous infer
PARALLEL_TOPK = (80, IMAGENET_TRAIN_ROWS + PASS_ROWS, 768, 30)  # C, N, D, seed
SP_SHAPE = (8, 12, 577, 64)  # the serving encoder's self-attention
TOL_SP_BF16 = 8e-3  # of the largest |output|, as flash's bf16 checks
PARALLEL_TIMEOUT = 900


def parallel_job(root: Path, cfg_fp: Path, device, model_cfg=VIT_B16,
                 image_size: int = IMAGE_SIZE, n_categories: int = N_CATEGORIES,
                 topk=PARALLEL_TOPK, sp_shape=SP_SHAPE) -> dict:
    """phase_parallel's job: phase_cli's YAML with `mesh_axes` of one, and
    the shapes of the step, the server, the top-k and the attentions."""
    from zutis_tpu_torch.core.config import parse_yaml

    raw = parse_yaml(cfg_fp.read_text())
    raw.update(mesh_axes=PARALLEL_MESH, dir_ckpt=str(root / "ckpt_mesh"))
    mesh_fp = root / "cli_mesh.yaml"
    mesh_fp.write_text("".join(f"{k}: {json.dumps(v)}\n"
                               for k, v in raw.items()))
    check(parse_yaml(mesh_fp.read_text()) == raw, "the mesh YAML reads back")
    return {"device": str(device), "out": str(root),
            "cli_args": ["--p_config", str(mesh_fp), "--device", str(device)],
            "cli_config": str(mesh_fp), "model": model_cfg,
            "image_size": image_size, "n_categories": n_categories,
            "topk": list(topk), "sp_shape": list(sp_shape)}


def phase_parallel(root: Path, cfg_fp: Path, straight: dict, spread: float,
                   device="cuda", **job_kw) -> dict:
    """The parallel layer at world size 1: this script under `python -m
    torch.distributed.run --standalone --nproc_per_node 1` (NCCL on a
    card, gloo on the CPU), `parallel_rank` running the training CLI on
    phase_cli's YAML with `mesh_axes: {data: 1, model: 1}`, the training
    step with and without the mesh in turns, the server on the mesh
    against the server without, `topk_sharded` against `topk_local` over
    the retrieval phase's seeded bank, ring and Ulysses attention against
    dense attention. Here: the CLI's final parameters against phase_cli's
    straight run, within RESUME_SPREAD_FACTOR x what two runs without a
    mesh differ by (`spread`; bit-equal where that is 0)."""
    t_phase = time.perf_counter()
    device = torch.device(device)
    out = root / "parallel"
    out.mkdir()
    job = parallel_job(out, cfg_fp, device, **job_kw)
    job_fp = out / "job.json"
    job_fp.write_text(json.dumps(job))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the rank's process has the card to fill
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", str(Path(__file__).resolve()),
         "--parallel", str(job_fp)],
        capture_output=True, text=True, timeout=PARALLEL_TIMEOUT,
        cwd=Path(__file__).resolve().parent)
    for line in proc.stdout.splitlines():
        if line.startswith("parallel"):
            print(line, flush=True)
    check(proc.returncode == 0, "phase_parallel's rank failed:\n"
          + proc.stdout[-3000:] + proc.stderr[-6000:])
    res = json.loads((out / "result.json").read_text())

    from zutis_tpu_torch.core.config import checkpoint_dir

    mesh_cfg = Config.load(job["cli_config"])
    run = checkpoint_dir(mesh_cfg)
    final = os.path.join(run, "final_model.npz")
    # the figures, as the training CLI without a mesh draws them
    drawn = res["cli"]["figures"]
    log_points = list(range(mesh_cfg.iter_log, mesh_cfg.n_iters + 1,
                            mesh_cfg.iter_log))
    figures = figure_names(log_points, [f["num_iter"] for f in drawn
                                        if f["matched"]])
    check([f["num_iter"] for f in drawn] == log_points and sorted(
        n for n in os.listdir(run) if n.endswith(".png")) == sorted(figures),
        f"the training CLI on a mesh drew {drawn}")
    if device.type == "cuda":
        check_figure_launches(drawn, "the training CLI on a mesh")
    with np.load(final) as f:
        check(set(f.files) == set(straight), "the mesh run's final_model.npz "
              "holds other parameters")
        diff = max(float(np.abs(f[k] - v).max()) for k, v in straight.items())
    bound = RESUME_SPREAD_FACTOR * spread
    print(f"parallel: cli: mesh_axes {PARALLEL_MESH} under torchrun on "
          f"{res['backend']}: final parameters differ from phase_cli's "
          f"straight run by {diff:.3e}; two runs without a mesh "
          f"(phase_trainer's) by {spread:.3e}, bound "
          f"{'0 (bit-equal)' if spread == 0 else f'{bound:.3e}'}", flush=True)
    check(diff <= bound if spread > 0 else diff == 0.0,
          "the training CLI on a mesh of one left the straight runs' spread")
    res["cli"].update(max_diff=diff, straight_spread=spread)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"parallel: phase {res['phase_s']:.1f} s (the rank's process "
          f"{res['rank_s']:.1f} s)", flush=True)
    return res


def _parallel_step_turns(mesh, job, device) -> dict:
    """The training step at phase_train's configuration with and without
    the mesh (two models from one seed), in turns: a warm-up step, then
    PARALLEL_STEPS back to back and one read of the loss."""
    from zutis_tpu_torch.parallel import shard_model

    cfg, n_cat = job["model"], job["n_categories"]
    text, host = train_batch(cfg, job["image_size"], TRAIN_BATCH, TRAIN_N_MAX,
                             TRAIN_VALID, n_cat)
    data = upload_batch(host, device)
    runs = {}
    for name in ("plain", "mesh"):
        model = ZUTIS(**cfg, dtype=torch.bfloat16, device=device).init_params(
            torch.Generator().manual_seed(0))
        if name == "mesh":
            shard_model(model, mesh)
        state = TrainState.create(model, base_lr=TRAIN_LR, n_iters=TRAIN_ITERS)
        runs[name] = (state, make_train_step(
            model, text, n_cat, ignore_index=TRAIN_IGNORE, device=device))
    step_ms = {name: [] for name in runs}
    first_loss, launches = {}, {name: [] for name in runs}
    for name in PARALLEL_TURNS:
        state, step = runs[name]
        zero_counts()
        m = step(state, data)
        first_loss.setdefault(name, m["loss"].item())
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(PARALLEL_STEPS):
            m = step(state, data)
        m["loss"].item()
        step_ms[name].append((time.perf_counter() - t0) * 1e3 / PARALLEL_STEPS)
        launches[name].append(read_counts()[0])
        check(np.isfinite(m["loss"].item()), f"{name} step: non-finite loss")
        if device.type == "cuda":
            n = launches[name][-1]
            check(n["flash_attention"] == LAUNCHES_PER_FORWARD
                  * (PARALLEL_STEPS + 1) and n["batched_hungarian"]
                  == PARALLEL_STEPS + 1, f"{name} steps' launches {n}")
    rel = abs(first_loss["mesh"] - first_loss["plain"]) / abs(first_loss["plain"])
    print(f"parallel: step: {TRAIN_BATCH} x {job['image_size']} px, "
          f"{PARALLEL_STEPS} steps a turn in turns {'/'.join(PARALLEL_TURNS)}:"
          f" ms a step {json.dumps(step_ms)}; first losses {first_loss['plain']}"
          f" without, {first_loss['mesh']} on the mesh (rel {rel:.3e})",
          flush=True)
    check(rel <= 1e-6, "the first step's loss differs on the mesh")
    del runs
    return dict(step_ms=step_ms, first_loss=first_loss, launches=launches)


def _parallel_serve(mesh, job, device) -> dict:
    """InferenceServer with `mesh=` (queued, then sync) against the server
    without, on one seeded model at the serving shapes."""
    from zutis_tpu_torch.tools.parallel_check import _same_results

    cfg, size = job["model"], job["image_size"]
    model = build_model(cfg, device)
    rng = np.random.RandomState(0)
    text = rng.randn(job["n_categories"], cfg["text_dim"]).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    images = [rng.randn(3, size, size).astype(np.float32)
              for _ in range(PARALLEL_REQUESTS)]
    with torch.inference_mode():
        proposals = model(torch.from_numpy(np.stack(images[:BATCH])).to(
            device), inference=True)["mask_proposals"][:, -1]
    kw = dict(image_size=size, batch_size=BATCH, max_wait_ms=50,
              threshold=float(torch.quantile(
                  proposals.flatten()[::7].float(), 0.9)))
    want = InferenceServer(model, text, device=device, **kw).infer(images)
    served = InferenceServer(model, text, mesh=mesh, **kw)
    zero_counts()
    served.start()
    futures = [served.submit(im) for im in images]
    queued = [f.result(timeout=600) for f in futures]
    served.stop()
    sync = served.infer(images[:BATCH])
    launches = read_counts()[0]
    res = dict(queued=_same_results(queued, want),
               sync=_same_results(sync, want[:BATCH]),
               batches=served.batches, launches=launches)
    print(f"parallel: serve: {PARALLEL_REQUESTS} queued + {BATCH} sync "
          f"requests on the mesh in {served.batches} batch forwards "
          f"({json.dumps(launches)}) against the server without: "
          f"{json.dumps({k: res[k] for k in ('queued', 'sync')})}",
          flush=True)
    for api in ("queued", "sync"):
        r = res[api]
        check(r["semantic_agreement"] == 1.0 and r["same_instances"]
              and r["max_score_diff"] == 0.0,
              f"the server on the mesh ({api}) differs from the one without")
    if device.type == "cuda":
        check(launches["flash_attention"] == LAUNCHES_PER_FORWARD
              * served.batches and launches["mask_nms"] == served.batches,
              f"the mesh server's launches {launches}")
    return res


def _parallel_topk(mesh, job, device) -> dict:
    """`topk_sharded` on the mesh against `topk_local` over the retrieval
    phase's seeded bank (seeded text in place of its prompt embeddings)."""
    from zutis_tpu_torch.retrieval.bank import topk_local, topk_sharded

    n_cat, n_rows, dim, seed = job["topk"]
    bank = topk_bank(n_rows, dim, device, seed)
    g = torch.Generator(device=device).manual_seed(25)
    text = torch.randn(n_cat, dim, generator=g, device=device)
    text /= torch.linalg.vector_norm(text, dim=1, keepdim=True)
    vals, idx = topk_sharded(text, bank, TOPK_K, mesh)
    lv, li = topk_local(text, bank, TOPK_K)
    equal = bool(np.array_equal(idx, li.cpu().numpy()))
    same_vals = bool(np.array_equal(vals, lv.cpu().numpy()))
    ms = host_ms(lambda: topk_sharded(text, bank, TOPK_K, mesh), device,
                 reps=5, warmup=1)
    local_ms = host_ms(lambda: topk_local(text, bank, TOPK_K), device,
                       reps=5, warmup=1)
    print(f"parallel: topk: top-{TOPK_K} of {n_cat} categories over "
          f"{n_rows} x {dim}: topk_sharded {ms:.3f} ms, topk_local "
          f"{local_ms:.3f} ms; indices equal {equal}, values equal "
          f"{same_vals}", flush=True)
    check(equal and same_vals, "topk_sharded differs from topk_local")
    del bank
    return dict(ms=ms, local_ms=local_ms, rows=n_rows, categories=n_cat,
                k=TOPK_K, indices_equal=equal)


def _parallel_sp(mesh, job, device) -> dict:
    """Ring and Ulysses attention over the model axis against dense
    attention (ops/attention.py) at the serving encoder's shape in bf16;
    Ulysses' flash launches counted."""
    from zutis_tpu_torch.ops.attention import dot_product_attention
    from zutis_tpu_torch.parallel import sp

    b, h, s, d = job["sp_shape"]
    g = torch.Generator(device=device).manual_seed(26)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=device).to(
        torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        dense = dot_product_attention(q, k, v).float()
    ring_fn, ulysses_fn = (sp.make_ring_attention(mesh),
                           sp.make_ulysses_attention(mesh))
    ring = ring_fn(q, k, v).float()
    zero_counts()
    ulysses = ulysses_fn(q, k, v).float()
    launches = read_counts()[0]["flash_attention"]
    top = float(dense.abs().max())
    err = {"ring": float((ring - dense).abs().max()) / top,
           "ulysses": float((ulysses - dense).abs().max()) / top}
    ms = {"ring": host_ms(lambda: ring_fn(q, k, v), device),
          "ulysses": host_ms(lambda: ulysses_fn(q, k, v), device),
          "dense": host_ms(lambda: dot_product_attention(q, k, v), device)}
    print(f"parallel: sp: {[b, h, s, d]} bf16: error of the largest |output| "
          f"{json.dumps(err)} (bound {TOL_SP_BF16}); Ulysses' flash launches "
          f"{launches}; ms {json.dumps(ms)}", flush=True)
    check(max(err.values()) <= TOL_SP_BF16, "ring or Ulysses left dense "
          "attention")
    if device.type == "cuda":
        check(launches == 1, f"Ulysses launched flash {launches} times")
    return dict(max_rel_err=err, ulysses_flash_launches=launches, ms=ms,
                shape=[b, h, s, d])


def parallel_rank(job_fp: Path) -> None:
    """One rank of phase_parallel, under torchrun; writes result.json."""
    import torch.distributed as dist

    from zutis_tpu_torch.cli import main as cli_main
    from zutis_tpu_torch.parallel import close_mesh, create_mesh

    t0 = time.perf_counter()
    job = json.loads(job_fp.read_text())
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = create_mesh(PARALLEL_MESH, device=device)
    device = mesh.device
    backend = dist.get_backend()
    check(mesh.size == 1 and backend == ("nccl" if device.type == "cuda"
                                         else "gloo"),
          f"{mesh} on {backend}")
    res = {"backend": backend, "world_size": dist.get_world_size()}
    print(f"parallel: {mesh} on {backend}", flush=True)
    zero_counts()
    t1 = time.perf_counter()
    with figure_record() as drawn:
        cli_main.main(job["cli_args"])
    _sync(device)
    launches, masked = read_counts()
    res["cli"] = dict(s=time.perf_counter() - t1, launches=launches,
                      masked_launches=masked, figures=drawn)
    print(f"parallel: cli: {res['cli']['s']:.1f} s, launches "
          f"{json.dumps(launches)}", flush=True)
    res["step"] = _parallel_step_turns(mesh, job, device)
    res["serve"] = _parallel_serve(mesh, job, device)
    res["topk"] = _parallel_topk(mesh, job, device)
    res["sp"] = _parallel_sp(mesh, job, device)
    res["rank_s"] = time.perf_counter() - t0
    (Path(job["out"]) / "result.json").write_text(json.dumps(res))
    close_mesh(mesh)


def figure_launches(kernel: str, trainer: dict, cli: dict,
                    par: dict) -> dict:
    """`kernel`'s launches for the figures by path: each log point's,
    counted around its `_visualise_train` call in the main run (see
    `figure_record`), summed."""
    paths = {"trainer": trainer["visualised"], "cli_train": cli["figures"],
             "cli_resumed": cli["resumed_figures"],
             "parallel_cli_mesh": par["cli"]["figures"]}
    return {p: sum(f["launches"][kernel] for f in figs)
            for p, figs in paths.items()}


def parallel_launches(par: dict) -> dict:
    """The parallel phase's launches by kernel and path, each counted from
    0: the training CLI on the mesh (its steps and evaluations), the step
    turns with and without the mesh, the server on the mesh, Ulysses."""
    turns = par["step"]["launches"]
    out = {}
    for kernel in ("flash_attention", "batched_hungarian", "mask_nms",
                   "pairwise_iou"):
        out[kernel] = {
            "cli_mesh": par["cli"]["launches"][kernel],
            "step_turns": sum(t[kernel] for name in turns
                              for t in turns[name]),
            "serve_mesh": par["serve"]["launches"][kernel]}
    out["flash_attention"]["ulysses"] = par["sp"]["ulysses_flash_launches"]
    return out


def main() -> None:
    if sys.argv[1:2] == ["--parallel"]:  # phase_parallel's rank
        parallel_rank(Path(sys.argv[2]))
        return
    card, libs = phase_card()
    sass = sass_check(libs)
    max_err, rows, flash_occ = phase_kernel()
    probe_err, probe_rel, probe_rows, occupancy = phase_probes()
    tune_launches, tune_results = phase_tune()
    stats = phase_serving()
    print(f"serving on {card}: {json.dumps(stats)}", flush=True)
    ev = phase_eval()
    print(f"eval on {card}: " + json.dumps(
        {k: v for k, v in ev.items() if k != "flash_rows"}), flush=True)
    tr = phase_train()
    print(f"train on {card}: {json.dumps(tr)}", flush=True)
    lev = phase_levers()
    print(f"levers on {card}: " + json.dumps(
        {k: v for k, v in lev.items() if k != "flash_rows"}), flush=True)
    lev_launches = {
        "levers_serving": sum(r["launches"] for r in lev["serving"].values()),
        "levers_eval": lev["eval"]["launches"],
        "levers_train": lev["train"]["launches"]["flash_attention"]}
    enc = phase_encoders()
    print(f"encoders on {card}: " + json.dumps(
        {k: v for k, v in enc.items()
         if k not in ("flash_rows", "wide_flash_rows")}), flush=True)
    trainer = phase_trainer(tr)
    print(f"trainer on {card}: {json.dumps(trainer)}", flush=True)
    vis = trainer["visualised"]
    parts = ("forward", "matcher", "compose", "write")
    print("visualise: host ms a log point of Trainer.fit (log points "
          f"{[v['num_iter'] for v in vis]}; forward, matcher, composition, "
          "write): " + json.dumps({p: [v[f"{p}_ms"] for v in vis]
                                   for p in parts})
          + "; medians " + json.dumps({p: statistics.median(
              v[f"{p}_ms"] for v in vis) for p in parts})
          + f" on {card}", flush=True)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ret = phase_retrieval(Path(tmp))
        print(f"retrieval on {card}: " + json.dumps(
            {k: v for k, v in ret.items() if k not in (
                "head_embeddings", "assets_dir", "library", "flash_rows")}),
            flush=True)
        pseudo = phase_pseudo_masks(Path(tmp), ret)
        print(f"pseudo-masks on {card}: " + json.dumps(
            {k: v for k, v in pseudo.items() if k != "flash_rows"}),
            flush=True)
        cli = phase_cli(trainer, ret, parallel=phase_parallel)
    par = cli.pop("parallel")
    print(f"cli on {card}: {json.dumps(cli)}", flush=True)
    print(f"parallel on {card}: {json.dumps(par)}", flush=True)
    par_launches = parallel_launches(par)
    cli_generation = cli["pseudo_masks"]["launches"]

    def per_forward(key):
        return sum(r[key] * r["per_forward"] for r in rows)

    # the summed bound splits into calls bound by bytes and by operations
    bytes_ms = sum(r["bound_ms"] * r["per_forward"] for r in rows
                   if r["bound_by"] == "bytes")
    ops_ms = per_forward("bound_ms") - bytes_ms
    eval_rows = ev["flash_rows"]

    def eval_forward(key):
        return sum(r[key] * r["per_forward"] for r in eval_rows)

    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "zutis_tpu_torch/csrc/flash_attention.cu",
        "replaces": "zutis_tpu/ops/flash_attention.py:53",
        # the main paths, each counted from 0: the serving forwards, the
        # eval's padded forwards, the training steps, Trainer.fit (its
        # steps, its figures' forwards and its evaluations' padded
        # forwards), the retrieval's image banks (f32, bf16, and the
        # library path's two archives), the pseudo-masks' SelfMask, and the
        # two CLIs on images from disk (the training CLI with the
        # pseudo-masks it made and its figures, its resumed run and the
        # eval CLI at depth 1 and 2 and per image)
        "launches": (stats["launches"] + ev["launches"]
                     + tr["launches"]["flash_attention"]
                     + trainer["launches"]["flash_attention"]
                     + sum(ret["bank_launches"].values())
                     + ret["library"]["launches"]
                     + pseudo["launches"]
                     + cli["launches"]["flash_attention"]
                     + cli["resumed_launches"]["flash_attention"]
                     + sum(e["flash_attention"]
                           for e in cli["eval_launches"].values())
                     + sum(lev_launches.values())
                     + sum(encoder_launches(enc).values())
                     + sum(par_launches["flash_attention"].values())),
        "launches_by_path": {"serving": stats["launches"],
                             "eval": ev["launches"],
                             "eval_masked": ev["masked_launches"],
                             "train": tr["launches"]["flash_attention"],
                             "trainer": trainer["launches"]["flash_attention"],
                             "trainer_masked": trainer["masked_launches"],
                             "retrieval_bank": ret["bank_launches"],
                             "retrieval_library": ret["library"]["launches"],
                             "pseudo_masks": pseudo["launches"],
                             "cli_pseudo_masks": cli_generation,
                             "cli_train": (cli["launches"]["flash_attention"]
                                           - cli_generation),
                             "cli_train_masked": cli["masked_launches"],
                             "cli_resumed": cli["resumed_launches"][
                                 "flash_attention"],
                             "cli_eval": {d: e["flash_attention"] for d, e in
                                          cli["eval_launches"].items()},
                             **lev_launches,
                             "encoders": encoder_launches(enc),
                             "parallel": par_launches["flash_attention"]},
        # of those, the figures' forwards, each log point's counted
        "figure_launches": figure_launches("flash_attention", trainer, cli,
                                           par),
        # the launches given a key bias (the levers' ToMe encoder and
        # padded pooled cross-attention), by path
        "biased_launches": {
            "levers_serving": sum(r["biased_launches"]
                                  for r in lev["serving"].values()),
            "levers_eval": lev["eval"]["biased_launches"],
            "levers_train": lev["train"]["biased_launches"]},
        # of the f32 launches, those split into key ranges (each with a
        # flash_combine_kernel launch): SelfMask's cross-attention
        "split_launches": (pseudo["split_launches"]
                           + cli["pseudo_masks"]["split_launches"]),
        "split_launches_by_path": {
            "pseudo_masks": pseudo["split_launches"],
            "cli_pseudo_masks": cli["pseudo_masks"]["split_launches"]},
        "max_abs_err": max(max_err, ev["flash_max_abs_err"],
                           lev["flash_max_abs_err"], enc["flash_max_abs_err"],
                           *enc["wide_max_abs_err"].values(),
                           *(r["max_abs_err"] for r in ret["flash_rows"]
                             + pseudo["flash_rows"] + enc["flash_rows"]
                             + enc["wide_flash_rows"])),
        # times and bound: the 24 calls of one batch-8 forward at 384 px
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_forward("library_ms"),
        # occupancy of the block the encoder self-attention (12 of the 24
        # calls) launches; every shape's own is in its row
        "smem_bytes": rows[0]["smem_bytes"],
        "blocks_per_sm": rows[0]["blocks_per_sm"],
        "block_q": fa.KEY_CHUNK,  # query rows a bf16 block, at every shape
        # f32: 128 rows a block at d 64 for sq > 64, else 64 (block_rows);
        # both kernels' occupancy by dtype, head dim and block
        "occupancy": flash_occ,
        "sass": {k: c for k, c in sass.items() if k.startswith("flash")},
        "shapes": rows,
        # the 24 calls of one padded forward, batch 32, 512 x 640 bucket
        "eval_forward": {k: eval_forward(k) for k in
                         ("ms", "plain_ms", "bound_ms", "library_ms")},
        "eval_shapes": eval_rows,
        # encode_image's 24 calls a bank batch at ViT-L/14@336px, f32 and
        # bf16, each beside the bound at its dtype's rate
        "retrieval_shapes": ret["flash_rows"],
        # SelfMask's 24 calls an image (f32, a 683 x 512 photo), each
        # beside its bound at 989 / 3 TFLOP/s; flash's share of SelfMask's
        # device time (torch.profiler)
        "selfmask_shapes": pseudo["flash_rows"],
        "selfmask_flash_share": pseudo["selfmask_flash_share"],
        # the levers' calls (ToMe encoder, pooled cross-attention; bf16
        # times beside the bound with the bias's bytes and SDPA given the
        # bias as a float mask)
        "lever_shapes": lev["flash_rows"],
        # the RN50 and DINO paths' calls (attnpool, the d 256 decoder, the
        # DINO decoder's cross-attention), and the wide decoders' calls at
        # every new (dtype, head dim)
        "encoder_shapes": enc["flash_rows"],
        "wide_head_shapes": enc["wide_flash_rows"],
        # device time of the 24 flash kernels inside one training step
        # (torch.profiler), and the Function's gradient check
        "train_forward_ms": tr["flash_in_step_ms"],
        "train_grad_max_rel_err": tr["flash_grad_max_rel_err"],
    }]
    kernels += encoder_kernel_entries(enc, flash_occ, sass)
    tool = next(r for r in probe_rows if r["name"] == "tool")
    headline = {"single_attention": "single unroll",
                "fastsm_attention": "fastsm lane", "kt_attention": "kt"}
    for name, (_, _, replaces) in PROBES.items():
        family = name.split("_")[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "zutis_tpu_torch/csrc/attention_probes.cu",
            "replaces": replaces,
            "launches": tune_launches[name],
            "max_abs_err": probe_err[name],
            "max_rel_err": probe_rel[name],  # of the largest |output|
            # one call at the tuning tool's shape [64, 12, 577, 577, 64]
            "ms": tool["ms"][headline[name]],
            "plain_ms": tool["plain_ms"][name],
            "bound_ms": tool["bound_ms"],
            "bound_by": tool["bound_by"],
            "library_ms": tool["library_ms"],
            "serving_launches": 0,
            "shapes": [dict(r, ms={k: t for k, t in r["ms"].items()
                                   if k.startswith(family)},
                            plain_ms=r["plain_ms"][name])
                       for r in probe_rows],
        })
        # occupancy of the headline call (d 64, block_q 128), the family's
        # other occupancies beside it, and the SASS opcode counts of its kernel
        layout = " unroll" if family == "single" else ""
        kernel_name = "single_kernel" if family == "single" else "maxfree_kernel"
        kernels[-1].update(
            occupancy[f"{family}{layout} d64 block_q 128"], block_q=128,
            occupancy={k: o for k, o in occupancy.items()
                       if k.split()[0] == family},
            sass={k: c for k, c in sass.items() if k.startswith(kernel_name)})
    matcher = tr["matcher"]
    kernels.append({
        "name": "batched_hungarian",
        "route": "cuda",
        "source": "zutis_tpu_torch/csrc/hungarian.cu",
        "replaces": "zutis_tpu/ops/hungarian.py:34",
        # the training steps, Trainer.fit's and the training CLI's (and
        # its resumed run's), and their matched-pairs figures, each path
        # counted from 0
        "launches": (tr["launches"]["batched_hungarian"]
                     + lev["train"]["launches"]["batched_hungarian"]
                     + trainer["launches"]["batched_hungarian"]
                     + cli["launches"]["batched_hungarian"]
                     + cli["resumed_launches"]["batched_hungarian"]
                     + sum(par_launches["batched_hungarian"].values())),
        "launches_by_path": {
            "train": tr["launches"]["batched_hungarian"],
            "levers_train": lev["train"]["launches"]["batched_hungarian"],
            "trainer": trainer["launches"]["batched_hungarian"],
            "cli_train": cli["launches"]["batched_hungarian"],
            "cli_resumed": cli["resumed_launches"]["batched_hungarian"],
            "parallel": par_launches["batched_hungarian"]},
        # of those, the matched-pairs figures': one a figure
        "figure_launches": figure_launches("batched_hungarian", trainer,
                                           cli, par),
        "max_abs_err": 0.0,  # col4row bit-equal to the plain version
        # one call on a training step's [48, 10, 100] costs
        "ms": matcher["ms"],
        "plain_ms": matcher["plain_ms"],
        "bound_ms": matcher["bound_ms"],
        "bound_by": matcher["bound_by"],
        "library_ms": None,  # no PyTorch call solves an assignment
        "host_yardstick_ms": matcher["scipy_ms"],  # scipy, 48 problems
        "in_step_ms": tr["matcher_in_step_ms"],
        "shape": matcher["shape"],
    })
    def selection_by_path(kernel: str, key: str) -> dict:
        """`kernel`'s launches by path (`key` in the phases' own records)."""
        return {
            "serving": stats[key],
            "eval": ev[key],
            "levers_serving": sum(r[key] for r in lev["serving"].values()),
            "levers_eval": lev["eval"][key],
            "encoders_serving": {label: res["serving"][key]
                                 for label, res in enc.items()
                                 if isinstance(res, dict) and "serving" in res},
            "trainer": trainer["launches"][kernel],
            "cli_train": cli["launches"][kernel],
            "cli_resumed": cli["resumed_launches"][kernel],
            "cli_eval": {d: e[kernel] for d, e in cli["eval_launches"].items()},
            "parallel": par_launches[kernel],
        }

    nms_by_path = selection_by_path("mask_nms", "nms_launches")
    iou_by_path = selection_by_path("pairwise_iou", "iou_launches")
    check(iou_by_path == nms_by_path, f"IoU launches {iou_by_path} differ "
          f"from the NMS launches {nms_by_path} by path")
    kernels.append({
        "name": "mask_nms",
        "route": "cuda",
        "source": "zutis_tpu_torch/csrc/nms.cu",
        "replaces": "zutis_tpu/ops/nms.py:58",
        # one a serving or eval step, each path counted from 0
        "launches": sum(sum(n.values()) if isinstance(n, dict) else n
                        for n in nms_by_path.values()),
        "launches_by_path": nms_by_path,
        "max_abs_err": 0.0,  # keep equal, scores bit-equal to the plain rounds
        # one call on a serving step's [8, 100] selection
        "ms": stats["nms"]["ms"],
        "plain_ms": stats["nms"]["plain_ms"],
        "bound_ms": stats["nms"]["bound_ms"],
        "bound_by": stats["nms"]["bound_by"],
        "library_ms": None,  # no PyTorch call runs greedy NMS
        "plain_host_ms": stats["nms"]["plain_host_ms"],
        "shape": stats["nms"]["shape"],
        "eval": ev["nms"],  # the eval step's [32, 100]
    })
    kernels.append({
        "name": "pairwise_iou",
        "route": "cuda",
        "source": "zutis_tpu_torch/csrc/mask_iou.cu",
        "replaces": "zutis_tpu/ops/nms.py:46",
        # one with every mask_nms on the card, each path counted from 0
        "launches": sum(sum(n.values()) if isinstance(n, dict) else n
                        for n in iou_by_path.values()),
        "launches_by_path": iou_by_path,
        # counts equal, IoU and areas bit-equal to the plain version
        "max_abs_err": max(r["max_abs_err"] for r in (
            ev["iou"], stats["iou"], stats["iou_per_image"])),
        # one call on the eval step's [32, 100, 512, 640] masks
        "ms": ev["iou"]["ms"],
        "plain_ms": ev["iou"]["plain_ms"],
        "bound_ms": ev["iou"]["bound_ms"],
        "bound_by": ev["iou"]["bound_by"],
        "library_ms": ev["iou"]["library_ms"],  # torch._int_mm image by image
        "float64_product_ms": ev["iou"]["float64_product_ms"],
        "shape": ev["iou"]["shape"],
        "serving": stats["iou"],  # [8, 100, 24, 24]
        "per_image": stats["iou_per_image"],  # [1, 100, 375, 500]
        "eval_on_the_float64_product": ev["float64_iou_route"],
        "sass": {k: c for k, c in sass.items()
                 if k.startswith("mask_counts_kernel")},
    })
    print("tune runs: " + json.dumps(
        [{k: r[k] for k in ("variant", "exp_mode", "dots_only", "max_err", "ms")}
         for r in tune_results]), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
