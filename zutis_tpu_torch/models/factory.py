"""Model factory, ViT half: clip_arch string -> the port's ZUTIS, and the
OpenAI CLIP visual tower's weights into its encoder (the port of
zutis_tpu/models/factory.py's `_VIT_SPECS`, `normalize_clip_arch`,
`clip_spec`, `build_zutis`, `clip_checkpoint_path`, and of the visual half
of `load_clip_params`).

CLIP checkpoints are the official OpenAI .pt files in a local assets
directory (no network at run time): <assets>/ViT-B-16.pt, ViT-B-32.pt,
ViT-L-14.pt, ViT-L-14-336px.pt.

Not ported yet (each raises NotImplementedError, ROADMAP.md, queue 1,
item 7): the ResNet archs (RN50 ... RN50x64) and their `dilated` variants,
`encoder_type="dino"`, the text tower and the tokenizer. The opt-in levers
`tome_r` and `decoder_pool` are item 5.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

import torch

from zutis_tpu_torch.models.zutis import ZUTIS

_VIT_SPECS = {
    # width, layers, heads, patch, embed_dim, input_resolution
    "ViT-B/32": (768, 12, 12, 32, 512, 224),
    "ViT-B/16": (768, 12, 12, 16, 512, 224),
    "ViT-L/14": (1024, 24, 16, 14, 768, 224),
    "ViT-L/14@336px": (1024, 24, 16, 14, 768, 336),
}

# the RN archs the JAX package builds (reference utils/utils.py:165); the
# port names them only to refuse them
_RN_ARCHS = ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64")

_NOT_PORTED = "not ported yet (ROADMAP.md, queue 1, item 7)"


def normalize_clip_arch(clip_arch: str) -> tuple:
    """-> (base_arch, upsample_tokens). 'dilatedRN50' is RN50 with the x2
    token upsample disabled — the reference's `lstrip("dilated")` plus the
    condition at networks/zutis.py:488-497; there is no actual dilation."""
    if clip_arch.startswith("dilated"):
        base = clip_arch[len("dilated"):]
        assert base in _RN_ARCHS, f"unsupported clip_arch {clip_arch!r}"
        return base, False
    return clip_arch, True


@dataclass
class ClipSpec:
    width: int
    layers: int
    heads: int
    patch: int
    embed_dim: int
    input_resolution: int


def clip_spec(clip_arch: str) -> ClipSpec:
    if clip_arch in _RN_ARCHS:
        raise NotImplementedError(f"clip_arch {clip_arch!r}: the ResNet "
                                  f"encoders are {_NOT_PORTED}")
    assert clip_arch in _VIT_SPECS, (
        f"unsupported ViT clip_arch {clip_arch!r}; ViT variants: "
        f"{sorted(_VIT_SPECS)}; RN variants: {sorted(_RN_ARCHS)}"
    )
    return ClipSpec(*_VIT_SPECS[clip_arch])


def build_zutis(
    clip_arch: str = "ViT-B/16",
    n_queries: int = 100,
    n_decoder_layers: int = 6,
    n_heads: int = 8,
    stop_gradient: bool = True,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "auto",
    encoder_type: str = "clip",
    tome_r: int = 0,
    decoder_pool: int = 1,
    device="cuda",
) -> ZUTIS:
    """The port's ZUTIS for a CLIP ViT arch, with uninitialised parameters
    on `device` (call `init_params` or load weights)."""
    base_arch, _ = normalize_clip_arch(clip_arch)
    if encoder_type == "dino":
        raise NotImplementedError(f"encoder_type 'dino' is {_NOT_PORTED}")
    if encoder_type != "clip":
        raise ValueError(f"unknown encoder_type {encoder_type!r}")
    if not stop_gradient:
        raise NotImplementedError(
            "stop_gradient=False: the port's ZUTIS always stops the "
            "gradient into the encoder's tokens before ffn1")
    if tome_r or decoder_pool != 1:
        raise NotImplementedError(
            "tome_r and decoder_pool are not ported yet (ROADMAP.md, queue "
            "1, item 5)")
    s = clip_spec(base_arch)
    return ZUTIS(
        width=s.width,
        encoder_layers=s.layers,
        encoder_heads=s.heads,
        patch_size=s.patch,
        text_dim=s.embed_dim,
        input_resolution=s.input_resolution,
        n_queries=n_queries,
        n_decoder_layers=n_decoder_layers,
        n_heads=n_heads,
        dtype=dtype,
        attn_impl=attn_impl,
        device=device,
    )


def clip_checkpoint_path(clip_arch: str, assets_dir: str) -> str:
    base_arch, _ = normalize_clip_arch(clip_arch)
    name = base_arch.replace("/", "-").replace("@", "-") + ".pt"
    return os.path.join(assets_dir, name)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An OpenAI CLIP `.pt`: a TorchScript archive or a plain state dict
    (optionally under "state_dict"), as float32 tensors on the CPU."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd.get("state_dict"), dict):
            sd = sd["state_dict"]
    return {k: v.detach().float() for k, v in sd.items() if torch.is_tensor(v)}


def load_clip_visual(model: ZUTIS, path: str) -> ZUTIS:
    """Load the CLIP ViT visual tower of the OpenAI checkpoint at `path`
    (its `visual.*` tensors) into `model.encoder`, strictly: every encoder
    parameter must come from the file. Returns `model`."""
    sd = load_torch_state_dict(path)
    visual = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")}
    if "class_embedding" not in visual:
        raise NotImplementedError(
            f"{path} holds no CLIP ViT visual tower; the ResNet encoders "
            f"are {_NOT_PORTED}")
    model.encoder.load_state_dict(visual, strict=True)
    return model
