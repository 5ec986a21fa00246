"""Model factory: clip_arch string -> the port's ZUTIS and CLIP text tower,
and the OpenAI CLIP weights into them (the port of
zutis_tpu/models/factory.py's `_VIT_SPECS`, `_TEXT_SPECS`,
`normalize_clip_arch`, `clip_spec`, `build_zutis`, `build_text_encoder`,
`clip_checkpoint_path`, `find_merges_file` and of `load_clip_params`, whose
visual half is `load_clip_visual` and text half `load_clip_text`).

CLIP checkpoints are the official OpenAI .pt files in a local assets
directory (no network at run time): <assets>/ViT-B-16.pt, ViT-B-32.pt,
ViT-L-14.pt, ViT-L-14-336px.pt, and the BPE merges file
<assets>/bpe_simple_vocab_16e6.txt(.gz).

Not ported yet (each raises NotImplementedError, ROADMAP.md, queue 1,
item 7): the ResNet visual encoders (RN50 ... RN50x64) and their `dilated`
variants, and `encoder_type="dino"`; the text towers of every arch are
here. `build_zutis` passes the opt-in levers `tome_r` and `decoder_pool`
on to ZUTIS.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from zutis_tpu_torch.models.text import CLIPTextEncoder
from zutis_tpu_torch.models.zutis import ZUTIS

_VIT_SPECS = {
    # width, layers, heads, patch, embed_dim, input_resolution
    "ViT-B/32": (768, 12, 12, 32, 512, 224),
    "ViT-B/16": (768, 12, 12, 16, 512, 224),
    "ViT-L/14": (1024, 24, 16, 14, 768, 224),
    "ViT-L/14@336px": (1024, 24, 16, 14, 768, 336),
}

# the RN archs the JAX package builds (reference utils/utils.py:165); the
# port builds their text towers and refuses their visual encoders
_RN_ARCHS = ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64")

_TEXT_SPECS = {
    # width, layers, heads, embed_dim
    "ViT-B/32": (512, 12, 8, 512),
    "ViT-B/16": (512, 12, 8, 512),
    "ViT-L/14": (768, 12, 12, 768),
    "ViT-L/14@336px": (768, 12, 12, 768),
    "RN50": (512, 12, 8, 1024),
    "RN101": (512, 12, 8, 512),
    "RN50x4": (640, 12, 10, 640),
    "RN50x16": (768, 12, 12, 768),
    "RN50x64": (1024, 12, 16, 1024),
}

# the OpenAI checkpoint's text-tower keys, by prefix
_TEXT_KEYS = ("token_embedding.", "positional_embedding", "transformer.",
              "ln_final.", "text_projection")

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
        stop_gradient=stop_gradient,
        dtype=dtype,
        attn_impl=attn_impl,
        tome_r=tome_r,
        decoder_pool=decoder_pool,
        device=device,
    )


def build_text_encoder(clip_arch: str, dtype: torch.dtype = torch.float32,
                       device="cuda") -> CLIPTextEncoder:
    """The arch's CLIP text tower, with uninitialised parameters on
    `device`. "dilatedRN50" etc. share the base arch's tower (the prefix
    only disables the visual token upsample, `normalize_clip_arch`)."""
    base_arch, _ = normalize_clip_arch(clip_arch)
    width, layers, heads, embed_dim = _TEXT_SPECS[base_arch]
    return CLIPTextEncoder(width=width, layers=layers, heads=heads,
                           embed_dim=embed_dim, dtype=dtype, device=device)


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


def load_clip_text(path: str) -> Dict[str, torch.Tensor]:
    """The text tower of the OpenAI checkpoint at `path` (its
    `token_embedding.*`, `positional_embedding`, `transformer.*`,
    `ln_final.*` and `text_projection`) as a state dict that loads into
    `build_text_encoder`'s tower with `strict=True`."""
    sd = load_torch_state_dict(path)
    text = {k: v for k, v in sd.items() if k.startswith(_TEXT_KEYS)}
    if "token_embedding.weight" not in text:
        raise ValueError(f"{path} holds no CLIP text tower")
    return text


def find_merges_file(assets_dir: str) -> Optional[str]:
    for name in ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt"):
        p = os.path.join(assets_dir, name)
        if os.path.exists(p):
            return p
    return None
