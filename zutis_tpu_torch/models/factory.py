"""Model factory: clip_arch string -> the port's ZUTIS and CLIP text tower,
and the OpenAI CLIP and official DINO weights into them (the port of
zutis_tpu/models/factory.py's `_VIT_SPECS`, `_RN_SPECS`, `_TEXT_SPECS`,
`normalize_clip_arch`, `clip_spec`, `build_zutis`, `build_text_encoder`,
`clip_checkpoint_path`, `find_merges_file` and of `load_clip_params`, whose
visual half is `load_clip_visual` and text half `load_clip_text`;
`load_dino_encoder` is the counterpart of
zutis_tpu/models/weights.py::convert_dino_encoder).

CLIP checkpoints are the official OpenAI .pt files in a local assets
directory (no network at run time): <assets>/ViT-B-16.pt, ViT-B-32.pt,
ViT-L-14.pt, ViT-L-14-336px.pt, RN50.pt, RN101.pt, RN50x4.pt, RN50x16.pt,
RN50x64.pt, and the BPE merges file <assets>/bpe_simple_vocab_16e6.txt(.gz).

Every arch the JAX package builds is built here: the CLIP ViTs, the
ModifiedResNets (RN50 ... RN50x64; `dilatedRN*` is the same net without the
x2 token upsample) and `encoder_type="dino"` (DINO ViT-B/16 bridged into
the arch's text dim). On a card every arch runs the flash kernels at its
decoder's head dim (its width over 8 heads: 128 for ViT-L/14, 256 for RN50
and RN101, 320, 384 and 512 for RN50x4, RN50x16 and RN50x64; the DINO arm's
64, 96, 128 or 80 at its text dim), in bf16 and in f32.
`build_zutis` passes the opt-in levers `tome_r` (ViT only) and
`decoder_pool` on to ZUTIS.
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

_RN_SPECS = {
    # stage blocks, stem width, embed_dim (width*32), output_dim, input_res
    # (reference networks/clip_arch.py:590-627 derives these from the
    # checkpoint; utils/utils.py:165 lists the supported arch names)
    "RN50": ((3, 4, 6, 3), 64, 2048, 1024, 224),
    "RN101": ((3, 4, 23, 3), 64, 2048, 512, 224),
    "RN50x4": ((4, 6, 10, 6), 80, 2560, 640, 288),
    "RN50x16": ((6, 8, 18, 8), 96, 3072, 768, 384),
    "RN50x64": ((3, 15, 36, 10), 128, 4096, 1024, 448),
}

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

# the DINO arm's encoder: ViT-B/16 (DINO's own ViT-B/16 checkpoint)
_DINO_SPEC = dict(dino_embed_dim=768, dino_depth=12, dino_heads=12,
                  patch_size=16, input_resolution=224)


def normalize_clip_arch(clip_arch: str) -> tuple:
    """-> (base_arch, upsample_tokens). 'dilatedRN50' is RN50 with the x2
    token upsample disabled — the reference's `lstrip("dilated")` plus the
    condition at networks/zutis.py:488-497; there is no actual dilation."""
    if clip_arch.startswith("dilated"):
        base = clip_arch[len("dilated"):]
        assert base in _RN_SPECS, f"unsupported clip_arch {clip_arch!r}"
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
    assert clip_arch in _VIT_SPECS, (
        f"unsupported ViT clip_arch {clip_arch!r}; ViT variants: "
        f"{sorted(_VIT_SPECS)}; RN variants: {sorted(_RN_SPECS)}"
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
    """The port's ZUTIS for a CLIP arch (a ViT, an RN or a `dilatedRN*`)
    or, with encoder_type "dino", the DINO ViT-B/16 arm in that arch's text
    dim; uninitialised parameters on `device` (call `init_params` or load
    weights)."""
    return ZUTIS(**zutis_config(clip_arch, encoder_type), n_queries=n_queries,
                 n_decoder_layers=n_decoder_layers, n_heads=n_heads,
                 stop_gradient=stop_gradient, dtype=dtype,
                 attn_impl=attn_impl, tome_r=tome_r,
                 decoder_pool=decoder_pool, device=device)


def zutis_config(clip_arch: str, encoder_type: str = "clip") -> dict:
    """The encoder geometry `build_zutis` gives ZUTIS for an arch: widths,
    family, resolution and the upsample flag."""
    base_arch, upsample = normalize_clip_arch(clip_arch)
    if encoder_type not in ("clip", "dino"):
        raise ValueError(f"unknown encoder_type {encoder_type!r}")
    if encoder_type == "dino":
        text_dim = (_VIT_SPECS[base_arch][4] if base_arch in _VIT_SPECS
                    else _RN_SPECS[base_arch][3])
        return dict(encoder_family="dino", width=text_dim, text_dim=text_dim,
                    upsample_tokens=upsample, **_DINO_SPEC)
    if base_arch in _RN_SPECS:
        layers, rn_width, embed, out_dim, res = _RN_SPECS[base_arch]
        return dict(encoder_family="rn", width=embed, text_dim=out_dim,
                    input_resolution=res, rn_layers=layers,
                    rn_width=rn_width, upsample_tokens=upsample)
    s = clip_spec(base_arch)
    return dict(width=s.width, encoder_layers=s.layers,
                encoder_heads=s.heads, patch_size=s.patch,
                text_dim=s.embed_dim, input_resolution=s.input_resolution,
                upsample_tokens=upsample)


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
    """Load the CLIP visual tower of the OpenAI checkpoint at `path` (its
    `visual.*` tensors) into `model.encoder`, strictly: every encoder
    parameter and BatchNorm statistic must come from the file. A ViT tower
    goes into a ViT ZUTIS and a ModifiedResNet one into an RN ZUTIS (the
    `num_batches_tracked` counts torch's BatchNorm writes into OpenAI's RN
    archives are dropped: the frozen BatchNorm keeps none). Returns
    `model`."""
    sd = load_torch_state_dict(path)
    visual = {k[len("visual."):]: v for k, v in sd.items()
              if k.startswith("visual.")
              and not k.endswith(".num_batches_tracked")}
    family = ("vit" if "class_embedding" in visual
              else "rn" if "attnpool.positional_embedding" in visual else None)
    if family is None:
        raise ValueError(f"{path} holds no CLIP ViT or ResNet visual tower")
    if family != model.encoder_family:
        raise ValueError(f"{path} holds a CLIP {family} visual tower; the "
                         f"model's encoder family is {model.encoder_family}")
    model.encoder.load_state_dict(visual, strict=True)
    return model


def load_dino_encoder(model: ZUTIS, path: str) -> ZUTIS:
    """Load an official DINO ViT checkpoint (`patch_embed.proj.*`,
    `cls_token`, `pos_embed`, `blocks.N.*` with the fused `attn.qkv`,
    `norm.*`; the head's keys, if any, are not read) into a DINO ZUTIS's
    `encoder`, strictly; each block's `attn.qkv` [3d, d] is the port's
    `attn.in_proj_*` in the same q, k, v order and `attn.proj` its
    `attn.out_proj` (models/weights.py::selfmask_state_dict). The
    counterpart of zutis_tpu/models/weights.py::convert_dino_encoder.
    Returns `model`."""
    from zutis_tpu_torch.models.weights import selfmask_state_dict

    if model.encoder_family != "dino":
        raise ValueError("load_dino_encoder loads a DINO ZUTIS's encoder; "
                         f"the model's family is {model.encoder_family}")
    sd = selfmask_state_dict(load_torch_state_dict(path))
    wanted = model.encoder.state_dict()
    # what the JAX converter reads, and nothing else; a missing key raises
    model.encoder.load_state_dict({k: v for k, v in sd.items()
                                   if k in wanted}, strict=True)
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
