"""Parameter bridge: a flax ZUTIS parameter tree (nested dicts of numpy
arrays, ViT encoder), CLIP text-tower tree or SelfMask tree -> a state_dict
in the reference torch layout, and the port's model -> that layout as numpy
(`export_params`); the reference SelfMask checkpoint -> the port's
`SelfMask` (`load_selfmask`, the counterpart of the JAX package's
`convert_selfmask_checkpoint`).

The port's own copy of the ViT branch of
zutis_tpu/models/weights.py::export_zutis (and the inverse of its
`convert_clip_text`): flax Dense kernels [in, out] are
transposed to Linear weights [out, in], the separate q/k/v projections are
concatenated into nn.MultiheadAttention's `in_proj_weight`/`in_proj_bias`,
the HWIO patchify kernel becomes OIHW, and LayerNorm scale/bias become
weight/bias. The result loads into the port's ZUTIS with `strict=True`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable copy


def _put_dense(sd, prefix, d) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(d["bias"])


def _put_ln(sd, prefix, d) -> None:
    sd[f"{prefix}.weight"] = _t(d["LayerNorm_0"]["scale"])
    sd[f"{prefix}.bias"] = _t(d["LayerNorm_0"]["bias"])


def _put_mha(sd, prefix, d) -> None:
    names = ("q_proj", "k_proj", "v_proj")
    sd[f"{prefix}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(d[n]["kernel"]).T for n in names], 0))
    sd[f"{prefix}.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(d[n]["bias"]) for n in names], 0))
    _put_dense(sd, f"{prefix}.out_proj", d["out_proj"])


def _put_resblocks(sd, prefix, tree) -> None:
    """Every `resblocks_{i}` of a flax tower -> `{prefix}.{i}.*`."""
    i = 0
    while f"resblocks_{i}" in tree:
        rb = tree[f"resblocks_{i}"]
        p = f"{prefix}.{i}"
        _put_ln(sd, f"{p}.ln_1", rb["ln_1"])
        _put_ln(sd, f"{p}.ln_2", rb["ln_2"])
        _put_mha(sd, f"{p}.attn", rb["attn"])
        _put_dense(sd, f"{p}.mlp.c_fc", rb["mlp_c_fc"])
        _put_dense(sd, f"{p}.mlp.c_proj", rb["mlp_c_proj"])
        i += 1


def visual_params_from_jax(enc: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax `CLIPViT` tree -> the port's `CLIPViT` state dict, which is
    OpenAI's `visual.*` layout without the prefix."""
    if "class_embedding" not in enc:
        raise ValueError("a CLIP ViT encoder tree only (no class_embedding)")
    sd: Dict[str, torch.Tensor] = {}
    sd["conv1.weight"] = _t(
        np.asarray(enc["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    sd["class_embedding"] = _t(enc["class_embedding"])
    sd["positional_embedding"] = _t(enc["positional_embedding"])
    sd["proj"] = _t(enc["proj"])
    _put_ln(sd, "ln_pre", enc["ln_pre"])
    _put_ln(sd, "ln_post", enc["ln_post"])
    _put_resblocks(sd, "transformer.resblocks", enc)
    return sd


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if "class_embedding" not in params["encoder"]:
        raise ValueError("params_from_jax takes the CLIP ViT encoder family only")
    sd = {f"encoder.{k}": v
          for k, v in visual_params_from_jax(params["encoder"]).items()}
    for ffn in ("ffn1", "ffn2"):
        for j in range(3):
            _put_dense(sd, f"{ffn}.layers.{j}", params[ffn][f"layers_{j}"])
    _put_decoder(sd, params["decoder"])
    sd["query_embed"] = _t(params["query_embed"])
    return sd


def _put_decoder(sd, dec) -> None:
    """A flax `QueryDecoder` tree -> `decoder.*`."""
    _put_ln(sd, "decoder.norm", dec["norm"])
    i = 0
    while f"layers_{i}" in dec:
        dl = dec[f"layers_{i}"]
        p = f"decoder.layers.{i}"
        _put_mha(sd, f"{p}.self_attn", dl["self_attn"])
        _put_mha(sd, f"{p}.multihead_attn", dl["cross_attn"])
        _put_dense(sd, f"{p}.linear1", dl["linear1"])
        _put_dense(sd, f"{p}.linear2", dl["linear2"])
        _put_ln(sd, f"{p}.norm1", dl["norm1"])
        _put_ln(sd, f"{p}.norm2", dl["norm2"])
        _put_ln(sd, f"{p}.norm3", dl["norm3"])
        i += 1


def text_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax `CLIPTextEncoder` tree -> the port's `CLIPTextEncoder` state
    dict, which is OpenAI's text-tower layout (the inverse of
    zutis_tpu/models/weights.py::convert_clip_text)."""
    sd: Dict[str, torch.Tensor] = {
        "token_embedding.weight": _t(params["token_embedding"]["embedding"]),
        "positional_embedding": _t(params["positional_embedding"]),
        "text_projection": _t(params["text_projection"]),
    }
    _put_ln(sd, "ln_final", params["ln_final"])
    _put_resblocks(sd, "transformer.resblocks", params)
    return sd


def selfmask_params_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """A flax `SelfMask` tree -> the port's `SelfMask` state dict."""
    enc = params["encoder"]
    sd: Dict[str, torch.Tensor] = {
        "encoder.patch_embed.proj.weight": _t(
            np.asarray(enc["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
        "encoder.patch_embed.proj.bias": _t(enc["patch_embed"]["bias"]),
        "encoder.cls_token": _t(enc["cls_token"]),
        "encoder.pos_embed": _t(enc["pos_embed"])[None],
        "query_embed": _t(params["query_embed"]),
    }
    _put_ln(sd, "encoder.norm", enc["norm"])
    i = 0
    while f"blocks_{i}" in enc:
        blk, p = enc[f"blocks_{i}"], f"encoder.blocks.{i}"
        _put_ln(sd, f"{p}.norm1", blk["norm1"])
        _put_ln(sd, f"{p}.norm2", blk["norm2"])
        _put_mha(sd, f"{p}.attn", blk["attn"])
        _put_dense(sd, f"{p}.mlp.fc1", blk["fc1"])
        _put_dense(sd, f"{p}.mlp.fc2", blk["fc2"])
        i += 1
    _put_decoder(sd, params["decoder"])
    for j in range(3):
        _put_dense(sd, f"ffn.layers.{j}", params["ffn"][f"layers_{j}"])
    return sd


def selfmask_state_dict(ref: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The reference checkpoint's state dict (selfmask_nq20.pt's layout,
    what zutis_tpu/models/selfmask.py::convert_selfmask_checkpoint reads)
    -> the port's names, in float32. Only the fused attention's names
    differ: each block's `attn.qkv` [3d, d] (q, k, v) is `attn.in_proj_*`
    and `attn.proj` is `attn.out_proj`."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in ref.items():
        key = (key.replace(".attn.qkv.", ".attn.in_proj_")
               .replace(".attn.proj.", ".attn.out_proj."))
        sd[key] = value.detach().to("cpu", torch.float32)
    return sd


def selfmask_reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port's `SelfMask` -> the reference checkpoint's layout on the
    host (what `load_selfmask` reads; the inverse of
    `selfmask_state_dict`)."""
    return {(k.replace(".attn.in_proj_", ".attn.qkv.")
             .replace(".attn.out_proj.", ".attn.proj.")): v.detach().cpu()
            for k, v in model.state_dict().items()}


def load_selfmask(path: str, device="cuda", **kwargs) -> nn.Module:
    """A `SelfMask` on `device` with the weights of a reference-layout
    checkpoint (`<clip_assets_dir>/selfmask_nq20.pt`), loaded strictly. The
    architecture is read off the weights' shapes (DeiT-S/8 with 20 queries
    and 6 decoder layers for the reference's); the heads are DeiT's, one
    per 64 channels unless `kwargs` name them; `kwargs` go to `SelfMask`
    (heads, dtype, attn_impl)."""
    from zutis_tpu_torch.core.checkpoint import load_params_any
    from zutis_tpu_torch.models.selfmask import SelfMask

    # read with weights_only=True, "state_dict" unwrapped
    sd = selfmask_state_dict(load_params_any(path))

    def count(prefix):
        return len({k[len(prefix):].split(".")[0] for k in sd
                    if k.startswith(prefix)})

    dim = sd["encoder.cls_token"].shape[-1]
    arch = dict(
        n_queries=sd["query_embed"].shape[0],
        patch_size=sd["encoder.patch_embed.proj.weight"].shape[-1],
        n_decoder_layers=count("decoder.layers."), embed_dim=dim,
        heads=max(1, dim // 64),
        base_grid=round((sd["encoder.pos_embed"].shape[1] - 1) ** 0.5),
        depth=count("encoder.blocks."))
    model = SelfMask(**{**arch, **kwargs}, device=device)
    # what the JAX converter reads, and nothing else; a missing key raises
    wanted = model.state_dict()
    model.load_state_dict({k: v for k, v in sd.items() if k in wanted},
                          strict=True)
    return model


def load_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load a flax ZUTIS parameter tree into the port's ZUTIS (strict)."""
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


def export_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The port's ZUTIS (or `CLIPTextEncoder`) -> its reference-layout state
    dict as float32 numpy arrays on the host (the counterpart of the JAX
    package's `export_zutis`, with the same keys): what `Trainer` writes to
    `latest_model.npz`, `best_model.npz` and `final_model.npz`. The port's
    modules already carry the reference's names and layouts; the text
    tower's are OpenAI's."""
    return {k: v.detach().to("cpu", torch.float32, copy=True).numpy()
            for k, v in model.state_dict().items()}
