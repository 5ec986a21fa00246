"""Parameter bridge: a flax ZUTIS parameter tree (nested dicts of numpy
arrays; ViT, RN or DINO encoder), CLIP text-tower tree or SelfMask tree ->
a state_dict in the reference torch layout, and the port's model -> the
JAX package's export layout as numpy (`export_params`); the reference
SelfMask checkpoint -> the port's `SelfMask` (`load_selfmask`, the
counterpart of the JAX package's `convert_selfmask_checkpoint`).

The port's own copy of zutis_tpu/models/weights.py::export_zutis (and the
inverse of its `convert_clip_text`): flax Dense kernels [in, out] are
transposed to Linear weights [out, in], the separate q/k/v projections are
concatenated into nn.MultiheadAttention's `in_proj_weight`/`in_proj_bias`,
HWIO convolution kernels become OIHW, LayerNorm scale/bias become
weight/bias, and FrozenBatchNorm's scale/bias/running_mean/running_var
become BatchNorm's weight/bias and its two buffers. The result loads into
the port's ZUTIS with `strict=True`. The reference layout exists for the
ViT encoder only: RN and DINO models are exported, as the JAX package
exports them, as the raw flax tree under `__flax_raw__/` keys
(`params_to_jax`), so that a `final_model.npz` of either package loads in
the other.
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


def _put_conv(sd, key, d) -> None:
    sd[key] = _t(np.asarray(d["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _put_bn(sd, prefix, d) -> None:
    """A flax FrozenBatchNorm -> BatchNorm's weight, bias and buffers."""
    sd[f"{prefix}.weight"] = _t(d["scale"])
    sd[f"{prefix}.bias"] = _t(d["bias"])
    sd[f"{prefix}.running_mean"] = _t(d["running_mean"])
    sd[f"{prefix}.running_var"] = _t(d["running_var"])


def put_bottleneck(sd, prefix, blk) -> None:
    """A flax `Bottleneck` tree -> `{prefix}.*` of the port's
    `Bottleneck` (prefix "" for a block of its own)."""
    p = f"{prefix}." if prefix else ""
    for i in (1, 2, 3):
        _put_conv(sd, f"{p}conv{i}.weight", blk[f"conv{i}"])
        _put_bn(sd, f"{p}bn{i}", blk[f"bn{i}"])
    if "downsample_conv" in blk:
        _put_conv(sd, f"{p}downsample.0.weight", blk["downsample_conv"])
        _put_bn(sd, f"{p}downsample.1", blk["downsample_bn"])


def rn_visual_params_from_jax(enc: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """A flax `ModifiedResNet` tree -> the port's `ModifiedResNet` state
    dict, OpenAI's RN `visual.*` layout without the prefix (the inverse of
    zutis_tpu/models/weights.py::convert_clip_rn_visual)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        _put_conv(sd, f"conv{i}.weight", enc[f"conv{i}"])
        _put_bn(sd, f"bn{i}", enc[f"bn{i}"])
    for stage in (1, 2, 3, 4):
        j = 0
        while f"layer{stage}_{j}" in enc:
            put_bottleneck(sd, f"layer{stage}.{j}", enc[f"layer{stage}_{j}"])
            j += 1
    pool = enc["attnpool"]
    sd["attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj"):
        _put_dense(sd, f"attnpool.{name}", pool["attn"][name])
    _put_dense(sd, "attnpool.c_proj", pool["attn"]["out_proj"])
    return sd


def _put_deit(sd, prefix, enc) -> None:
    """A flax `DeiTEncoder` tree -> `{prefix}.*` of the port's
    `DeiTEncoder` (SelfMask's and the DINO arm's)."""
    sd[f"{prefix}.patch_embed.proj.weight"] = _t(
        np.asarray(enc["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.patch_embed.proj.bias"] = _t(enc["patch_embed"]["bias"])
    sd[f"{prefix}.cls_token"] = _t(enc["cls_token"])
    sd[f"{prefix}.pos_embed"] = _t(enc["pos_embed"])[None]
    _put_ln(sd, f"{prefix}.norm", enc["norm"])
    i = 0
    while f"blocks_{i}" in enc:
        blk, p = enc[f"blocks_{i}"], f"{prefix}.blocks.{i}"
        _put_ln(sd, f"{p}.norm1", blk["norm1"])
        _put_ln(sd, f"{p}.norm2", blk["norm2"])
        _put_mha(sd, f"{p}.attn", blk["attn"])
        _put_dense(sd, f"{p}.mlp.fc1", blk["fc1"])
        _put_dense(sd, f"{p}.mlp.fc2", blk["fc2"])
        i += 1


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ZUTIS tree of any encoder family (ViT, RN or DINO, told apart
    by the encoder's keys) -> the port's ZUTIS state dict (BatchNorm
    statistics included)."""
    enc = params["encoder"]
    if "patch_embed" in enc:  # the DINO arm's DeiT
        sd: Dict[str, torch.Tensor] = {}
        _put_deit(sd, "encoder", enc)
        for j in range(3):
            _put_dense(sd, f"vision_to_text_ffn.layers.{j}",
                       params["vision_to_text_ffn"][f"layers_{j}"])
    else:
        convert = (visual_params_from_jax if "class_embedding" in enc
                   else rn_visual_params_from_jax)
        sd = {f"encoder.{k}": v for k, v in convert(enc).items()}
    for ffn in ("ffn1", "ffn2"):
        for j in range(3):
            _put_dense(sd, f"{ffn}.layers.{j}", params[ffn][f"layers_{j}"])
    _put_decoder(sd, params["decoder"])
    sd["query_embed"] = _t(params["query_embed"])
    return sd


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32, copy=True).numpy()


def _dense_tree(sd, prefix) -> dict:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T.copy(),
            "bias": _np(sd[f"{prefix}.bias"])}


def _ln_tree(sd, prefix) -> dict:
    return {"LayerNorm_0": {"scale": _np(sd[f"{prefix}.weight"]),
                            "bias": _np(sd[f"{prefix}.bias"])}}


def _mha_tree(sd, prefix) -> dict:
    w, b = _np(sd[f"{prefix}.in_proj_weight"]), _np(sd[f"{prefix}.in_proj_bias"])
    d = w.shape[1]
    tree = {name: {"kernel": w[i * d:(i + 1) * d].T.copy(),
                   "bias": b[i * d:(i + 1) * d].copy()}
            for i, name in enumerate(("q_proj", "k_proj", "v_proj"))}
    tree["out_proj"] = _dense_tree(sd, f"{prefix}.out_proj")
    return tree


def _conv_tree(sd, key) -> dict:
    return {"kernel": _np(sd[key]).transpose(2, 3, 1, 0).copy()}  # OIHW -> HWIO


def _bn_tree(sd, prefix) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"]),
            "running_mean": _np(sd[f"{prefix}.running_mean"]),
            "running_var": _np(sd[f"{prefix}.running_var"])}


def _count(sd, prefix) -> int:
    """How many `{prefix}{i}.` indices the state dict holds."""
    return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})


def params_to_jax(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's ZUTIS state dict (RN or DINO encoder) -> the flax ZUTIS
    tree, float32 numpy, with the JAX package's names and layouts: the
    inverse of `params_from_jax` for those families."""
    enc: Dict[str, Any] = {}
    tree: Dict[str, Any] = {"encoder": enc}
    if "encoder.attnpool.positional_embedding" in sd:
        for i in (1, 2, 3):
            enc[f"conv{i}"] = _conv_tree(sd, f"encoder.conv{i}.weight")
            enc[f"bn{i}"] = _bn_tree(sd, f"encoder.bn{i}")
        for stage in (1, 2, 3, 4):
            for j in range(_count(sd, f"encoder.layer{stage}.")):
                p, blk = f"encoder.layer{stage}.{j}", {}
                for i in (1, 2, 3):
                    blk[f"conv{i}"] = _conv_tree(sd, f"{p}.conv{i}.weight")
                    blk[f"bn{i}"] = _bn_tree(sd, f"{p}.bn{i}")
                if f"{p}.downsample.0.weight" in sd:
                    blk["downsample_conv"] = _conv_tree(
                        sd, f"{p}.downsample.0.weight")
                    blk["downsample_bn"] = _bn_tree(sd, f"{p}.downsample.1")
                enc[f"layer{stage}_{j}"] = blk
        attn = {name: _dense_tree(sd, f"encoder.attnpool.{name}")
                for name in ("q_proj", "k_proj", "v_proj")}
        attn["out_proj"] = _dense_tree(sd, "encoder.attnpool.c_proj")
        enc["attnpool"] = {"positional_embedding": _np(
            sd["encoder.attnpool.positional_embedding"]), "attn": attn}
    elif "encoder.patch_embed.proj.weight" in sd:
        enc["patch_embed"] = _conv_tree(sd, "encoder.patch_embed.proj.weight")
        enc["patch_embed"]["bias"] = _np(sd["encoder.patch_embed.proj.bias"])
        enc["cls_token"] = _np(sd["encoder.cls_token"])
        enc["pos_embed"] = _np(sd["encoder.pos_embed"])[0].copy()
        enc["norm"] = _ln_tree(sd, "encoder.norm")
        for i in range(_count(sd, "encoder.blocks.")):
            p = f"encoder.blocks.{i}"
            enc[f"blocks_{i}"] = {
                "norm1": _ln_tree(sd, f"{p}.norm1"),
                "norm2": _ln_tree(sd, f"{p}.norm2"),
                "attn": _mha_tree(sd, f"{p}.attn"),
                "fc1": _dense_tree(sd, f"{p}.mlp.fc1"),
                "fc2": _dense_tree(sd, f"{p}.mlp.fc2")}
        tree["vision_to_text_ffn"] = {
            f"layers_{j}": _dense_tree(sd, f"vision_to_text_ffn.layers.{j}")
            for j in range(3)}
    else:
        raise ValueError("params_to_jax takes the RN and DINO encoder "
                         "families; a ViT model exports in the reference "
                         "layout")
    for ffn in ("ffn1", "ffn2"):
        tree[ffn] = {f"layers_{j}": _dense_tree(sd, f"{ffn}.layers.{j}")
                     for j in range(3)}
    dec = {"norm": _ln_tree(sd, "decoder.norm")}
    for i in range(_count(sd, "decoder.layers.")):
        p = f"decoder.layers.{i}"
        dec[f"layers_{i}"] = {
            "self_attn": _mha_tree(sd, f"{p}.self_attn"),
            "cross_attn": _mha_tree(sd, f"{p}.multihead_attn"),
            "linear1": _dense_tree(sd, f"{p}.linear1"),
            "linear2": _dense_tree(sd, f"{p}.linear2"),
            "norm1": _ln_tree(sd, f"{p}.norm1"),
            "norm2": _ln_tree(sd, f"{p}.norm2"),
            "norm3": _ln_tree(sd, f"{p}.norm3")}
    tree["decoder"] = dec
    tree["query_embed"] = _np(sd["query_embed"])
    return tree


FLAX_RAW_PREFIX = "__flax_raw__/"  # the JAX export of RN and DINO models


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested tree -> {"a/b/c": leaf} (zutis_tpu/models/weights.py's
    `_flatten_tree`)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> dict:
    """The inverse of `flatten_tree`."""
    tree: dict = {}
    for key, v in flat.items():
        *parts, leaf = key.split("/")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


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
    sd: Dict[str, torch.Tensor] = {}
    _put_deit(sd, "encoder", params["encoder"])
    sd["query_embed"] = _t(params["query_embed"])
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
    """Load a flax ZUTIS parameter tree (any encoder family) into the
    port's ZUTIS (strict)."""
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


def export_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The port's ZUTIS (or `CLIPTextEncoder`) -> float32 numpy arrays on
    the host with the keys of the JAX package's `export_zutis`: what
    `Trainer` writes to `latest_model.npz`, `best_model.npz` and
    `final_model.npz`. A ViT model's (and the text tower's) state dict
    already carries the reference's names and layouts; an RN or DINO
    model's is written as the raw flax tree under `__flax_raw__/`, as the
    JAX package writes it."""
    sd = model.state_dict()
    if getattr(model, "encoder_family", "vit") != "vit":
        return flatten_tree(params_to_jax(sd), FLAX_RAW_PREFIX)
    return {k: _np(v) for k, v in sd.items()}
