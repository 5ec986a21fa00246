"""Parameter bridge: a flax ZUTIS parameter tree (nested dicts of numpy
arrays, ViT encoder) -> a state_dict in the reference torch layout, and the
port's model -> that layout as numpy (`export_params`).

The port's own copy of the ViT branch of
zutis_tpu/models/weights.py::export_zutis: flax Dense kernels [in, out] are
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


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    enc = params["encoder"]
    if "class_embedding" not in enc:
        raise ValueError("params_from_jax takes the CLIP ViT encoder family only")
    sd: Dict[str, torch.Tensor] = {}

    def put_dense(prefix, d):
        sd[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(d["bias"])

    def put_ln(prefix, d):
        sd[f"{prefix}.weight"] = _t(d["LayerNorm_0"]["scale"])
        sd[f"{prefix}.bias"] = _t(d["LayerNorm_0"]["bias"])

    def put_mha(prefix, d):
        names = ("q_proj", "k_proj", "v_proj")
        sd[f"{prefix}.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(d[n]["kernel"]).T for n in names], 0))
        sd[f"{prefix}.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(d[n]["bias"]) for n in names], 0))
        put_dense(f"{prefix}.out_proj", d["out_proj"])

    sd["encoder.conv1.weight"] = _t(
        np.asarray(enc["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    sd["encoder.class_embedding"] = _t(enc["class_embedding"])
    sd["encoder.positional_embedding"] = _t(enc["positional_embedding"])
    sd["encoder.proj"] = _t(enc["proj"])
    put_ln("encoder.ln_pre", enc["ln_pre"])
    put_ln("encoder.ln_post", enc["ln_post"])
    i = 0
    while f"resblocks_{i}" in enc:
        rb = enc[f"resblocks_{i}"]
        p = f"encoder.transformer.resblocks.{i}"
        put_ln(f"{p}.ln_1", rb["ln_1"])
        put_ln(f"{p}.ln_2", rb["ln_2"])
        put_mha(f"{p}.attn", rb["attn"])
        put_dense(f"{p}.mlp.c_fc", rb["mlp_c_fc"])
        put_dense(f"{p}.mlp.c_proj", rb["mlp_c_proj"])
        i += 1
    for ffn in ("ffn1", "ffn2"):
        for j in range(3):
            put_dense(f"{ffn}.layers.{j}", params[ffn][f"layers_{j}"])
    dec = params["decoder"]
    put_ln("decoder.norm", dec["norm"])
    i = 0
    while f"layers_{i}" in dec:
        dl = dec[f"layers_{i}"]
        p = f"decoder.layers.{i}"
        put_mha(f"{p}.self_attn", dl["self_attn"])
        put_mha(f"{p}.multihead_attn", dl["cross_attn"])
        put_dense(f"{p}.linear1", dl["linear1"])
        put_dense(f"{p}.linear2", dl["linear2"])
        put_ln(f"{p}.norm1", dl["norm1"])
        put_ln(f"{p}.norm2", dl["norm2"])
        put_ln(f"{p}.norm3", dl["norm3"])
        i += 1
    sd["query_embed"] = _t(params["query_embed"])
    return sd


def load_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load a flax ZUTIS parameter tree into the port's ZUTIS (strict)."""
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


def export_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The port's ZUTIS -> its reference-layout state dict as float32 numpy
    arrays on the host (the counterpart of the JAX package's
    `export_zutis`, with the same keys): what `Trainer` writes to
    `latest_model.npz`, `best_model.npz` and `final_model.npz`. The port's
    modules already carry the reference's names and layouts."""
    return {k: v.detach().to("cpu", torch.float32, copy=True).numpy()
            for k, v in model.state_dict().items()}
