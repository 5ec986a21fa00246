"""Plain ZUTIS on a CLIP ViT: the forward pass in float32 PyTorch
operations, with no kernel, cache or batching trick of the program.

It follows ZUTIS (Shin et al., "Zero-shot unsupervised transfer instance
segmentation", github.com/NoelShin/zutis, networks/zutis.py) on OpenAI
CLIP's ViT (github.com/openai/CLIP, model.py):

  1. ViT: patchify (a stride-p convolution, no bias), a class token, the
     positional embedding resized bicubically with `F.interpolate`'s
     scale-factor path and CLIP's `+0.1`, ln_pre, pre-LN blocks with
     QuickGELU, the class token dropped, ln_post over the patch tokens;
  2. the token grid upsampled x2 (bilinear, half-pixel centres);
  3. ffn1 (width -> 256 -> 256 -> width, ReLU) on the detached tokens: the
     decoder memory;
  4. DETR's normalised sine embedding over the upsampled grid;
  5. a post-norm query decoder (self-attention, cross-attention into
     memory + pos, ReLU FFN of 2048), every layer's output through one
     shared final norm;
  6. ffn2 on every layer's queries, L2-normalised;
  7. mask proposals = sigmoid(queries . memory);
  8. text-space tokens = tokens @ proj, a LayerNorm over the whole (h, w, c)
     map without parameters, L2-normalised.

Departures from the published code, each the ported system's own: every
LayerNorm with parameters takes eps 1e-6 (flax's default; CLIP's torch
LayerNorm takes 1e-5), and the decoder runs at `n_heads` heads of width /
n_heads.

Parameters are a dict name -> tensor in OpenAI CLIP's and
nn.MultiheadAttention's layout (`param_specs` lists them). `Precision`
rounds the operands of every product that the program computes in a
lower type: the reference leaves them in float32, the control rounds
them (precision.py).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

LN_EPS = 1e-6
FFN_HIDDEN = 256
DECODER_FFN = 2048


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) for every parameter of ZUTIS on a CLIP
    ViT; init is "normal" (scale = std), "ones" or "zeros"."""
    w, p, L = cfg["width"], cfg["patch_size"], cfg["encoder_layers"]
    grid = cfg["input_resolution"] // p
    specs = []

    def dense(name, fan_in, fan_out):
        specs.append((f"{name}.weight", (fan_out, fan_in), "normal",
                      fan_in ** -0.5))
        specs.append((f"{name}.bias", (fan_out,), "zeros", 0.0))

    def norm(name, dim):
        specs.append((f"{name}.weight", (dim,), "ones", 1.0))
        specs.append((f"{name}.bias", (dim,), "zeros", 0.0))

    def mha(name, dim):
        specs.append((f"{name}.in_proj_weight", (3 * dim, dim), "normal",
                      dim ** -0.5))
        specs.append((f"{name}.in_proj_bias", (3 * dim,), "zeros", 0.0))
        dense(f"{name}.out_proj", dim, dim)

    e = "encoder"
    specs.append((f"{e}.conv1.weight", (w, 3, p, p), "normal",
                  (3 * p * p) ** -0.5))
    specs.append((f"{e}.class_embedding", (w,), "normal", w ** -0.5))
    specs.append((f"{e}.positional_embedding", (grid * grid + 1, w), "normal",
                  w ** -0.5))
    norm(f"{e}.ln_pre", w)
    for i in range(L):
        blk = f"{e}.transformer.resblocks.{i}"
        norm(f"{blk}.ln_1", w)
        mha(f"{blk}.attn", w)
        norm(f"{blk}.ln_2", w)
        dense(f"{blk}.mlp.c_fc", w, 4 * w)
        dense(f"{blk}.mlp.c_proj", 4 * w, w)
    norm(f"{e}.ln_post", w)
    specs.append((f"{e}.proj", (w, cfg["text_dim"]), "normal", w ** -0.5))
    for ffn in ("ffn1", "ffn2"):
        dims = [w, FFN_HIDDEN, FFN_HIDDEN, w]
        for i in range(3):
            dense(f"{ffn}.layers.{i}", dims[i], dims[i + 1])
    for i in range(cfg["n_decoder_layers"]):
        lay = f"decoder.layers.{i}"
        mha(f"{lay}.self_attn", w)
        mha(f"{lay}.multihead_attn", w)
        dense(f"{lay}.linear1", w, DECODER_FFN)
        dense(f"{lay}.linear2", DECODER_FFN, w)
        for n in ("norm1", "norm2", "norm3"):
            norm(f"{lay}.{n}", w)
    norm("decoder.norm", w)
    specs.append(("query_embed", (cfg["n_queries"], w), "normal", 1.0))
    return specs


def layer_norm(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], LN_EPS)


def linear(x, P, name, prec: Precision):
    return prec.matmul(x, P[f"{name}.weight"].t()) + P[f"{name}.bias"]


def attention(q_in, k_in, v_in, P, name, heads, prec: Precision):
    """nn.MultiheadAttention's arithmetic: q, k, v projected by the three
    row blocks of in_proj, softmax(q k^T / sqrt(dh)) v per head, out_proj."""
    d = q_in.shape[-1]
    wq, wk, wv = P[f"{name}.in_proj_weight"].split(d)
    bq, bk, bv = P[f"{name}.in_proj_bias"].split(d)
    dh = d // heads

    def proj(x, wgt, bias):
        y = prec.matmul(x, wgt.t()) + bias
        return y.reshape(*y.shape[:2], heads, dh).transpose(1, 2)

    q, k, v = proj(q_in, wq, bq), proj(k_in, wk, bk), proj(v_in, wv, bv)
    logits = prec.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
    weights = torch.softmax(logits, dim=-1)
    out = prec.matmul(weights, v).transpose(1, 2).reshape(*q_in.shape[:2], d)
    return linear(out, P, f"{name}.out_proj", prec)


def resized_pos_embed(pe, h, w):
    """CLIP's positional embedding at an (h, w) grid: F.interpolate's
    bicubic scale-factor path with the `+0.1` of ZUTIS's CLIP code."""
    g = int(math.sqrt(pe.shape[0] - 1))
    grid = pe[1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((h + 0.1) / g, (w + 0.1) / g),
                         mode="bicubic", align_corners=False,
                         recompute_scale_factor=False)
    return torch.cat([pe[:1], grid[0].permute(1, 2, 0).reshape(h * w, -1)])


def encoder(x, P, cfg, prec: Precision):
    """[b, 3, H, W] -> (patch tokens [b, h, w, width] after ln_post)."""
    p, width = cfg["patch_size"], cfg["width"]
    e = "encoder"
    kernel = P[f"{e}.conv1.weight"]
    b, _, H, W = x.shape
    h, w = H // p, W // p
    patches = x[:, :, :h * p, :w * p].reshape(b, 3, h, p, w, p)
    patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(b, h * w, 3 * p * p)
    tokens = prec.matmul(patches, kernel.reshape(width, -1).t())
    cls = P[f"{e}.class_embedding"].expand(b, 1, width)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + resized_pos_embed(P[f"{e}.positional_embedding"], h, w)
    tokens = layer_norm(tokens, P, f"{e}.ln_pre")
    for i in range(cfg["encoder_layers"]):
        blk = f"{e}.transformer.resblocks.{i}"
        y = layer_norm(tokens, P, f"{blk}.ln_1")
        tokens = tokens + attention(y, y, y, P, f"{blk}.attn",
                                    cfg["encoder_heads"], prec)
        y = layer_norm(tokens, P, f"{blk}.ln_2")
        y = linear(y, P, f"{blk}.mlp.c_fc", prec)
        y = y * torch.sigmoid(1.702 * y)
        tokens = tokens + linear(y, P, f"{blk}.mlp.c_proj", prec)
    tokens = layer_norm(tokens[:, 1:], P, f"{e}.ln_post")
    return tokens.reshape(b, h, w, width)


def sine_embedding(h, w, n_feats, device, temperature=10000.0):
    """DETR's PositionEmbeddingSine(normalize=True) over an all-valid
    (h, w) grid -> [h * w, 2 * n_feats], y features first."""
    eps, scale = 1e-6, 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    y = (y / (h + eps) * scale)[:, None].expand(h, w)
    x = (x / (w + eps) * scale)[None, :].expand(h, w)
    dim_t = torch.arange(n_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / n_feats)
    py, px = y[..., None] / dim_t, x[..., None] / dim_t
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], 3).flatten(2)
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], 3).flatten(2)
    return torch.cat([py, px], dim=2).reshape(h * w, 2 * n_feats)


def mlp(x, P, name, prec: Precision):
    for i in range(3):
        x = linear(x, P, f"{name}.layers.{i}", prec)
        if i < 2:
            x = torch.relu(x)
    return x


def decoder(memory, pos, P, cfg, prec: Precision):
    """Post-norm DETR decoder from tgt = 0 -> [L, b, Q, width]."""
    b, width = memory.shape[0], memory.shape[-1]
    heads = cfg["n_heads"]
    query_pos = P["query_embed"].expand(b, -1, -1)
    tgt = torch.zeros_like(query_pos)
    mem_pos = memory + pos
    outs = []
    for i in range(cfg["n_decoder_layers"]):
        lay = f"decoder.layers.{i}"
        q = tgt + query_pos
        tgt = layer_norm(tgt + attention(q, q, tgt, P, f"{lay}.self_attn",
                                         heads, prec), P, f"{lay}.norm1")
        tgt = layer_norm(tgt + attention(tgt + query_pos, mem_pos, memory, P,
                                         f"{lay}.multihead_attn", heads, prec),
                         P, f"{lay}.norm2")
        y = linear(torch.relu(linear(tgt, P, f"{lay}.linear1", prec)), P,
                   f"{lay}.linear2", prec)
        tgt = layer_norm(tgt + y, P, f"{lay}.norm3")
        outs.append(tgt)
    return layer_norm(torch.stack(outs), P, "decoder.norm")


def forward(x, P: Dict[str, torch.Tensor], cfg: dict,
            prec: Precision = Precision(), last_layer_only: bool = False):
    """x [b, 3, H, W] normalised -> {"mask_proposals" [b, L, Q, h, w],
    "patch_tokens" [b, h, w, text_dim]} at the x2 token grid, float32."""
    tokens = encoder(x, P, cfg, prec)  # [b, h, w, width]
    b, h, w, width = tokens.shape
    grid = F.interpolate(tokens.permute(0, 3, 1, 2), scale_factor=2,
                         mode="bilinear", align_corners=False)
    h, w = 2 * h, 2 * w
    tokens = grid.permute(0, 2, 3, 1).reshape(b, h * w, width)
    memory = mlp(tokens.detach(), P, "ffn1", prec)
    pos = sine_embedding(h, w, width // 2, x.device)[None]
    queries = decoder(memory, pos, P, cfg, prec)
    if last_layer_only:
        queries = queries[-1:]
    queries = mlp(queries.permute(1, 0, 2, 3), P, "ffn2", prec)
    queries = queries / queries.norm(dim=-1, keepdim=True).clamp(min=1e-30)
    # the program's operands are of its compute type, the product float32
    logits = torch.einsum("blqc,bsc->blqs", prec.round(queries),
                          prec.round(memory))
    proposals = torch.sigmoid(logits).reshape(b, -1, queries.shape[2], h, w)
    text = prec.matmul(tokens, P["encoder.proj"]).reshape(b, h, w, -1)
    mean = text.mean(dim=(1, 2, 3), keepdim=True)
    var = text.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    text = (text - mean) * torch.rsqrt(var + 1e-5)
    text = text / (text.norm(dim=-1, keepdim=True) + 1e-7)
    return {"mask_proposals": proposals, "patch_tokens": text}
