"""The work of each operation, counted from the cell's shapes, and the
peaks it is held against (one NVIDIA H100 SXM, NVIDIA's data sheet, dense,
at its 700 W limit; the card's own limit is printed beside every share).

A count is that of the operation, whatever kernel computes it: products
are counted as 2 m n k, a bilinear resize as two taps an axis, attention
as its two products over the valid keys; padding a kernel computes is
waste, not work. A bound is the least time the card could take: the
larger of the operations over the peak and the bytes over the memory
rate, each input byte read once and each output byte written once.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

BF16_FLOPS = 989e12  # dense bfloat16 on the tensor cores
INT8_OPS = 1979e12   # dense int8 on the tensor cores
HBM_BYTES = 3.35e12  # bytes a second

FFN_HIDDEN = 256
DECODER_FFN = 2048


def attention_bound_s(b: int, h: int, sq: int, sk: int, d: int,
                      dtype_bytes: int = 2) -> float:
    """softmax(q k^T) v over [b, h, sq, sk, d]: q, k, v and o once against
    4 b h sq sk d operations at the bf16 peak."""
    io = (2 * sq + 2 * sk) * b * h * d * dtype_bytes
    return max(io / HBM_BYTES, 4.0 * b * h * sq * sk * d / BF16_FLOPS)


def iou_bound_s(b: int, q: int, k: int) -> float:
    """NMS's pairwise intersections of [b, q, k] byte masks: the masks
    read once, the IoU and the areas written once, against 2 b q^2 k int8
    operations."""
    io = b * q * k + 4 * b * q * q + 4 * b * q
    return max(io / HBM_BYTES, 2.0 * b * q * q * k / INT8_OPS)


def _dense(tokens: int, dims: Iterable[int]) -> float:
    dims = list(dims)
    return sum(2.0 * tokens * a * c for a, c in zip(dims, dims[1:]))


def forward_flops(cfg: dict, b: int, grid: Tuple[int, int],
                  decoder_layers_out: int) -> Dict[str, float]:
    """Products of one ZUTIS forward over b images of (h, w) patches:
    {"encoder", "decoder", "heads"} FLOPs. `decoder_layers_out` is the
    decoder layers whose queries reach ffn2 and the proposals (all of them
    in training, the last at inference)."""
    h, w = grid
    d, p, L = cfg["width"], cfg["patch_size"], cfg["encoder_layers"]
    n = h * w + 1
    s = 4 * h * w  # the x2 grid
    enc = 2.0 * b * h * w * 3 * p * p * d
    enc += L * (24.0 * b * n * d * d + 4.0 * b * n * n * d)
    Q, Ld = cfg["n_queries"], cfg["n_decoder_layers"]
    dec = Ld * b * (
        8.0 * Q * d * d + 4.0 * Q * Q * d            # self: q k v o, qk, pv
        + 4.0 * Q * d * d + 4.0 * s * d * d + 4.0 * Q * s * d  # cross
        + 4.0 * Q * d * DECODER_FFN)
    heads = b * _dense(s, (d, FFN_HIDDEN, FFN_HIDDEN, d))        # ffn1
    heads += b * _dense(decoder_layers_out * Q, (d, FFN_HIDDEN, FFN_HIDDEN, d))
    heads += 2.0 * b * decoder_layers_out * Q * s * d             # proposals
    heads += 2.0 * b * s * d * cfg["text_dim"]                    # proj
    heads += 4.0 * b * (h * 2 * w + s) * d                        # upsample
    return {"encoder": enc, "decoder": dec, "heads": heads}


def train_step_flops(cfg: dict, b: int, image: int, n_categories: int,
                     n_max: int) -> Dict[str, float]:
    """One training step at b square images of `image` pixels: the
    forward's products three times over (the backward takes two products
    for each forward one), but once for the patch embedding and ffn1's
    first layer, whose inputs take no gradient; and the criterion's: the
    text logits at label size and the tokens' resize to it, each forward
    and one backward product (the text embeddings take no gradient), and
    each decoder layer's proposal resize, dice at the feature grid and BCE
    at label size, likewise."""
    g = image // cfg["patch_size"]
    fwd = forward_flops(cfg, b, (g, g), cfg["n_decoder_layers"])
    d, p, s = cfg["width"], cfg["patch_size"], 4 * g * g
    once = 2.0 * b * g * g * 3 * p * p * d + 2.0 * b * s * d * FFN_HIDDEN
    model = 3.0 * sum(fwd.values()) - 2.0 * once
    hw, c, hf = image * image, cfg["text_dim"], 2 * g
    ce = 2.0 * (2.0 * b * hw * c * n_categories
                + 4.0 * b * c * (image * hf + hw))
    L, Q = cfg["n_decoder_layers"], cfg["n_queries"]
    mask = 2.0 * L * b * (4.0 * Q * (image * hf + hw)
                          + 2.0 * n_max * Q * hf * hf
                          + 2.0 * n_max * Q * hw)
    return {"model": model, "criterion": ce + mask}


def forward_attention_bound_s(cfg: dict, b: int, grid: Tuple[int, int]
                              ) -> float:
    """The bound of one forward's attention calls over b images of (h, w)
    patches: the encoder's self-attention, the decoder's self- and
    cross-attention, in bfloat16."""
    h, w = grid
    d, heads, L = cfg["width"], cfg["encoder_heads"], cfg["encoder_layers"]
    n, s = h * w + 1, 4 * h * w
    Q, dh = cfg["n_queries"], cfg["width"] // cfg["n_heads"]
    Ld, hd = cfg["n_decoder_layers"], cfg["n_heads"]
    return (L * attention_bound_s(b, heads, n, n, d // heads)
            + Ld * attention_bound_s(b, hd, Q, Q, dh)
            + Ld * attention_bound_s(b, hd, Q, s, dh))
