"""2-D sine positional embedding (DETR-style).

Matches the reference `PositionEmbeddingSine` with `normalize=True` and no
padding mask (reference networks/positional_embedding.py:12-52): row/column
coordinates are 1-indexed cumsums of ones, normalised by the last coordinate
plus eps, scaled by 2*pi, and expanded with interleaved sin/cos over
`num_pos_feats` frequencies; y-features come before x-features on the channel
axis. Since the mask is always all-valid, the cumsum collapses to arange,
computed directly here in numpy (a copy of zutis_tpu/models/pos_embed.py;
the port imports nothing from the JAX package)."""
from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=64)
def sine_pos_embed(
    h: int,
    w: int,
    num_pos_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
) -> np.ndarray:
    """Returns [2*num_pos_feats, h, w] float32 (numpy)."""
    eps = 1e-6
    scale = 2 * math.pi
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    if normalize:
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_y = y[:, :, None] / dim_t  # h x w x npf
    pos_x = x[:, :, None] / dim_t
    # interleave sin on even channels, cos on odd channels
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], axis=3
                     ).reshape(h, w, -1)
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], axis=3
                     ).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2)  # h x w x 2*npf
    return np.ascontiguousarray(pos.transpose(2, 0, 1))
