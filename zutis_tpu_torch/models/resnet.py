"""CLIP ModifiedResNet visual encoder (RN50 family) returning dense tokens
(the port of zutis_tpu/models/resnet.py).

  - a 3-convolution stem (3 -> width/2 at stride 2 -> width/2 -> width),
    each with a frozen BatchNorm and ReLU, then a 2 x 2 average pool;
  - 4 stages of anti-aliased bottlenecks: every convolution at stride 1, an
    average pool of the stride after conv2 and before the 1 x 1
    downsample convolution; total stride 32;
  - `forward` returns the flattened stage-4 map [b, hw, width * 32] and
    (h, w): the dense path bypasses attnpool;
  - `attnpool_tokens` runs AttentionPool2d over a [b, h, w, embed] grid and
    drops the mean token: ZUTIS's text-space projection for the RN family;
  - `encode_image` is CLIP's pooled embedding, attnpool's lead token.

Parameters carry OpenAI's `visual.*` names without the prefix (`conv1`,
`bn1`, `layerN.M.conv1`, `layerN.M.downsample.0` / `.1`,
`attnpool.positional_embedding`, `attnpool.{q,k,v,c}_proj`), so that
`models/factory.py::load_clip_visual` loads an RN checkpoint strictly.

BatchNorm is frozen: `running_mean` and `running_var` are buffers (no
gradient, no optimiser update, no weight decay), `weight` and `bias`
trainable parameters, folded as the JAX module folds them: scale =
weight * rsqrt(var + eps) and shift = bias - mean * weight * rsqrt(var +
eps) in f32, each cast once to the compute dtype.

Convolutions are `F.conv2d` and pools `F.avg_pool2d(stride, stride)`,
which floors odd sizes as flax's VALID pooling does; the JAX package
leaves both to XLA outside any Pallas kernel. Activations run in
channels_last memory: the JAX module's NHWC, which cuDNN's tensor-core
convolutions read without a transpose, and from which the [b, h, w, c]
token grid is a view. Attnpool attends through `dot_product_attention_bshd`
(on a card the flash kernel, at head dim 64).

The reference's RN text-space projection reshapes attnpool's output with
the pre-projection channel count, which raises for every RN arch; as the
JAX package does, the tokens come back at `output_dim`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zutis_tpu_torch.models.layers import Dense, empty_param, fill_normal_
from zutis_tpu_torch.models.vit import interpolate_pos_embed
from zutis_tpu_torch.ops.attention import dot_product_attention_bshd

CL = torch.channels_last


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm: trainable affine, frozen statistics."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [b, c, h, w] -> x * scale + shift per channel, in x's dtype."""
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = (self.weight * inv).to(x.dtype)
        add = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)


class Conv2d(nn.Module):
    """A bias-free convolution, weight [out, in, k, k], padding k // 2."""

    def __init__(self, features_in: int, features_out: int, kernel: int,
                 stride: int = 1, device=None):
        super().__init__()
        self.stride, self.padding = stride, kernel // 2
        self.weight = empty_param(features_out, features_in, kernel, kernel,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype).contiguous(memory_format=CL)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)

    def init_params(self, generator: torch.Generator) -> None:
        # lecun normal over the fan-in, as flax's Conv default
        fill_normal_(self.weight, 1.0 / math.sqrt(self.weight[0].numel()),
                     generator)


class Bottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 device=None):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1, device=device)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, device=device)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv3 = Conv2d(planes, out, 1, device=device)
        self.bn3 = FrozenBatchNorm(out, device=device)
        self.downsample = None
        if stride > 1 or inplanes != out:
            # OpenAI's Sequential("-1" avgpool, "0" conv, "1" bn): the pool
            # has no parameter, so the names are .0 and .1
            self.downsample = nn.ModuleDict({
                "0": Conv2d(inplanes, out, 1, device=device),
                "1": FrozenBatchNorm(out, device=device)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [b, c, h, w]
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride, self.stride)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.downsample["1"](self.downsample["0"](identity))
        return F.relu(y + identity)

    def init_params(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "init_params"):
                m.init_params(generator)


class AttentionPool2d(nn.Module):
    """QKV attention over the mean token and the grid, returning all tokens
    projected to `output_dim`. The positional embedding is stored for
    `spacial_dim`**2 positions and interpolated bicubically to the grid with
    the ViT's +0.1 scale-factor fudge."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", device=None):
        super().__init__()
        self.embed_dim, self.num_heads, self.dtype = embed_dim, num_heads, dtype
        self.attn_impl = attn_impl
        self.positional_embedding = empty_param(spacial_dim ** 2 + 1, embed_dim,
                                                device=device)
        self.q_proj = Dense(embed_dim, embed_dim, device=device)
        self.k_proj = Dense(embed_dim, embed_dim, device=device)
        self.v_proj = Dense(embed_dim, embed_dim, device=device)
        self.c_proj = Dense(embed_dim, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [b, h, w, embed_dim] -> [b, 1 + h*w, output_dim]."""
        b, h, w, c = x.shape
        dt, heads = self.dtype, self.num_heads
        tokens = x.reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        pe = interpolate_pos_embed(self.positional_embedding, (h, w))
        tokens = tokens + pe.to(tokens.dtype)[None]
        s = tokens.shape[1]
        q, k, v = (proj(tokens, dt).reshape(b, s, heads, c // heads)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        out = dot_product_attention_bshd(q, k, v, impl=self.attn_impl)
        return self.c_proj(out.reshape(b, s, c), dt)

    def init_params(self, generator: torch.Generator) -> None:
        fill_normal_(self.positional_embedding, self.embed_dim ** -0.5,
                     generator)
        for proj in (self.q_proj, self.k_proj, self.v_proj, self.c_proj):
            proj.init_params(generator)


class ModifiedResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, heads: int = 32,
                 input_resolution: int = 224,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        self.width, self.output_dim, self.dtype = width, output_dim, dtype
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, device=device)
        self.bn1 = FrozenBatchNorm(width // 2, device=device)
        self.conv2 = Conv2d(width // 2, width // 2, 3, device=device)
        self.bn2 = FrozenBatchNorm(width // 2, device=device)
        self.conv3 = Conv2d(width // 2, width, 3, device=device)
        self.bn3 = FrozenBatchNorm(width, device=device)
        inplanes = width
        for i, (mult, blocks) in enumerate(zip((1, 2, 4, 8), layers)):
            planes, stride = width * mult, 1 if i == 0 else 2
            stage = []
            for j in range(blocks):
                stage.append(Bottleneck(inplanes, planes,
                                        stride if j == 0 else 1, device=device))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.ModuleList(stage))
        self.attnpool = AttentionPool2d(
            input_resolution // 32, self.embed_dim, heads, output_dim,
            dtype=dtype, attn_impl=attn_impl, device=device)

    @property
    def embed_dim(self) -> int:
        return self.width * 32

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> "ModifiedResNet":
        """Random parameters drawn from a CPU `generator` (seed 0 if None):
        the same values on every device. Returns self."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in (self.conv1, self.bn1, self.conv2, self.bn2, self.conv3,
                  self.bn3, *self.layer1, *self.layer2, *self.layer3,
                  *self.layer4, self.attnpool):
            m.init_params(generator)
        return self

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """x [b, 3, H, W] -> the stage-4 map [b, embed, H/32, W/32] in the
        compute dtype, channels_last."""
        x = x.to(self.dtype).contiguous(memory_format=CL)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2, 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """Dense path: ([b, hw, embed_dim] stage-4 features, h, w); attnpool
        is not applied."""
        grid = self._features(x).permute(0, 2, 3, 1)  # a view: [b, h, w, c]
        b, h, w, c = grid.shape
        return grid.reshape(b, h * w, c), h, w

    def attnpool_tokens(self, grid: torch.Tensor) -> torch.Tensor:
        """[b, h, w, embed_dim] -> attnpool's grid tokens [b, h, w,
        output_dim] (the mean token dropped)."""
        b, h, w, _ = grid.shape
        return self.attnpool(grid)[:, 1:, :].reshape(b, h, w, self.output_dim)

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled path (CLIP's image embedding): attnpool's lead token
        [b, output_dim]."""
        return self.attnpool(self._features(x).permute(0, 2, 3, 1))[:, 0, :]
