"""Flash-attention forward: the hand-written Hopper kernels
(csrc/flash_attention.cu) and their plain PyTorch version.

The kernels replace the TPU kernel zutis_tpu/ops/flash_attention.py::
_flash_kernel. They compute softmax(q k^T / sqrt(d) + key_bias, keys
masked by `kv_mask`) v with f32 softmax statistics, keep the [sq, sk]
logits on chip, and give an item whose mask has no valid key an all-zero
output, as the JAX wrapper does after its kernel. `key_bias` [b, sk] is an
additive bias a key (ToMe's log(size), the pooled memory's log(count)),
which the JAX package sends to XLA's einsum attention: each kernel has a
biased instantiation, chosen at compile time, and the unbiased ones are
unchanged.

Both dtypes take every head dim of `HEAD_DIMS`: 64 (the ViT encoders and
attnpool) and the ZUTIS decoders' width over 8 heads, 80 to 512. Dispatch is
by dtype and head dim. bf16, the serving path, on Hopper's TMA, mbarriers
and wgmma: one producer warp streams 64-key K and V chunks through a ring
in shared memory (`stages(d)` deep) to one consumer warpgroup of 64 query
rows (d 80 computes d 96's tiles, `box_cols`); at d 128 one block fills an
SM, at d 256 (the RN50 and RN101 decoders) Q also stays in shared memory;
at `HALVES_HEAD_DIMS` (RN50x4, RN50x16, RN50x64) chunks are 32 keys, two
consumer warpgroups each hold half of O's columns and compute S over half
of the head dim, adding the other's half through shared memory, a producer
warp loads below `HALVES_PRODUCER_BELOW`, and the `HALVES_CLUSTER` q tiles
of a head share each K/V chunk by TMA multicast. f32 at every head dim: every product takes three bf16 wgmma on
hi/lo splits (~16 mantissa bits). At `F32_HEAD_DIMS` (64 to 96) a producer
warpgroup loads f32 K and V chunks with TMA and splits each once into bf16
tiles for two consumer warpgroups (128 query rows a block; 64 for sq <= 64
and at d 80, 96). At `F32_WIDE_HEAD_DIMS` (128 to 512) a block is two
consumer warpgroups over 64 query rows that split each chunk of
`f32_chunk_keys(d)` keys themselves, each holding half of O's columns,
with Q's hi/lo tiles in shared memory and TMA's f32 pieces in a ring of
`wide_slots(d)`. An f32 call whose blocks cannot fill the card splits its
keys into `key_splits` ranges, whose partial results a second kernel
combines (`flash_attention_split_reference` is its plain version).

`flash_attention` takes the plain version only for tensors that lie on the
CPU. For a CUDA tensor it launches a kernel or raises: an unsupported
dtype, head dim or layout, no keys, a tensor map the driver refuses, a
missing `nvcc` or a failed build is an error, never a fallback.

The kernels are built at first use with `nvcc` for sm_90a (`_build.py`) and
bound through their plain C interface with ctypes.

Under autograd the forward runs inside `FlashAttention`, a
`torch.autograd.Function` whose backward is the JAX package's `_flash_bwd`:
it recomputes the softmax weights in f32 with the plain einsums and forms
dV, dP, dS, dQ and dK in f32, as XLA does there outside any Pallas kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from zutis_tpu_torch.ops import _build

SOURCE = _build.CSRC / "flash_attention.cu"
STEM = "libzutis_flash"
HEAD_DIMS = (64, 80, 96, 128, 256, 320, 384, 512)  # both dtypes'
HALVES_HEAD_DIMS = (320, 384, 512)  # bf16 on flash_halves_kernel
F32_HEAD_DIMS = (64, 80, 96)        # f32 on flash_f32_kernel (hi/lo splits)
F32_WIDE_HEAD_DIMS = (128, 256, 320, 384, 512)  # f32 on flash_f32_wide_kernel
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_NEG_INF = -1e30
KEY_CHUNK = 64        # keys per K/V chunk, and query rows per warpgroup
SHORT_CHUNK = 32      # keys per K/V chunk at HALVES_HEAD_DIMS
BOX_COLS = 32         # columns of a TMA box: d is computed in whole boxes
STAGES = 4            # K/V chunks in the bf16 kernel's ring at d 64 to 128
WIDE_STAGES = 3       # and at d 256, where a chunk is 32 KB
HALVES_THREADS = 288  # threads of a flash_halves_kernel block: 2 x 128 + 32
HALVES_PRODUCER_BELOW = 512  # its head dims below this have the producer warp
HALVES_CLUSTER = 2    # its blocks a cluster: a head's q tiles share K/V loads
HALVES_CLUSTER_CHUNKS = 8  # 32-key chunks a call needs to launch in clusters
EXCHANGE_BYTES = 16_384  # its two warpgroups' partial S, 64 x 32 f32 each
HALVES_RESERVE = 2048  # bytes it keeps for validity words, mbarriers, biases
F32_STAGES = 2        # f32 K/V chunks in the f32 kernel's TMA ring
SPLIT_STAGES = 2      # bf16 hi/lo K/V tiles in its split ring
WIDE_THREADS = 256    # threads of a flash_f32_wide_kernel block
WIDE_SLOTS_MAX = 4    # f32 pieces in its TMA ring, at most
WIDE_RESERVE = 1024   # bytes it keeps for the validity word, mbarriers, biases
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
SMS = 132             # streaming multiprocessors of an H100
MIN_SPLIT_CHUNKS = 2  # key chunks a range of the split path takes at least
MIN_SPLIT_KEYS = 128  # and keys


def build():
    """Compile the kernel library if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def _bind(lib: ctypes.CDLL) -> None:
    lib.zutis_flash_attention_fwd.restype = ctypes.c_int
    lib.zutis_flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.zutis_flash_occupancy.restype = ctypes.c_int
    lib.zutis_flash_occupancy.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: exact-softmax einsum attention with f32 logits and
    statistics, the f32 `key_bias` [b, sk] added to the scaled logits,
    masked keys at -1e30, P cast to v's dtype before P V, and all-masked
    items zeroed (zutis_tpu/ops/flash_attention.py::_xla_reference plus the
    wrapper's zeroing; with a bias, the f32 einsum path of
    zutis_tpu/ops/attention.py)."""
    w = softmax_weights_f32(q, k, kv_mask, key_bias)
    out = torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)
    return _zero_all_masked(out, kv_mask).to(q.dtype)


def softmax_weights_f32(q, k, kv_mask, key_bias=None) -> torch.Tensor:
    """W = softmax(q k^T / sqrt(d) + key_bias) in f32, masked keys at -1e30
    (zutis_tpu/ops/flash_attention.py::_xla_reference); an all-masked row
    is uniform."""
    s = _scaled_logits(q, k, key_bias)
    if kv_mask is not None:
        s = s.masked_fill(~(kv_mask > 0)[:, None, None, :], _NEG_INF)
    return torch.softmax(s, dim=-1)


def _scaled_logits(q, k, key_bias) -> torch.Tensor:
    """q k^T / sqrt(d) in f32, plus key_bias [b, sk] broadcast over heads
    and queries."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    return s


def _zero_all_masked(out: torch.Tensor, kv_mask) -> torch.Tensor:
    """`out` with the items that have no valid key set to zero."""
    if kv_mask is None:
        return out
    any_valid = (kv_mask > 0).any(dim=-1)
    return out * any_valid[:, None, None, None].to(out.dtype)


def flash_attention_split_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    n_splits: int = 1,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the f32 kernels' split path, in f32: the keys cut
    into `n_splits` ranges of `split_chunks` chunks of `f32_chunk_keys(d)`
    keys (a range past the last chunk is empty), each range's unnormalised
    output O_s, row max m_s and sum l_s, then the combine
    O = sum_s e^(m_s - M) O_s / max(sum_s e^(m_s - M) l_s, 1e-30), the
    logits taking `key_bias` before the ranges' maxima, M the largest m_s
    of the ranges with l_s > 0. A range with no valid key gets
    weight 0 (its m_s never enters an exponent); an item with no valid key
    comes out zero."""
    sk, d = k.shape[2], k.shape[3]
    per = split_chunks(sk, n_splits, d) * f32_chunk_keys(d)
    s = _scaled_logits(q, k, key_bias)
    if kv_mask is not None:
        s = s.masked_fill(~(kv_mask > 0)[:, None, None, :], float("-inf"))
    parts = []
    for i in range(n_splits):
        lo, hi = min(i * per, sk), min((i + 1) * per, sk)
        s_i = s[..., lo:hi]
        m_i = (s_i.amax(-1, keepdim=True) if hi > lo
               else s.new_full(s.shape[:-1] + (1,), float("-inf")))
        p = torch.exp(s_i - torch.where(torch.isfinite(m_i), m_i, 0.0))
        o_i = torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, lo:hi].float())
        parts.append((m_i, p.sum(-1, keepdim=True), o_i))
    big_m = torch.stack([torch.where(l_i > 0, m_i, float("-inf"))
                         for m_i, l_i, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for m_i, l_i, o_i in parts:
        live = l_i > 0
        w = torch.where(live, torch.exp(torch.where(live, m_i - big_m, 0.0)),
                        0.0)
        num = num + w * o_i
        den = den + w * l_i
    return (num / den.clamp(min=1e-30)).to(q.dtype)


def block_rows(sq: int, d: int) -> int:
    """Query rows a block of the f32 kernels at head dim d takes: two
    consumer warpgroups of their own rows at d 64 for sq > 64, else one
    warpgroup's 64 (f32_consumers in csrc/flash_attention.cu; at
    F32_WIDE_HEAD_DIMS two warpgroups share the 64 rows)."""
    return 2 * KEY_CHUNK if d == 64 and sq > KEY_CHUNK else KEY_CHUNK


def f32_chunk_keys(d: int) -> int:
    """Keys a K/V chunk of the f32 kernels at head dim d (wide_keys in
    csrc/flash_attention.cu): 64 to d 128, 32 at 256 and 320, 16 at 384
    and 512, as wide as Q's hi/lo tiles leave room for."""
    return KEY_CHUNK if d <= 128 else 32 if d <= 320 else 16


def split_chunks(sk: int, n_splits: int, d: int = 64) -> int:
    """Chunks of `f32_chunk_keys(d)` keys in each of `n_splits` key ranges
    (the last may hold fewer, and ranges past the last chunk none), as the
    kernel cuts them."""
    chunks = -(-sk // f32_chunk_keys(d))
    return -(-chunks // n_splits)


def key_splits(b: int, h: int, sq: int, sk: int, d: int = 64) -> int:
    """Key ranges the f32 kernel at head dim d cuts one call into: 1 when
    its b * h * ceil(sq / block_rows) blocks fill an H100's SMS SMs; else
    enough ranges of at least MIN_SPLIT_CHUNKS chunks and MIN_SPLIT_KEYS
    keys each that the blocks come to about one wave, and none of them
    empty."""
    blocks = b * h * -(-sq // block_rows(sq, d))
    if blocks == 0 or blocks >= SMS:
        return 1
    keys = f32_chunk_keys(d)
    chunks = -(-sk // keys)
    least = max(MIN_SPLIT_CHUNKS, -(-MIN_SPLIT_KEYS // keys))
    per = max(least, -(-chunks // (SMS // blocks)))
    return -(-chunks // per)


def box_cols(d: int) -> int:
    """Columns the TMA kernels compute at head dim d: d in whole 32-column
    boxes (96 at d 80, whose last 16 columns arrive as zeros)."""
    return -(-d // BOX_COLS) * BOX_COLS


def chunk_keys(d: int) -> int:
    """Keys a K/V chunk of the bf16 kernels at head dim d: 64, or 32 at
    HALVES_HEAD_DIMS."""
    return SHORT_CHUNK if d in HALVES_HEAD_DIMS else KEY_CHUNK


def stages(d: int) -> int:
    """K/V chunks in the bf16 kernels' ring at head dim d (flash_stages and
    halves_stages in csrc/flash_attention.cu): 4 at d 64 to 128, 3 at 256,
    and at HALVES_HEAD_DIMS as many as fit beside Q, the exchange slots and
    HALVES_RESERVE (4, 3, 2 at d 320, 384, 512)."""
    if d in HALVES_HEAD_DIMS:
        room = SMEM_LIMIT - KEY_CHUNK * d * 2 - EXCHANGE_BYTES - HALVES_RESERVE
        return room // (2 * SHORT_CHUNK * d * 2)
    return WIDE_STAGES if d > 128 else STAGES


def halves_threads(d: int) -> int:
    """Threads of a flash_halves_kernel block at head dim d (halves_threads
    in csrc/flash_attention.cu): two consumer warpgroups and a producer warp
    below HALVES_PRODUCER_BELOW; from it the consumers alone, whose first
    warp loads (the card gives a 288-thread wgmma block a 384-thread one's
    registers, too few for d 512's accumulator)."""
    return HALVES_THREADS if d < HALVES_PRODUCER_BELOW else 2 * 128


def min_blocks(d: int) -> int:
    """Blocks an SM the bf16 kernels are built to hold at head dim d (their
    __launch_bounds__, flash_min_blocks): two at d 64 to 96, one from 128."""
    return 2 if d < 128 else 1


def _with_bias(layout: dict, slots: int, keys: int = KEY_CHUNK) -> dict:
    """`layout` with a ring of `slots` chunks' key biases (`keys` f32 a
    chunk, already times log2(e)) appended after its mbarriers."""
    return dict(layout, bias=layout["total"],
                total=layout["total"] + slots * keys * 4)


def smem_layout(d: int, bias: bool = False) -> dict:
    """Byte offsets into one bf16 block's dynamic shared memory, as the
    kernels lay it out (flash_layout, halves_layout in
    csrc/flash_attention.cu): the Q tile (64 rows), `stages(d)` K chunks,
    as many V chunks (each `chunk_keys(d)` rows; every row `box_cols(d)`
    bf16 columns, no padding), at HALVES_HEAD_DIMS the exchange slots
    (`xchg`: EXCHANGE_BYTES, the two warpgroups' partial S), a 64-bit
    key-validity word per stage, then the mbarriers: q_full and a full and
    an empty one per K and V stage. The biased kernel appends 2 * stages(d)
    chunks' key biases. `total` is the block's size."""
    cols, keys, n = box_cols(d), chunk_keys(d), stages(d)
    chunk = keys * cols * 2
    k = KEY_CHUNK * cols * 2
    v = k + n * chunk
    valid = v + n * chunk
    layout = dict(q=0, k=k, v=v)
    if d in HALVES_HEAD_DIMS:
        layout["xchg"] = valid
        valid += EXCHANGE_BYTES
    bars = valid + n * 8
    layout.update(valid=valid, bars=bars, total=bars + (1 + 4 * n) * 8)
    return _with_bias(layout, 2 * n, keys) if bias else layout


def f32_smem_layout(d: int, bias: bool = False) -> dict:
    """Byte offsets into one f32 block's dynamic shared memory (f32_layout
    in csrc/flash_attention.cu): a tile's f32 Q rows (a 64-row TMA box per
    consumer warpgroup: two at d 64, one at d 80 and 96), F32_STAGES f32 K
    chunks and as many V chunks (64 rows of box_cols(d) f32, unswizzled, as
    TMA writes them), then SPLIT_STAGES bf16 tiles each of K hi, K lo, V hi
    and V lo (64 rows of box_cols(d) bf16 in the swizzled chunk layout), a
    64-bit key-validity word per split stage, then the mbarriers: kf_full
    and vf_full per f32 stage, k_full, k_empty, v_full and v_empty per split
    stage, q_full and q_empty. The biased kernel appends 2 * SPLIT_STAGES
    chunks' key biases. At F32_WIDE_HEAD_DIMS, `wide_smem_layout`."""
    if d in F32_WIDE_HEAD_DIMS:
        return wide_smem_layout(d, bias)
    f32_chunk = KEY_CHUNK * box_cols(d) * 4
    tile = KEY_CHUNK * box_cols(d) * 2
    kf = block_rows(2 * KEY_CHUNK, d) // KEY_CHUNK * f32_chunk
    vf = kf + F32_STAGES * f32_chunk
    khi = vf + F32_STAGES * f32_chunk
    klo = khi + SPLIT_STAGES * tile
    vhi = klo + SPLIT_STAGES * tile
    vlo = vhi + SPLIT_STAGES * tile
    valid = vlo + SPLIT_STAGES * tile
    bars = valid + SPLIT_STAGES * 8
    layout = dict(q=0, kf=kf, vf=vf, khi=khi, klo=klo, vhi=vhi, vlo=vlo,
                  valid=valid, bars=bars,
                  total=bars + (2 * F32_STAGES + 4 * SPLIT_STAGES + 2) * 8)
    return _with_bias(layout, 2 * SPLIT_STAGES) if bias else layout


def wide_slots(d: int) -> int:
    """f32 pieces (a chunk of K or V, or f32_chunk_keys(d) rows of Q) in
    flash_f32_wide_kernel's TMA ring at head dim d (wide_slots in
    csrc/flash_attention.cu): as many as fit beside Q's hi/lo tiles, the K
    and V hi/lo tiles and WIDE_RESERVE, at most WIDE_SLOTS_MAX (4, 3, 1, 3,
    1 at d 128, 256, 320, 384, 512)."""
    keys = f32_chunk_keys(d)
    room = SMEM_LIMIT - 2 * KEY_CHUNK * d * 2 - 4 * keys * d * 2 - WIDE_RESERVE
    return min(WIDE_SLOTS_MAX, room // (keys * d * 4))


def wide_smem_layout(d: int, bias: bool = False) -> dict:
    """Byte offsets into one block of flash_f32_wide_kernel (wide_layout
    in csrc/flash_attention.cu): Q's bf16 hi and lo tiles (64 rows of d
    each, the swizzled chunk layout), the hi and lo tiles of one K and one
    V chunk (f32_chunk_keys(d) rows), `wide_slots(d)` f32 pieces (as TMA
    writes them: d / 32 boxes of f32_chunk_keys(d) rows by 32 floats), the
    chunk's 64-bit key-validity word, then a full mbarrier per slot. The
    biased kernel appends one chunk's key biases. `total` is the block's
    size."""
    keys, slots = f32_chunk_keys(d), wide_slots(d)
    q, tile = KEY_CHUNK * d * 2, keys * d * 2
    khi = 2 * q
    klo, vhi, vlo = khi + tile, khi + 2 * tile, khi + 3 * tile
    f32 = khi + 4 * tile
    valid = f32 + slots * keys * d * 4
    bars = valid + 8
    layout = dict(qhi=0, qlo=q, khi=khi, klo=klo, vhi=vhi, vlo=vlo, f32=f32,
                  valid=valid, bars=bars, total=bars + slots * 8)
    return _with_bias(layout, 1, keys) if bias else layout


def check_kernel_inputs(q, k, v, kv_mask, key_bias=None) -> None:
    """Raise on anything the kernels do not take: dtype other than bf16 or
    f32, head dim outside HEAD_DIMS, no keys, mismatched shapes or devices,
    a head dim that is not contiguous, strides and addresses not 16-byte
    aligned, or a key_bias other than a contiguous f32 [b, sk]."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("the attention kernels take q, k, v of rank 4 [b, h, s, d]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"head dim {d} not supported by the kernel (supported: {HEAD_DIMS})")
    if sk == 0:
        raise ValueError("the kernels need at least one key")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes q, k, v "
            "all bfloat16 or all float32")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if any(st % vec for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name}'s strides {x.stride()} and address must be 16-byte "
                "aligned")
    if kv_mask is not None:
        if kv_mask.shape != (b, sk) or kv_mask.device != q.device:
            raise ValueError(
                f"kv_mask must be [b, sk] = {(b, sk)} on {q.device}, got "
                f"{tuple(kv_mask.shape)} on {kv_mask.device}")
    if key_bias is not None:
        if (key_bias.shape != (b, sk) or key_bias.device != q.device
                or key_bias.dtype != torch.float32
                or not key_bias.is_contiguous()):
            raise ValueError(
                f"key_bias must be a contiguous float32 [b, sk] = {(b, sk)} "
                f"on {q.device}, got {key_bias.dtype} "
                f"{tuple(key_bias.shape)} on {key_bias.device}")


def occupancy(d: int, dtype: torch.dtype = torch.bfloat16,
              block_q: Optional[int] = None,
              bias: bool = False) -> tuple[int, int]:
    """(dynamic shared memory bytes, blocks per SM) of the kernel of `dtype`
    at this head dim, biased or not, from the current card's occupancy
    calculator; block_q is 64 for bf16 and for f32 from d 80, 64 or 128
    (the default) for f32 at d 64."""
    if block_q is None:
        block_q = (block_rows(2 * KEY_CHUNK, d) if dtype == torch.float32
                   else KEY_CHUNK)
    lib = _build.load(SOURCE, STEM, _bind)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.zutis_flash_occupancy(_DTYPE_CODES[dtype], d, block_q, int(bias),
                                    ctypes.byref(smem), ctypes.byref(blocks))
    _build.check_launch(lib, err, "flash occupancy")
    return smem.value, blocks.value


class FlashAttention(torch.autograd.Function):
    """The flash forward with the JAX package's recomputing backward
    (`_flash_fwd` / `_flash_bwd`): the residuals are q, k, v, the mask and
    the key bias; the gradients come back in each input's dtype and shape,
    so strided [b, s, h, d] views get theirs through the view. The key
    bias gets none: its callers' biases (ToMe's sizes, the pooled memory's
    counts) depend on no parameter."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, key_bias):
        if key_bias is not None and key_bias.requires_grad:
            raise ValueError("flash_attention gives key_bias no gradient; "
                             "detach it or take the 'torch' attention path")
        ctx.save_for_backward(q, k, v, kv_mask, key_bias)
        return _flash_forward(q, k, v, kv_mask, key_bias=key_bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, kv_mask, key_bias = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        w = softmax_weights_f32(q, k, kv_mask, key_bias)
        g32 = g.float()
        dv = torch.einsum("bhqk,bhqd->bhkd", w, g32)
        dp = torch.einsum("bhqd,bhkd->bhqk", g32, v.float())
        ds = w * (dp - (w * dp).sum(dim=-1, keepdim=True))
        del w, dp
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(
    q: torch.Tensor,  # [b, h, sq, d]
    k: torch.Tensor,  # [b, h, sk, d]
    v: torch.Tensor,  # [b, h, sk, d]
    kv_mask: Optional[torch.Tensor] = None,  # [b, sk] bool/int, nonzero = valid
    key_bias: Optional[torch.Tensor] = None,  # [b, sk] f32, additive
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + key_bias[:, None, None, :], keys masked by
    kv_mask) v -> [b, h, sq, d]. A masked key has zero weight whatever its
    bias.

    Differentiable in q, k and v (`FlashAttention`). The kernel launch
    count is `flash_attention.launches` (one a call); of those the launches
    given a mask are `flash_attention.masked_launches`, those given a key
    bias `flash_attention.biased_launches`, the f32 calls split by
    `key_splits`, each with a combine launch,
    `flash_attention.split_launches`, and `flash_attention.launches_by_dim`
    counts them by head dim ({d: launches})."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _flash_forward(q, k, v, kv_mask, key_bias=key_bias)
    # items with no valid key: zero, and no gradient through them (the JAX
    # wrapper's zeroing, outside the custom VJP)
    return _zero_all_masked(FlashAttention.apply(q, k, v, kv_mask, key_bias),
                            kv_mask)


def _flash_forward(q, k, v, kv_mask, n_splits=None,
                   key_bias=None) -> torch.Tensor:
    """The forward: the plain version on the CPU, a kernel on a card. An
    f32 call takes `key_splits` key ranges unless `n_splits` says how many."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not {q.device}")
    check_kernel_inputs(q, k, v, kv_mask, key_bias)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # same memory layout as q: a transposed [b, s, h, d] view stays one
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    mask = None
    if kv_mask is not None:
        # an int32 mask is read as it is (nonzero = valid), so a caller that
        # masks many calls converts it once
        mask = kv_mask
        if mask.dtype != torch.int32 or not mask.is_contiguous():
            mask = (kv_mask > 0).to(torch.int32).contiguous()
    splits = 1
    if q.dtype == torch.float32:
        splits = key_splits(b, h, sq, sk, d) if n_splits is None else n_splits
    elif n_splits not in (None, 1):
        raise ValueError("only the f32 kernels split their keys")
    o_part = ml = None
    if splits > 1:  # the split path's workspace; the library allocates nothing
        o_part = torch.empty((splits, b, h, sq, d), dtype=torch.float32,
                             device=q.device)
        ml = torch.empty((splits, b, h, sq, 2), dtype=torch.float32,
                         device=q.device)
    lib = _build.load(SOURCE, STEM, _bind)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.zutis_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if key_bias is None else key_bias.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, sq, sk, d, strides, d ** -0.5,
            splits, None if o_part is None else o_part.data_ptr(),
            None if ml is None else ml.data_ptr(), stream,
        )
    _build.check_launch(lib, err, "flash attention")
    flash_attention.launches += 1
    flash_attention.masked_launches += mask is not None
    flash_attention.biased_launches += key_bias is not None
    flash_attention.split_launches += splits > 1
    by_dim = flash_attention.launches_by_dim
    by_dim[d] = by_dim.get(d, 0) + 1
    return o


flash_attention.launches = 0
flash_attention.masked_launches = 0  # the launches given a kv_mask
flash_attention.biased_launches = 0  # the launches given a key_bias
flash_attention.split_launches = 0   # the f32 launches split, with a combine
flash_attention.launches_by_dim = {}  # {head dim: launches}
