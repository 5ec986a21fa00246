"""The flash-attention kernels (csrc/flash_attention.cu) against their plain
version on the card (bf16 and f32 at every head dim the model factory
gives: 64, 80, 96, 128, 256, 320, 384, 512), and the kernels' launch
geometry, their constants against the CUDA sources and the input checks on
the CPU.

The kernels have no CPU mode, so the tests that launch them are marked
`cuda` and skip without a card. The file imports no JAX, so that it runs on
a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_flash_kernel.py

Inputs are numpy-seeded. bf16 outputs are held to 8e-3 of the largest
|output| against the plain version on f32 copies of the same inputs: the
kernel rounds P to bf16 before P V and the output to bf16, about 2^-9
relative each, and reads at most 3.1e-3 of it on an H100. Giving the zero
keys past a ragged edge any weight, or skipping a 64-key chunk, costs
several times that. f32 inputs take hi/lo bf16 splits (~16 mantissa bits)
at every head dim, and are held to 1e-4 absolute, split and unsplit alike.
"""
import re

import numpy as np
import pytest
import torch

from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import flash_attention as fa
from zutis_tpu_torch.tools import flash_f32_bench

TOL_BF16 = 8e-3  # of the largest |output|
TOL_F32 = 1e-4
# [b, h, sq, sk, d] of the serving forward at 384 px, batch 8
ENCODER_SELF = (8, 12, 577, 577, 64)
DECODER_SELF = (8, 8, 100, 100, 96)
DECODER_CROSS = (8, 8, 100, 2304, 96)
# the RN50 decoder's at 384 px (2048 channels over 8 heads: head dim 256;
# 12 x 12 tokens upsampled to 24 x 24 memory keys)
RN_DECODER_SELF = (8, 8, 100, 100, 256)
RN_DECODER_CROSS = (8, 8, 100, 576, 256)
# memory keys of the decoders at the new head dims: the ViT-L/14@336px
# decoder (d 128) and the DINO arm at RN50x4's text width (d 80) over 48 x
# 48 upsampled tokens, the RN50x4 / x16 / x64 decoders (d 320, 384, 512)
# over 24 x 24 at 384 px; f32 at d 256 is RN50's
WIDE_CROSS_KEYS = {80: 2304, 128: 2304, 256: 576, 320: 576, 384: 576,
                   512: 576}
NEW_DIMS = ([(torch.bfloat16, d) for d in (80, 128, 320, 384, 512)]
            + [(torch.float32, d) for d in (80, 128, 256, 320, 384, 512)])


def _qkv(seed, b, h, sq, sk, d, strided=False):
    """q, k, v [b, h, s, d]; `strided` makes them [b, s, h, d] and returns
    [b, h, s, d] views, as the model's projections reach the kernel."""
    rng = np.random.RandomState(seed)
    if strided:
        return [torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
                .transpose(1, 2) for s in (sq, sk, sk)]
    return [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
            for s in (sq, sk, sk)]


def _mask(seed, b, sk, all_masked):
    m = (np.random.RandomState(seed).rand(b, sk) > 0.3).astype(np.int32)
    m[all_masked] = 0
    return torch.from_numpy(m)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _bias(seed, b, sk):
    """A key bias [b, sk]: the log of counts 1 to 4, as the pooled decoder
    memory's log(count)."""
    counts = np.random.RandomState(seed).randint(1, 5, (b, sk))
    return torch.from_numpy(np.log(counts).astype(np.float32))


def _check(shape, dtype=torch.bfloat16, masked=False, strided=False,
           biased=False):
    """One launch against the plain version on f32 copies of its inputs."""
    _needs_card()
    b, h, sq, sk, d = shape
    q, k, v = (x.cuda().to(dtype) for x in _qkv(8, *shape, strided=strided))
    mask = _mask(8, b, sk, all_masked=1).cuda() if masked else None
    bias = _bias(8, b, sk).cuda() if biased else None
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mask, bias)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert got.stride() == q.stride()  # written in place of the caller's layout
    want = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask,
                                        bias)
    if dtype == torch.bfloat16:
        tol = TOL_BF16 * want.abs().max().item()
    else:
        tol = TOL_F32
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)
    if masked:
        assert (got[1] == 0).all()  # no valid key: exactly zero


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,masked,strided", [
    (ENCODER_SELF, torch.bfloat16, False, False),
    (DECODER_SELF, torch.bfloat16, False, False),
    (DECODER_CROSS, torch.bfloat16, False, False),
    (ENCODER_SELF, torch.bfloat16, False, True),
    (DECODER_SELF, torch.bfloat16, False, True),
    (DECODER_CROSS, torch.bfloat16, False, True),
    ((1, 2, 577, 260, 64), torch.bfloat16, False, False),   # ragged sq, sk
    ((2, 3, 130, 260, 96), torch.bfloat16, False, True),
    ((3, 8, 64, 200, 96), torch.bfloat16, True, False),     # all-masked item
    ((3, 4, 130, 300, 64), torch.bfloat16, True, True),
    ((2, 3, 50, 70, 64), torch.bfloat16, True, True),
    ((3, 2, 190, 129, 96), torch.bfloat16, True, True),
    ((3, 8, 64, 200, 96), torch.float32, True, False),
    ((2, 12, 77, 333, 64), torch.float32, False, False),
    ((2, 4, 100, 300, 96), torch.float32, False, True),
    (RN_DECODER_SELF, torch.bfloat16, False, False),
    (RN_DECODER_CROSS, torch.bfloat16, False, False),
    (RN_DECODER_SELF, torch.bfloat16, False, True),
    (RN_DECODER_CROSS, torch.bfloat16, False, True),
    ((8, 8, 100, 577, 256), torch.bfloat16, True, True),  # ragged, masked
    ((2, 3, 130, 65, 256), torch.bfloat16, True, False),  # keys past the edge
], ids=lambda x: str(x).replace("torch.", "").replace(" ", ""))
def test_cuda_kernel_matches_reference_on_the_card(shape, dtype, masked,
                                                   strided):
    _check(shape, dtype, masked, strided)


def _wide_case(d, case):
    """(shape, masked, strided) of `case` at head dim d: the decoder's self-
    and cross-attention at batch 8, a ragged last chunk under a kv_mask with
    an all-masked item, and 33 keys (one past a 32-key chunk; 31 rows past
    the edge of a 64-key one)."""
    return {
        "self": ((8, 8, 100, 100, d), False, False),
        "cross": ((8, 8, 100, WIDE_CROSS_KEYS[d], d), False, True),
        "ragged masked": ((3, 4, 130, 577, d), True, True),
        "keys past the edge": ((2, 3, 70, 33, d), False, True),
    }[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["self", "cross", "ragged masked",
                                  "keys past the edge"])
@pytest.mark.parametrize("dtype,d", NEW_DIMS,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_cuda_kernel_at_the_new_head_dims(dtype, d, case):
    shape, masked, strided = _wide_case(d, case)
    before = dict(fa.flash_attention.launches_by_dim)
    _check(shape, dtype, masked, strided)
    assert fa.flash_attention.launches_by_dim[d] == before.get(d, 0) + 1


# flash_halves_kernel's edges (d 320-512, 32-key chunks in a ring of 4, 3,
# 2 stages): one chunk, fewer chunks than stages, 72 chunks wrapping the ring
# many times, the cross masked and biased
HALVES_CASES = {
    "one chunk": ((2, 8, 100, 20, None), False, False),
    "one whole chunk masked": ((3, 4, 70, 32, None), True, False),
    "fewer chunks than stages": ((2, 8, 100, 40, None), True, False),
    "long": ((2, 8, 100, 2304, None), False, False),
    "cross masked biased": ((8, 8, 100, 576, None), True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HALVES_CASES))
@pytest.mark.parametrize("d", fa.HALVES_HEAD_DIMS)
def test_cuda_halves_kernel_edges(d, case):
    (b, h, sq, sk, _), masked, biased = HALVES_CASES[case]
    if case == "fewer chunks than stages":
        assert -(-sk // fa.SHORT_CHUNK) < fa.stages(320)
    _check((b, h, sq, sk, d), masked=masked, strided=True, biased=biased)


@pytest.mark.cuda
@pytest.mark.parametrize("biased", [False, True], ids=["plain", "biased"])
@pytest.mark.parametrize("d", fa.HALVES_HEAD_DIMS)
def test_cuda_halves_kernel_launches_repeat_bit_for_bit(d, biased):
    """Launches of one call give the same bits: a race between the
    warpgroups' exchange of S's halves, or in the ring, would not."""
    _needs_card()
    b, h, sq, sk = 8, 8, 100, 576
    q, k, v = (x.cuda().to(torch.bfloat16)
               for x in _qkv(15, b, h, sq, sk, d, strided=True))
    mask = _mask(15, b, sk, all_masked=1).cuda()
    bias = _bias(15, b, sk).cuda() if biased else None
    outs = [fa.flash_attention(q, k, v, mask, bias) for _ in range(8)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


# The bucketed eval's shapes at batch 32 in the 512 x 640 bucket: encoder
# self-attention over CLS + 32 x 40 patch tokens, decoder self-attention, and
# the cross-attention into the 64 x 80 upsampled memory. The masks are the
# eval's windows: each native grid top-left in the padded one, so that every
# padded row ends in masked keys and the padded bottom rows hold whole
# 64-key chunks with no valid key.
EVAL_NATIVE = [((480 + 8 * (i % 5)) // 16, (640 - 16 * (i % 3)) // 16)
               for i in range(32)]


def _window_mask(grids, hp, wp, cls):
    m = np.zeros((len(grids), hp, wp), np.int32)
    for i, (h, w) in enumerate(grids):
        m[i, :h, :w] = 1
    m = m.reshape(len(grids), hp * wp)
    if cls:
        m = np.concatenate([np.ones((len(grids), 1), np.int32), m], axis=1)
    return torch.from_numpy(m)


def _check_mask(shape, mask):
    _needs_card()
    q, k, v = (x.cuda().to(torch.bfloat16) for x in _qkv(9, *shape, strided=True))
    mask = mask.cuda()
    before = fa.flash_attention.masked_launches
    got = fa.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.flash_attention.masked_launches == before + 1
    want = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask)
    tol = TOL_BF16 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["encoder", "cross"])
def test_cuda_eval_shapes_under_window_masks(name):
    if name == "encoder":
        shape, mask = (32, 12, 1281, 1281, 64), _window_mask(EVAL_NATIVE, 32, 40, True)
    else:
        grids = [(2 * h, 2 * w) for h, w in EVAL_NATIVE]
        shape, mask = (32, 8, 100, 5120, 96), _window_mask(grids, 64, 80, False)
    # at least one 64-key chunk of a padded row holds no valid key
    chunks = mask[:, :mask.shape[1] // 64 * 64].reshape(32, -1, 64)
    assert (chunks.sum(-1) == 0).any()
    _check_mask(shape, mask)


@pytest.mark.cuda
def test_cuda_eval_decoder_self_attention():
    _check((32, 8, 100, 100, 96), strided=True)


@pytest.mark.cuda
def test_cuda_one_valid_key_besides_cls():
    """sk 1281 with CLS and one other valid key per item, the key moving
    across chunks: every other chunk of the row is wholly masked."""
    mask = torch.zeros(32, 1281, dtype=torch.int32)
    mask[:, 0] = 1
    mask[torch.arange(32), 1 + 40 * torch.arange(32)] = 1
    _check_mask((32, 4, 130, 1281, 64), mask)


# SelfMask's f32 calls at a reduced encoder length: encoder self, the
# 20-query cross-attention into the patch tokens (split keys) and the decoder
# self-attention, as the model passes them ([b, s, h, d] views)
SELFMASK_SHAPES = [(1, 6, 700, 700, 64), (1, 6, 20, 5504, 64),
                   (1, 6, 20, 20, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SELFMASK_SHAPES, ids=str)
def test_cuda_f32_kernel_at_the_selfmask_shapes(shape):
    before = fa.flash_attention.split_launches
    _check(shape, torch.float32, strided=True)
    split = fa.key_splits(*shape[:4]) > 1
    assert fa.flash_attention.split_launches == before + split


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [
    ((3, 8, 20, 700, 96), True),    # split keys under a mask, d 96
    ((3, 4, 130, 300, 96), True),   # two consumer warpgroups under a mask
    ((2, 4, 100, 1, 64), False),    # keys past the edge
    ((2, 4, 20, 65, 96), False),
    ((1, 4, 130, 577, 64), False),
], ids=str)
def test_cuda_f32_kernel_masks_and_edges(shape, masked):
    _check(shape, torch.float32, masked=masked, strided=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,splits", [
    ((1, 6, 20, 5504, 64), 22),   # the SelfMask cross call's own split
    ((1, 6, 20, 5504, 64), 100),  # ranges past the last chunk
    ((3, 6, 20, 5504, 64), 7),    # under a mask
    ((3, 2, 130, 700, 96), 4),
], ids=str)
def test_cuda_split_and_unsplit_launches_agree(shape, splits):
    _needs_card()
    b, h, sq, sk, d = shape
    q, k, v = (x.cuda() for x in _qkv(10, *shape, strided=True))
    mask = None
    if b > 1:  # item 1 with no valid key, item 0 whole key ranges without
        mask = _mask(10, b, sk, all_masked=1).cuda()
        mask[0, 64:400] = 0
    launches = fa.flash_attention.launches
    split_launches = fa.flash_attention.split_launches
    whole = fa._flash_forward(q, k, v, mask, 1)
    split = fa._flash_forward(q, k, v, mask, splits)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 2
    assert fa.flash_attention.split_launches == split_launches + 1
    torch.testing.assert_close(split, whole, rtol=0, atol=TOL_F32)
    if mask is not None:
        assert (split[1] == 0).all() and (whole[1] == 0).all()
    want = fa.flash_attention_split_reference(q, k, v, mask, splits)
    torch.testing.assert_close(split, want, rtol=0, atol=TOL_F32)


# the last chunk holds 1 key and 63 rows that TMA fills with zeros: only the
# per-chunk validity keeps them out of the softmax
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 4, 100, 1, 64), (2, 4, 100, 65, 96), (1, 4, 130, 577, 64),
], ids=str)
def test_cuda_keys_past_the_edge_get_no_weight(shape):
    _check(shape, strided=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_cuda_occupancy_reports_the_launched_kernel(d):
    _needs_card()
    smem, blocks = fa.occupancy(d)
    assert smem == fa.smem_layout(d)["total"]
    # the design: at d 64 to 96 two blocks, one's loads overlapping the
    # other's work; from d 128 one block holds Q and a deep ring
    assert blocks == fa.min_blocks(d) == (2 if d < 128 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d,block_q", [(64, 64), (64, 128), (96, 64),
                                       (80, 64)])
def test_cuda_f32_occupancy_reports_the_launched_kernel(d, block_q):
    _needs_card()
    smem, blocks = fa.occupancy(d, torch.float32, block_q)
    assert smem == fa.f32_smem_layout(d)["total"]
    assert blocks == 1  # a block holds the SM's registers (setmaxnreg)


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.F32_WIDE_HEAD_DIMS)
def test_cuda_f32_wide_occupancy_reports_the_launched_kernel(d):
    _needs_card()
    smem, blocks = fa.occupancy(d, torch.float32)
    assert smem == fa.wide_smem_layout(d)["total"]
    assert blocks == 1  # the block takes nearly all of an SM's shared memory


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.F32_WIDE_HEAD_DIMS)
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_cuda_f32_wide_split_and_unsplit_launches_agree(d, masked):
    """The wide f32 kernel's split path (a combine after it) at each head
    dim: the decoder's 100 queries over a ragged 577 keys as [b, s, h, d]
    views, cut into 3 ranges, and the count `key_splits` gives one head's
    cross-attention, against the unsplit launch and the plain split
    version; masked, item 1 has no valid key and item 0 a whole range
    without one."""
    _needs_card()
    b, h, sq, sk = 3, 4, 100, 577
    q, k, v = (x.cuda() for x in _qkv(14, b, h, sq, sk, d, strided=True))
    mask = None
    if masked:
        mask = _mask(14, b, sk, all_masked=1).cuda()
        mask[0, 64:320] = 0
    whole = fa._flash_forward(q, k, v, mask, 1)
    for splits in (3, fa.key_splits(1, 8, sq, sk, d)):
        before = fa.flash_attention.split_launches
        split = fa._flash_forward(q, k, v, mask, splits)
        torch.cuda.synchronize()
        assert fa.flash_attention.split_launches == before + (splits > 1)
        torch.testing.assert_close(split, whole, rtol=0, atol=TOL_F32)
        want = fa.flash_attention_split_reference(q, k, v, mask, splits)
        torch.testing.assert_close(split, want, rtol=0, atol=TOL_F32)
        if masked:
            assert (split[1] == 0).all()


# ---------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_smem_layout_keeps_tiles_on_the_swizzle_pattern(d):
    lay = fa.smem_layout(d)
    cols, stages = fa.box_cols(d), fa.stages(d)
    q_tile, chunk = fa.KEY_CHUNK * cols * 2, fa.chunk_keys(d) * cols * 2
    tiles = [lay["q"]] + [lay[area] + s * chunk for area in ("k", "v")
                          for s in range(stages)]
    # TMA's and wgmma's 64-byte swizzle repeats every 512 bytes, from
    # absolute address bits, so every tile (and every 4 KB box in it)
    # starts on that boundary
    assert all(t % 512 == 0 for t in tiles)
    # every box starts on its size: 4 KB (64 rows), 2 KB (32-key chunks)
    assert all(t % (fa.chunk_keys(d) * 64) == 0 for t in tiles)
    # areas in order, none overlapping the next
    assert lay["q"] + q_tile <= lay["k"]
    assert lay["k"] + stages * chunk <= lay["v"]
    assert lay["v"] + stages * chunk <= lay["valid"]
    assert lay["valid"] + stages * 8 <= lay["bars"]
    assert lay["bars"] % 8 == 0  # mbarriers are 8-byte words
    assert lay["total"] == lay["bars"] + (1 + 4 * stages) * 8
    assert lay["total"] <= fa.SMEM_LIMIT
    # the rings at d 256 and above are as deep as a block's shared memory
    # allows
    if d >= 256:
        assert lay["total"] + 2 * chunk > fa.SMEM_LIMIT


@pytest.mark.parametrize("bias", [False, True], ids=["plain", "biased"])
@pytest.mark.parametrize("d", fa.HALVES_HEAD_DIMS)
def test_halves_layout_holds_the_exchange_slots(d, bias):
    """flash_halves_kernel's layout (halves_layout): Q, the K and V rings,
    the two warpgroups' 8 KB exchange slots of partial S (16-byte words),
    the validity words and mbarriers, then with a bias 2 * stages chunks'
    32 key biases; it fits one block an SM, and its ring is as deep as
    room beside Q, the slots and the reserve allows."""
    lay, n = fa.smem_layout(d, bias), fa.stages(d)
    chunk = fa.SHORT_CHUNK * d * 2
    assert lay["k"] == fa.KEY_CHUNK * d * 2
    assert lay["v"] == lay["k"] + n * chunk
    assert lay["xchg"] == lay["v"] + n * chunk
    assert lay["xchg"] % 16 == 0
    assert fa.EXCHANGE_BYTES == 2 * fa.KEY_CHUNK * fa.SHORT_CHUNK * 4
    assert lay["valid"] == lay["xchg"] + fa.EXCHANGE_BYTES
    assert lay["bars"] == lay["valid"] + n * 8
    plain_total = lay["bars"] + (1 + 4 * n) * 8
    if bias:
        assert lay["bias"] == plain_total
        assert lay["total"] == plain_total + 2 * n * fa.SHORT_CHUNK * 4
    else:
        assert lay["total"] == plain_total
    assert lay["total"] - lay["valid"] <= fa.HALVES_RESERVE
    assert lay["total"] <= fa.SMEM_LIMIT
    assert lay["total"] + 1024 <= 228 * 1024  # one block an SM
    assert lay["k"] + 2 * (n + 1) * chunk + fa.EXCHANGE_BYTES \
        + fa.HALVES_RESERVE > fa.SMEM_LIMIT
    assert [fa.stages(x) for x in fa.HALVES_HEAD_DIMS] == [4, 3, 2]


@pytest.mark.parametrize("d", fa.HALVES_HEAD_DIMS)
def test_halves_stages_mirror_the_kernels_formula(d):
    """halves_stages in csrc/flash_attention.cu, evaluated in Python over
    its own constants, gives stages(d)."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    body = re.search(r"constexpr int halves_stages\(int d\) \{\s*return "
                     r"([^;]*);", text).group(1)
    names = {"kSmemLimit": fa.SMEM_LIMIT,
             "kExchangeBytes": fa.EXCHANGE_BYTES,
             "kHalvesReserve": fa.HALVES_RESERVE,
             "halves_q_bytes": lambda d: d * fa.KEY_CHUNK * 2,
             "halves_chunk_bytes": lambda d: d * fa.SHORT_CHUNK * 2, "d": d}
    assert eval(body.replace("/", "//"), {}, names) == fa.stages(d)
    for fn, rows in (("halves_q_bytes", "hopper::chunk_bytes(d)"),
                     ("halves_chunk_bytes", "d * kShort * 2")):
        assert re.search(rf"constexpr int {fn}\(int d\) \{{ return "
                         rf"{re.escape(rows)}; }}", text), fn


def test_halves_threads_mirror_the_kernels_choice():
    """The producer warp's head dims and the block's threads, against
    halves_producer_warp and halves_threads in the source."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    below = re.findall(r"constexpr bool halves_producer_warp\(int d\) \{ "
                       r"return d < (\d+); \}", text)
    assert below == [str(fa.HALVES_PRODUCER_BELOW)]
    assert "return halves_producer_warp(d) ? kHalvesThreads : " \
        "kHalvesConsumers;" in text
    assert "constexpr int kHalvesConsumers = 2 * 128;" in text
    assert [fa.halves_threads(d) for d in fa.HALVES_HEAD_DIMS] == [288, 288,
                                                                   256]
    # one warp past two warpgroups: the block of a producer warp
    assert fa.HALVES_THREADS == 2 * 128 + 32


def test_smem_layout_leaves_room_for_two_blocks():
    # two blocks (plus the 1 KB each block reserves) must fit in the SM's
    # 228 KB at head dims 64 to 96; from 128 the block is built for one
    for d in fa.HEAD_DIMS:
        assert fa.min_blocks(d) * (fa.smem_layout(d)["total"] + 1024) \
            <= 228 * 1024
    assert [fa.min_blocks(d) for d in fa.HEAD_DIMS] == [2, 2, 2, 1, 1, 1,
                                                        1, 1]


def _swizzle_64b(addr):
    """hopper.cuh::swizzle_64b: address bits [4, 6) ^= bits [7, 9)."""
    return addr ^ (((addr >> 7) & 3) << 4)


@pytest.mark.parametrize("d", fa.F32_HEAD_DIMS)
def test_f32_smem_layout_keeps_tiles_on_the_swizzle_pattern(d):
    lay = fa.f32_smem_layout(d)
    cols = fa.box_cols(d)  # d 80 computes d 96's columns
    f32_chunk, tile = fa.KEY_CHUNK * cols * 4, fa.KEY_CHUNK * cols * 2
    q_boxes = fa.block_rows(128, d) // fa.KEY_CHUNK  # one per consumer
    f32_tiles = [lay["q"] + w * f32_chunk for w in range(q_boxes)]
    f32_tiles += [lay[a] + s * f32_chunk for a in ("kf", "vf")
                  for s in range(fa.F32_STAGES)]
    bf16_tiles = [lay[a] + s * tile for a in ("khi", "klo", "vhi", "vlo")
                  for s in range(fa.SPLIT_STAGES)]
    # TMA writes the f32 Q rows and chunks (128-byte aligned destinations);
    # the split writes and wgmma reads the bf16 tiles on the 64-byte swizzle,
    # from absolute address bits, so each starts on the 512-byte pattern (and
    # each 4 KB box of 64 rows x 32 columns on 4 KB)
    assert all(t % 128 == 0 for t in f32_tiles)
    assert all(t % 4096 == 0 for t in bf16_tiles)
    # areas in order, none overlapping the next
    assert lay["q"] == 0
    assert lay["q"] + q_boxes * f32_chunk <= lay["kf"]
    assert lay["kf"] + fa.F32_STAGES * f32_chunk <= lay["vf"]
    assert lay["vf"] + fa.F32_STAGES * f32_chunk <= lay["khi"]
    for a, b in (("khi", "klo"), ("klo", "vhi"), ("vhi", "vlo"),
                 ("vlo", "valid")):
        assert lay[a] + fa.SPLIT_STAGES * tile <= lay[b]
    assert lay["valid"] + fa.SPLIT_STAGES * 8 <= lay["bars"]
    assert lay["bars"] % 8 == 0
    assert lay["total"] == lay["bars"] + (2 * fa.F32_STAGES
                                          + 4 * fa.SPLIT_STAGES + 2) * 8
    assert lay["total"] <= fa.SMEM_LIMIT


@pytest.mark.parametrize("d", fa.F32_HEAD_DIMS)
def test_f32_split_writes_fill_the_tile_that_wgmma_reads(d):
    """split_chunk's reads and stores, mirrored: thread t takes columns
    4 (t % 8) .. + 3 of a 32-column box in rows t / 8 + 16 p of every box,
    reading 16 bytes of the row-major f32 chunk and writing 8 bytes to each
    bf16 tile at one swizzled offset plus box * 4 KB + p * 1 KB. Every
    element lands where TMA's 64-byte swizzle puts it in a bf16 chunk
    (which is where the K-major and MN-major descriptors read it), the
    stores cover the tile once, and the 16 threads of a half-warp store to
    32 distinct banks and the 8 of a quarter-warp read 128 contiguous
    bytes. At d 80 the split runs at d 96's width (box_cols)."""
    d = fa.box_cols(d)
    seen = np.zeros(fa.KEY_CHUNK * d * 2, np.int32)
    stores = {}
    for t in range(128):
        r, q = t >> 3, t & 7
        to = _swizzle_64b(r * 64 + q * 8)
        for box in range(d // 32):
            for p in range(fa.KEY_CHUNK // 16):
                row, col = r + 16 * p, box * 32 + 4 * q
                src = (r * d * 4 + q * 16) + p * 16 * d * 4 + box * 128
                # row-major f32, as TMA writes it
                assert src == (row * d + col) * 4
                off = to + box * 4096 + p * 1024
                assert off // 16 == (off + 7) // 16  # one swizzle unit
                for i in range(4):
                    c = col + i
                    assert off + 2 * i == (c // 32) * 4096 + _swizzle_64b(
                        row * 64 + (c % 32) * 2)
                seen[off:off + 8] += 1
                stores[(box, p, t)] = off
    assert (seen == 1).all()
    for (box, p, t), off in stores.items():
        if t % 16 == 0:  # a half-warp's sixteen 8-byte stores
            banks = {(stores[(box, p, u)] // 4 + w) % 32
                     for u in range(t, t + 16) for w in (0, 1)}
            assert len(banks) == 32


def test_f32_smem_layout_holds_one_block_an_sm():
    # one block a SM by registers (setmaxnreg hands the producer's to the
    # consumers), so the block may take all of the 227 KB
    for d in fa.F32_HEAD_DIMS:
        assert fa.f32_smem_layout(d)["total"] + 1024 <= 228 * 1024


@pytest.mark.parametrize("d", fa.F32_WIDE_HEAD_DIMS)
def test_f32_wide_layout_keeps_tiles_on_the_swizzle_pattern(d):
    lay = fa.f32_smem_layout(d)
    assert lay == fa.wide_smem_layout(d)
    keys, slots = fa.f32_chunk_keys(d), fa.wide_slots(d)
    q_tile, tile, piece = 64 * d * 2, keys * d * 2, keys * d * 4
    # the bf16 tiles: Q's boxes are 4 KB (64 rows), K's and V's keys * 64
    # bytes, each on the 64-byte swizzle's 512-byte pattern and on its size
    for area, size in (("qhi", q_tile), ("qlo", q_tile), ("khi", tile),
                       ("klo", tile), ("vhi", tile), ("vlo", tile)):
        box = (64 if area[0] == "q" else keys) * 64
        assert lay[area] % box == 0 and box % 512 == 0
        assert size % box == 0
    # TMA writes the f32 pieces: 32-column boxes of 128-byte rows
    assert all((lay["f32"] + s * piece) % 128 == 0 for s in range(slots))
    # areas in order, none overlapping the next
    order = [("qhi", q_tile), ("qlo", q_tile), ("khi", tile), ("klo", tile),
             ("vhi", tile), ("vlo", tile), ("f32", slots * piece),
             ("valid", 8), ("bars", slots * 8)]
    assert lay["qhi"] == 0
    for (a, size), (b, _) in zip(order, order[1:]):
        assert lay[a] + size == lay[b]
    assert lay["total"] == lay["bars"] + slots * 8
    assert lay["valid"] % 8 == 0 and lay["bars"] % 8 == 0


@pytest.mark.parametrize("bias", [False, True], ids=["plain", "biased"])
@pytest.mark.parametrize("d", fa.F32_WIDE_HEAD_DIMS)
def test_f32_wide_layouts_fit_a_block(d, bias):
    """Every wide layout, biased or not, fits in a block's 232,448 bytes
    with its ring of at least one f32 piece, at most WIDE_SLOTS_MAX, as
    many as fit (one more would not), and one block an SM."""
    lay = fa.f32_smem_layout(d, bias)
    slots, piece = fa.wide_slots(d), fa.f32_chunk_keys(d) * d * 4
    assert lay["total"] <= fa.SMEM_LIMIT
    assert lay["total"] + 1024 <= 228 * 1024
    assert 1 <= slots <= fa.WIDE_SLOTS_MAX
    assert (slots == fa.WIDE_SLOTS_MAX
            or lay["total"] + piece > fa.SMEM_LIMIT - fa.WIDE_RESERVE)
    assert [fa.wide_slots(x) for x in fa.F32_WIDE_HEAD_DIMS] == [4, 3, 1, 3, 1]
    assert 64 % fa.f32_chunk_keys(d) == 0  # Q's 64 rows are whole pieces
    if bias:  # one chunk's key biases after the mbarriers
        plain = fa.f32_smem_layout(d)
        assert lay["bias"] == plain["total"] and lay["bias"] % 8 == 0
        assert lay["total"] == plain["total"] + fa.f32_chunk_keys(d) * 4


@pytest.mark.parametrize("d", fa.F32_WIDE_HEAD_DIMS)
def test_f32_wide_split_writes_fill_the_tile_that_wgmma_reads(d):
    """split_rows, mirrored: item i = it * 256 + thread takes columns
    4 (i % 8) .. + 3 of row (i / 8) % rows of 32-column box (i / 8) / rows,
    reading 16 bytes of the f32 piece (boxes of rows x 128 bytes, as TMA
    writes them) and writing 8 bytes to each bf16 tile at box * tile rows *
    64 + swizzle((row0 + row) * 64 + (i % 8) * 8). Every element lands
    where TMA's 64-byte swizzle puts it in a bf16 chunk of the tile's rows
    (where the K-major and MN-major descriptors read it), the pieces of a
    K or V chunk and of Q's 64 rows (row0 = piece * rows) cover its tile
    once, a warp reads 512 contiguous bytes and its stores fill whole
    128-byte lines."""
    keys = rows = fa.f32_chunk_keys(d)
    items = rows * d // 4
    assert items % fa.WIDE_THREADS == 0
    for rows_in_tile in (keys, 64):
        seen = np.zeros(rows_in_tile * d * 2, np.int32)
        for piece in range(rows_in_tile // rows):
            row0 = piece * rows
            for it in range(items // fa.WIDE_THREADS):
                reads, stores = [], []
                for thread in range(fa.WIDE_THREADS):
                    i = it * fa.WIDE_THREADS + thread
                    q, r, box = i & 7, (i >> 3) % rows, (i >> 3) // rows
                    src = (box * rows + r) * 128 + q * 16
                    assert src == box * rows * 128 + (r * 32 + 4 * q) * 4
                    off = box * rows_in_tile * 64 + _swizzle_64b(
                        (row0 + r) * 64 + q * 8)
                    assert off // 16 == (off + 7) // 16  # one swizzle unit
                    for e in range(4):
                        c = box * 32 + 4 * q + e
                        assert off + 2 * e == (c // 32) * rows_in_tile * 64 \
                            + _swizzle_64b((row0 + r) * 64 + (c % 32) * 2)
                    seen[off:off + 8] += 1
                    reads.append(src)
                    stores.append(off)
                for w in range(0, fa.WIDE_THREADS, 32):
                    lo = min(reads[w:w + 32])
                    assert sorted(reads[w:w + 32]) == list(
                        range(lo, lo + 512, 16))
                    lines = {s // 128 for s in stores[w:w + 32]}
                    assert len(lines) == 2
        assert (seen == 1).all()


def test_f32_register_split_fills_the_register_file():
    text = (_build.CSRC / "flash_attention.cu").read_text()
    producer, consumer = (
        int(re.findall(rf"constexpr int {name} = (\d+);", text)[0])
        for name in ("kProducerRegs", "kConsumerRegs"))
    # setmaxnreg takes multiples of 8 in [24, 256]; a 384-thread block is
    # launched with 168 registers a thread (65,536 / 384, rounded down to 8),
    # and the two consumers take what the producer gives back
    for regs in (producer, consumer):
        assert regs % 8 == 0 and 24 <= regs <= 256
    assert producer + 2 * consumer == 3 * 168


@pytest.mark.parametrize("source,name,attr", [
    ("flash_attention.cu", "kFlashStages", "STAGES"),
    ("flash_attention.cu", "kFlashStagesWide", "WIDE_STAGES"),
    ("hopper.cuh", "kChunkRows", "KEY_CHUNK"),
    ("hopper.cuh", "kSmemLimit", "SMEM_LIMIT"),
    ("flash_attention.cu", "kF32Stages", "F32_STAGES"),
    ("flash_attention.cu", "kSplitStages", "SPLIT_STAGES"),
    ("hopper.cuh", "kShortChunkRows", "SHORT_CHUNK"),
    ("hopper.cuh", "kBoxCols", "BOX_COLS"),
    ("flash_attention.cu", "kWideThreads", "WIDE_THREADS"),
    ("flash_attention.cu", "kWideSlotsMax", "WIDE_SLOTS_MAX"),
    ("flash_attention.cu", "kWideReserve", "WIDE_RESERVE"),
    ("flash_attention.cu", "kHalvesThreads", "HALVES_THREADS"),
    ("flash_attention.cu", "kExchangeBytes", "EXCHANGE_BYTES"),
    ("flash_attention.cu", "kHalvesReserve", "HALVES_RESERVE"),
    ("flash_attention.cu", "kHalvesCluster", "HALVES_CLUSTER"),
    ("flash_attention.cu", "kHalvesClusterChunks", "HALVES_CLUSTER_CHUNKS"),
])
def test_smem_layout_mirrors_the_kernels_constants(source, name, attr):
    text = (_build.CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert found == [str(getattr(fa, attr))]


def _family_dims(text, family):
    """Head dims `family` in csrc/flash_attention.cu gives a Family."""
    dims = re.findall(rf"if \(([^)]*)\) return Family::{family};", text)
    assert len(dims) == 1, family
    return tuple(int(x) for x in re.findall(r"d == (\d+)", dims[0]))


def test_kernel_families_mirror_the_head_dims():
    """The C dispatch takes each dtype's head dims in the family the Python
    side names, and every switch over d launches an instantiation at that
    very d (its last case the family's last dim)."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    wgmma, halves = _family_dims(text, "kWgmma"), _family_dims(text, "kHalves")
    f32, wide = _family_dims(text, "kF32"), _family_dims(text, "kF32Wide")
    assert halves == fa.HALVES_HEAD_DIMS
    assert wgmma + halves == fa.HEAD_DIMS
    assert f32 == fa.F32_HEAD_DIMS and wide == fa.F32_WIDE_HEAD_DIMS
    assert tuple(sorted(f32 + wide)) == fa.HEAD_DIMS
    for case, d in re.findall(r"case (\d+): [^\n]*?<(\d+)", text):
        assert case == d
    for d, launched in re.findall(r"default: [^\n]*?<(\d+)>[^\n]*// family: d (\d+)", text):
        assert d == launched
    fwd = text[text.index("int zutis_flash_attention_fwd"):]
    for family, dims in (("wgmma", wgmma), ("halves", halves),
                         ("f32_wide", wide)):
        launched = re.findall(rf"launch_{family}<(\d+)>", fwd)
        assert tuple(int(x) for x in launched) == dims, family
    assert set(re.findall(r"launch_f32<(\d+), \d>", fwd)) == {
        str(d) for d in f32}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_kernel_input_check_takes_every_head_dim(d, dtype):
    q = torch.zeros(2, 8, 5, d, dtype=dtype)
    k = torch.zeros(2, 8, 7, d, dtype=dtype)
    fa.check_kernel_inputs(q, k, k, None)
    fa.check_kernel_inputs(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, k, torch.ones(2, 7, dtype=torch.int32))


@pytest.mark.parametrize("name", list(flash_f32_bench.ABLATIONS))
def test_f32_bench_ablations_still_match_the_source(name, tmp_path):
    """The measuring tool's edits apply to the kernel source as it stands
    (it raises on one that no longer matches)."""
    source = flash_f32_bench.ablated_sources(name, _build.CSRC,
                                             tmp_path / name)
    original = (_build.CSRC / "flash_attention.cu").read_text()
    assert source.read_text() != original
    assert (source.parent / "hopper.cuh").exists()


def test_f32_bench_timer_is_a_script_of_its_own():
    compile(flash_f32_bench.timer_script(), "timer", "exec")


def test_kernel_input_check_refuses_no_keys():
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at least one key"):
        fa.check_kernel_inputs(q, q[:, :, :0], q[:, :, :0], None)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,error,match", [
    ("rank 3", ValueError, "rank 4"),
    ("shape mismatch", ValueError, "shape mismatch"),
    ("head dim 32", ValueError, "head dim 32"),
    ("float16", TypeError, "bfloat16 or all float32"),
    ("mixed dtypes", TypeError, "bfloat16 or all float32"),
    ("head dim strided", ValueError, "contiguous"),
    ("row stride unaligned", ValueError, "16-byte"),
    ("address unaligned", ValueError, "16-byte"),
    ("mask shape", ValueError, "kv_mask"),
    ("batch over the grid", ValueError, "launch grid"),
    # no arch the factory knows gives these
    ("head dim 576", ValueError, "head dim 576 not supported by the kernel"),
    ("f32 head dim 32", ValueError, "head dim 32 not supported by the kernel"),
])
def test_kernel_input_check_refuses_what_the_kernels_do_not_take(
        case, error, match):
    q = k = v = _bf16(2, 2, 8, 64)
    mask = None
    if case == "rank 3":
        q = _bf16(2, 8, 64)
    elif case == "shape mismatch":
        k = _bf16(2, 3, 8, 64)
    elif case == "head dim 32":
        q = k = v = _bf16(2, 2, 8, 32)
    elif case == "float16":
        q = k = v = q.half()
    elif case == "mixed dtypes":
        k = k.float()
    elif case == "head dim strided":
        q = _bf16(2, 2, 64, 8).transpose(2, 3)
    elif case == "row stride unaligned":
        q = _bf16(2, 2, 8, 66)[..., :64]  # a 132-byte row step
    elif case == "address unaligned":
        q = _bf16(2 * 2 * 8 * 64 + 1)[1:].view(2, 2, 8, 64)
    elif case == "mask shape":
        mask = torch.ones(2, 9, dtype=torch.int32)
    elif case == "batch over the grid":
        q = k = v = _bf16(1, 2, 8, 64).expand(65536, 2, 8, 64)
    elif case == "head dim 576":
        q = k = v = _bf16(2, 2, 8, 576)
    elif case == "f32 head dim 32":
        q = k = v = _bf16(2, 2, 8, 32).float()
    with pytest.raises(error, match=match):
        fa.check_kernel_inputs(q, k, v, mask)
