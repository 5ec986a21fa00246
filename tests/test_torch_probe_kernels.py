"""The attention-probe kernels (csrc/attention_probes.cu) against their plain
versions on the card, and the max-free kernel's shared-memory layout on the
CPU. The kernels have no CPU mode, so the tests that launch them are marked
`cuda` and skip without a card. The file imports no JAX, so that it runs on
a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_probe_kernels.py

Inputs are numpy-seeded and bf16; both sides round p and the output to bf16
at the same places, but their f32 logits differ in summation order, so a
rounding of p can flip. Each output is therefore held to 2^-7 (one bf16 ulp)
relative and absolute after both sides are divided by the largest |output|:
the dots-only probe's outputs reach ~100, and "mul" drives single's to
~1e-30.
"""
import re

import numpy as np
import pytest
import torch

from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import attention_probes as ap


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)]


def _cuda_inputs(seed, b, h, sq, sk, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return [torch.from_numpy(x).cuda().bfloat16()
            for x in _inputs(seed, b, h, sq, sk, d)]


CUDA_SHAPES = [(2, 12, 577, 577, 64), (2, 3, 130, 260, 64), (2, 4, 100, 300, 96)]


def _check_on_card(wrapper, reference, option_sets, shapes=CUDA_SHAPES,
                   make_inputs=_cuda_inputs, block_q=64):
    for shape in shapes:
        q, k, v = make_inputs(5, *shape)
        for kwargs in option_sets:
            before = sum(ap.launches.values())
            got = wrapper(q, k, v, block_q, **kwargs)
            torch.cuda.synchronize()
            assert sum(ap.launches.values()) == before + 1
            want = reference(q, k, v, **kwargs).float()
            scale = want.abs().max().item()
            torch.testing.assert_close(got.float() / scale, want / scale,
                                       rtol=2 ** -7, atol=2 ** -7)


SINGLE_OPTIONS = [dict(heads_per_cell=hp, exp_mode=m)
                  for hp in ap.HEADS_PER_CELL for m in ap.EXP_MODES]


@pytest.mark.cuda
def test_cuda_single_kernel_matches_reference_on_the_card():
    _check_on_card(ap.single_attention, ap.single_attention_reference,
                   SINGLE_OPTIONS)


@pytest.mark.cuda
def test_cuda_single_kernel_takes_keys_beyond_its_old_limit():
    # sk 768 (d 64) and 512 (d 96) bounded the design that kept V resident
    _check_on_card(ap.single_attention, ap.single_attention_reference,
                   SINGLE_OPTIONS, shapes=[(2, 4, 130, 1000, 64),
                                           (1, 4, 100, 896, 96)])


def _strided_inputs(seed, b, h, sq, sk, d):
    """q, k, v made as [b, s, h, d] and passed as [b, h, s, d] views: the
    tensor maps take the caller's strides."""
    q, k, v = _cuda_inputs(seed, b, h, sq, sk, d)
    return [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]


@pytest.mark.cuda
def test_cuda_single_kernel_takes_strided_views():
    q, _, _ = _strided_inputs(5, 2, 3, 10, 20, 64)
    assert not q.is_contiguous() and q.stride(2) == 3 * 64
    _check_on_card(ap.single_attention, ap.single_attention_reference,
                   SINGLE_OPTIONS, shapes=[(2, 12, 577, 577, 64),
                                           (2, 4, 100, 300, 96)],
                   make_inputs=_strided_inputs)


@pytest.mark.cuda
def test_cuda_single_occupancy_reports_the_launched_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for d, sk, block_q in ((64, 577, 128), (96, 577, 128), (64, 1536, 64)):
        smem, blocks = ap.single_occupancy(d, sk, block_q)
        assert smem == ap.single_smem_bytes(sk, d, block_q)
        assert blocks >= 1


MAXFREE = {  # family -> (wrapper, plain version, every mode it takes)
    "fastsm": (ap.fastsm_attention, ap.fastsm_attention_reference,
               [dict(sum_mode=sm, exp_mode=m)
                for sm in ap.SUM_MODES for m in ap.EXP_MODES]),
    "kt": (ap.kt_attention, ap.kt_attention_reference,
           [dict(exp_mode=m, dots_only=False) for m in ap.EXP_MODES]
           + [dict(exp_mode="exp", dots_only=True)]),
}


@pytest.mark.cuda
def test_cuda_fastsm_kernel_matches_reference_on_the_card():
    for block_q in ap.BLOCK_Q:
        _check_on_card(*MAXFREE["fastsm"], block_q=block_q)


@pytest.mark.cuda
def test_cuda_kt_kernel_matches_reference_on_the_card():
    for block_q in ap.BLOCK_Q:
        _check_on_card(*MAXFREE["kt"], block_q=block_q)


@pytest.mark.cuda
def test_cuda_single_layouts_are_bit_identical():
    q, k, v = _cuda_inputs(6, 2, 12, 577, 577, 64)
    unroll, batched, grid = (ap.single_attention(q, k, v, 128, hp)
                             for hp in ap.HEADS_PER_CELL)
    assert torch.equal(unroll, batched) and torch.equal(unroll, grid)


# sk 1 and 65 leave a last chunk of one key and 63 that TMA fills with
# zeros, where s = 0 would give p = 1: only the kernel's zeroing of p at
# column >= sk keeps them out of P V and the row sum. sk 577 does the same
# with 63 keys at the tool's width. q, k, v are [b, s, h, d] views.
@pytest.mark.cuda
@pytest.mark.parametrize("block_q", ap.BLOCK_Q)
@pytest.mark.parametrize("family", sorted(MAXFREE))
@pytest.mark.parametrize("shape", [
    (2, 4, 100, 1, 64), (2, 4, 100, 65, 96), (1, 4, 130, 577, 64),
], ids=str)
def test_cuda_maxfree_keys_past_the_edge_get_no_weight(shape, family,
                                                        block_q):
    wrapper, reference, options = MAXFREE[family]
    _check_on_card(wrapper, reference, options, shapes=[shape],
                   make_inputs=_strided_inputs, block_q=block_q)


@pytest.mark.cuda
def test_cuda_maxfree_occupancy_reports_the_launched_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for d in (64, 96):
        for block_q in ap.BLOCK_Q:
            for family in MAXFREE:
                smem, blocks = ap.maxfree_occupancy(d, block_q, family)
                assert smem == ap.maxfree_smem_layout(d, block_q)["total"]
                assert blocks >= 1


# ---------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("block_q", ap.BLOCK_Q)
@pytest.mark.parametrize("d", (64, 96))
def test_maxfree_smem_layout_keeps_tiles_on_the_swizzle_pattern(d, block_q):
    lay = ap.maxfree_smem_layout(d, block_q)
    chunk = ap.KEY_TILE * d * 2
    tiles = ([lay["q"] + g * chunk for g in range(block_q // ap.KEY_TILE)]
             + [lay[area] + s * chunk for area in ("k", "v")
                for s in range(ap.MAXFREE_STAGES)])
    # TMA's and wgmma's 64-byte swizzle repeats every 512 bytes from
    # absolute address bits: every chunk, every 4 KB box of Q, K and V and
    # each [d, 32]-key box of K^T (d * 64 bytes) starts on that boundary
    assert all(t % 4096 == 0 for t in tiles)
    assert all((t + d * 64) % 512 == 0 for t in tiles)
    assert lay["ones"] % 512 == 0  # the ones tile: one 512-byte pattern
    # areas in order, none overlapping the next
    assert lay["q"] + block_q // ap.KEY_TILE * chunk <= lay["k"]
    assert lay["k"] + ap.MAXFREE_STAGES * chunk <= lay["v"]
    assert lay["v"] + ap.MAXFREE_STAGES * chunk <= lay["ones"]
    assert lay["ones"] + ap.ONES_BYTES <= lay["bars"]
    assert lay["total"] == lay["bars"] + (1 + 4 * ap.MAXFREE_STAGES) * 8
    assert lay["total"] <= ap.SMEM_LIMIT


def test_maxfree_smem_layout_leaves_room_for_two_64_row_blocks():
    # two block_q 64 blocks (plus the 1 KB each block reserves) fit in the
    # SM's 228 KB at both head dims, if the registers allow
    for d in (64, 96):
        assert 2 * (ap.maxfree_smem_layout(d, 64)["total"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("source,name,attr", [
    ("attention_probes.cu", "kMaxfreeStages", "MAXFREE_STAGES"),
    ("attention_probes.cu", "kVStages", "SINGLE_V_STAGES"),
    ("hopper.cuh", "kOnesBytes", "ONES_BYTES"),
    ("hopper.cuh", "kChunkRows", "KEY_TILE"),
    ("hopper.cuh", "kSmemLimit", "SMEM_LIMIT"),
])
def test_smem_layouts_mirror_the_kernels_constants(source, name, attr):
    text = (_build.CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert found == [str(getattr(ap, attr))]
