"""The flash kernels' biased instantiations (flash_wgmma_bias_kernel and
flash_f32_bias_kernel in csrc/flash_attention.cu) against their plain
version on the card, and their shared-memory layouts on the CPU.

The file imports no JAX, so that it runs on a machine with a card and no
JAX (`python -m pytest --noconftest tests/test_torch_flash_bias_kernel.py`);
the plain versions are held to the JAX package in
tests/test_torch_key_bias.py. The launches are marked `cuda` and skip
without a card. The shapes are the levers' main-path calls: the ToMe
encoder at its first and last block (577 and 401 tokens, r 16), the padded
eval encoder under ToMe r 90 (1281 and 291 tokens) and the padded pooled
cross-attention (1280 pooled keys), each with a bias a key of log(size)
range. Tolerances as tests/test_torch_flash_kernel.py: bf16 8e-3 of the
largest |output|, f32 1e-4, split and unsplit; a masked key takes no
weight whatever its bias, and an item with no valid key comes out zero.
"""
import re

import numpy as np
import pytest
import torch

from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import flash_attention as fa

TOL_BF16 = 8e-3  # of the largest |output|
TOL_F32 = 1e-4
# name -> ([b, h, sq, sk, d], masked)
SHAPES = {
    "tome encoder first": ((8, 12, 577, 577, 64), False),
    "tome encoder last": ((8, 12, 401, 401, 64), False),
    "padded tome encoder first": ((32, 12, 1281, 1281, 64), True),
    "padded tome encoder last": ((32, 12, 291, 291, 64), True),
    "padded pooled cross": ((32, 8, 100, 1280, 96), True),
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _inputs(seed, shape, masked):
    """q, k, v as [b, h, s, d] views of [b, s, h, d] (the model's layout),
    key_bias [b, sk] in [0, 6], and a mask with item 1 all masked and
    item 0's masked keys given a large bias."""
    b, h, sq, sk, d = shape
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               .transpose(1, 2) for s in (sq, sk, sk))
    bias = (rng.rand(b, sk) * 6).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.rand(b, sk) > 0.3).astype(np.int32)
        mask[1] = 0
        bias[0, mask[0] == 0] = 50.0
        mask = torch.from_numpy(mask)
    return q, k, v, torch.from_numpy(bias), mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_cuda_biased_kernel_matches_reference(name, dtype):
    _needs_card()
    shape, masked = SHAPES[name]
    b, h, sq, sk, d = shape
    q, k, v, bias, mask = _inputs(11, shape, masked)
    q, k, v = (x.cuda().to(dtype) for x in (q, k, v))
    bias = bias.cuda()
    mask = None if mask is None else mask.cuda()
    want = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask,
                                        bias)
    tol = (TOL_BF16 * want.abs().max().item() if dtype == torch.bfloat16
           else TOL_F32)
    splits = ([None] if dtype == torch.bfloat16
              else [1, max(2, fa.key_splits(b, h, sq, sk, d))])
    for n in splits:
        before = (fa.flash_attention.launches,
                  fa.flash_attention.biased_launches)
        got = fa._flash_forward(q, k, v, mask, n, key_bias=bias)
        torch.cuda.synchronize()
        assert (fa.flash_attention.launches,
                fa.flash_attention.biased_launches) == (before[0] + 1,
                                                        before[1] + 1)
        assert got.stride() == q.stride()
        torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)
        if masked:
            assert (got[1] == 0).all()


@pytest.mark.cuda
def test_cuda_zero_bias_is_the_unbiased_kernel():
    _needs_card()
    q, k, v, bias, mask = _inputs(12, (4, 6, 200, 333, 64), True)
    q, k, v, mask = (x.cuda() for x in (q, k, v, mask))
    for dtype in (torch.bfloat16, torch.float32):
        args = [x.to(dtype) for x in (q, k, v)]
        plain = fa.flash_attention(*args, mask)
        zero = fa.flash_attention(*args, mask, torch.zeros_like(bias).cuda())
        torch.cuda.synchronize()
        tol = 1e-6 if dtype == torch.float32 else 2e-3 * plain.abs().max().item()
        torch.testing.assert_close(zero.float(), plain.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,block_q", [
    (torch.bfloat16, 64, 64), (torch.bfloat16, 96, 64),
    (torch.float32, 64, 128), (torch.float32, 64, 64), (torch.float32, 96, 64),
    (torch.bfloat16, 256, 64)])
def test_cuda_biased_occupancy(dtype, d, block_q):
    _needs_card()
    smem, blocks = fa.occupancy(d, dtype, block_q, bias=True)
    f32 = dtype == torch.float32
    lay = fa.f32_smem_layout(d, True) if f32 else fa.smem_layout(d, True)
    assert smem == lay["total"]
    # at least the unbiased kernel's: one f32 block an SM, two bf16 ones
    # (one at d 256)
    assert blocks >= (1 if f32 else fa.min_blocks(d))


# ---------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bias_ring_follows_the_unbiased_layout(d, f32):
    """The unbiased layout is unchanged and the bias ring (2 x stages slots
    of 64 f32) comes after its mbarriers. The f32 kernel has no d 256: its
    rings alone would not fit a block."""
    layout = fa.f32_smem_layout if f32 else fa.smem_layout
    stages = fa.SPLIT_STAGES if f32 else fa.stages(d)
    if f32 and d not in fa.F32_HEAD_DIMS:
        assert layout(d)["total"] > fa.SMEM_LIMIT
        return
    plain, biased = layout(d), layout(d, bias=True)
    assert {k: v for k, v in biased.items() if k not in ("bias", "total")} \
        == {k: v for k, v in plain.items() if k != "total"}
    assert biased["bias"] == plain["total"]
    assert biased["bias"] % 8 == 0  # 8-byte float2 reads, 4-byte stores
    assert biased["total"] == plain["total"] + 2 * stages * fa.KEY_CHUNK * 4
    assert biased["total"] <= fa.SMEM_LIMIT


def test_biased_layouts_keep_their_blocks_an_sm():
    for d in fa.HEAD_DIMS:
        # bf16: two blocks (one at d 256) and their 1 KB reserves in the
        # SM's 228 KB
        assert fa.min_blocks(d) * (fa.smem_layout(d, bias=True)["total"]
                                   + 1024) <= 228 * 1024
    for d in fa.F32_HEAD_DIMS:
        assert fa.f32_smem_layout(d, bias=True)["total"] + 1024 <= 228 * 1024


def test_bias_ring_mirrors_the_source():
    text = (_build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int bias_slots\(int stages\) \{ return 2 \* "
                     r"stages; \}", text)
    assert "constexpr int kBiasSlotBytes = kChunkRows * 4;" in text
    for kernel in ("flash_wgmma_bias_kernel", "flash_f32_bias_kernel"):
        assert re.search(rf"__global__ void __launch_bounds__\(.*\)\s+"
                         rf"{kernel}\(", text), kernel
