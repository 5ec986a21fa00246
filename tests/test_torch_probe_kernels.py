"""The attention-probe kernels (csrc/attention_probes.cu) against their plain
versions on the card. The kernels have no CPU mode, so every test here is
marked `cuda` and skips without a card. The file imports no JAX, so that it
runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_probe_kernels.py

Inputs are numpy-seeded and bf16; both sides round p and the output to bf16
at the same places, but their f32 logits differ in summation order, so a
rounding of p can flip. Each output is therefore held to 2^-7 (one bf16 ulp)
relative and absolute after both sides are divided by the largest |output|:
the dots-only probe's outputs reach ~100, and "mul" drives single's to
~1e-30.
"""
import numpy as np
import pytest
import torch

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
                   make_inputs=_cuda_inputs):
    for shape in shapes:
        q, k, v = make_inputs(5, *shape)
        for kwargs in option_sets:
            before = wrapper.launches
            got = wrapper(q, k, v, 64, **kwargs)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
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


@pytest.mark.cuda
def test_cuda_fastsm_kernel_matches_reference_on_the_card():
    _check_on_card(ap.fastsm_attention, ap.fastsm_attention_reference,
                   [dict(sum_mode=sm, exp_mode=m)
                    for sm in ap.SUM_MODES for m in ap.EXP_MODES])


@pytest.mark.cuda
def test_cuda_kt_kernel_matches_reference_on_the_card():
    _check_on_card(ap.kt_attention, ap.kt_attention_reference,
                   [dict(exp_mode=m, dots_only=False) for m in ap.EXP_MODES]
                   + [dict(exp_mode="exp", dots_only=True)])


@pytest.mark.cuda
def test_cuda_single_layouts_are_bit_identical():
    q, k, v = _cuda_inputs(6, 2, 12, 577, 577, 64)
    unroll, batched, grid = (ap.single_attention(q, k, v, 128, hp)
                             for hp in ap.HEADS_PER_CELL)
    assert torch.equal(unroll, batched) and torch.equal(unroll, grid)
