"""The IoU kernel (csrc/mask_iou.cu) against its plain version on the card,
and the wrapper's CPU route, its refusals and the source's interface here.

The kernel has no CPU mode, so the tests that launch it are marked `cuda`
and skip without a card. The file imports no JAX, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_mask_iou_kernel.py

The kernel counts the intersections exactly in int32, as the JAX package's
int8 product does, and runs the plain version's f32 IoU operations in its
order, so its counts must equal the plain float64 product's and its IoU
and areas must be equal bit for bit; `mask_nms` on the kernel must then
keep the same masks with bit-equal scores as the plain IoU and rounds on
the same card tensors, for all three NMS types. The sets cover Q = 1, 37,
100, 128 (one output tile), 129, 300 and 1024 (tiles in pairs), b = 1, 8
and 32, K = 576 (serving), 327,680 (the eval bucket), K that are no
multiple of 16 (the per-image decode's 375 x 500; the rows then load
without TMA), a base address off 16 bytes, and empty and full masks."""
import math

import numpy as np
import pytest
import torch

from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import nms

SETS = {  # name -> (b, Q, H, W, storage offset in bytes)
    "serving": (8, 100, 24, 24, 0),
    "eval": (32, 100, 512, 640, 0),
    "per-image 375 x 500": (1, 100, 375, 500, 0),
    "q 1": (8, 1, 24, 24, 0),
    "q 37, b 32": (32, 37, 24, 24, 0),
    "q 128": (8, 128, 24, 24, 0),
    "q 129, K 391": (8, 129, 17, 23, 0),
    "q 300": (8, 300, 24, 24, 0),
    "q 300, eval K": (1, 300, 512, 640, 0),
    "q 1024": (1, 1024, 24, 24, 0),
    "q 1024, K 1147": (2, 1024, 31, 37, 0),
    "serving, base off 16 bytes": (8, 100, 24, 24, 1),
    "b 1, eval K": (1, 100, 512, 640, 0),
}
NMS_SETS = ["serving", "eval", "per-image 375 x 500", "q 300", "q 1024"]


def make_masks(name: str, device="cpu", seed: int = 0) -> torch.Tensor:
    """[b, Q, H, W] bool: seeded rectangles of a few to a third of the
    image's side, every seventh mask empty and every eleventh (from the
    third) full; with an offset, a view that starts that many bytes into
    its storage."""
    b, q, h, w, offset = SETS[name]
    rng = np.random.RandomState(seed)
    y0, x0 = rng.randint(0, h - 2, (b, q)), rng.randint(0, w - 2, (b, q))
    hs = rng.randint(2, max(3, h // 3), (b, q))
    ws = rng.randint(2, max(3, w // 3), (b, q))
    t = {k: torch.from_numpy(v).to(device)[..., None, None]
         for k, v in dict(y0=y0, x0=x0, y1=y0 + hs, x1=x0 + ws).items()}
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    masks = (ys >= t["y0"]) & (ys < t["y1"]) & (xs >= t["x0"]) & (xs < t["x1"])
    masks[:, ::7] = False
    masks[:, 3::11] = True
    if offset:
        storage = torch.zeros(masks.numel() + offset, dtype=torch.bool,
                              device=device)
        storage[offset:] = masks.flatten()
        masks = storage[offset:].view(masks.shape)
    return masks


def make_scores(b: int, q: int, device, seed: int = 1):
    """Scores [b, Q] f32 and category ids [b, Q] int64 over 4 categories (0
    the background), seeded."""
    rng = np.random.RandomState(seed)
    scores = torch.from_numpy(rng.rand(b, q).astype(np.float32)).to(device)
    cats = torch.from_numpy(rng.randint(0, 4, (b, q))).to(device)
    return scores, cats


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN's payload aside."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SETS))
def test_kernel_counts_and_iou_equal_the_plain_version(name):
    _needs_card()
    masks = make_masks(name, "cuda")
    before = nms.pairwise_iou.launches
    iou, areas, counts = nms.pairwise_iou_kernel(masks)
    torch.cuda.synchronize()
    assert nms.pairwise_iou.launches == before + 1
    want_counts = nms.intersection_counts_reference(masks)
    assert torch.equal(counts.long(), want_counts.long())
    want_iou, want_areas = nms.pairwise_iou_reference(masks)
    assert same_bits(iou, want_iou) and same_bits(areas, want_areas)
    # the same bits in every run: integer sums, in any order
    again = nms.pairwise_iou_kernel(masks)
    torch.cuda.synchronize()
    assert torch.equal(again[2], counts) and same_bits(again[0], iou)
    assert areas.min() == 0  # the empty masks
    if masks.shape[1] > 3:
        assert areas.max() == math.prod(masks.shape[2:])  # the full ones


@pytest.mark.cuda
@pytest.mark.parametrize("nms_type", nms.NMS_TYPES)
@pytest.mark.parametrize("name", NMS_SETS)
def test_mask_nms_on_the_kernel_keeps_the_plain_answer(name, nms_type):
    _needs_card()
    masks = make_masks(name, "cuda")
    scores, cats = make_scores(*masks.shape[:2], "cuda")
    before = (nms.pairwise_iou.launches, nms.mask_nms.launches)
    keep, out = nms.mask_nms(masks, scores, cats, nms_type=nms_type)
    torch.cuda.synchronize()
    assert (nms.pairwise_iou.launches, nms.mask_nms.launches) == (
        before[0] + 1, before[1] + 1)
    want_keep, want_out = nms.nms_rounds_reference(
        *nms.pairwise_iou_reference(masks), scores, cats, nms_type=nms_type)
    assert torch.equal(keep, want_keep) and same_bits(out, want_out)
    assert keep.any()


@pytest.mark.cuda
def test_counts_stay_exact_past_f32_and_up_to_int32():
    """Counts above 2^24 (where f32 stops holding every integer) equal the
    plain product's, and an all-ones mask of 2^31 - 1 pixels counts them
    all: on the rows' own loads (K odd) and on TMA (K a multiple of 16)."""
    _needs_card()
    k = 2**24 + 3
    masks = torch.ones(1, 2, k, dtype=torch.bool, device="cuda")
    masks[0, 1, :5] = False
    iou, areas, counts = nms.pairwise_iou_kernel(masks)
    want = nms.intersection_counts_reference(masks).long()
    assert torch.equal(counts.long(), want)
    assert counts[0].tolist() == [[k, k - 5], [k - 5, k - 5]]
    want_iou, want_areas = nms.pairwise_iou_reference(masks)
    assert same_bits(iou, want_iou) and same_bits(areas, want_areas)
    del masks, want
    for k in (nms.MAX_PIXELS, nms.MAX_PIXELS - 15):
        masks = torch.ones(1, 1, k, dtype=torch.bool, device="cuda")
        iou, areas, counts = nms.pairwise_iou_kernel(masks)
        assert counts.item() == k and areas.item() == np.float32(k)
        assert iou.item() == 1.0
        del masks
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_refusals_on_the_card():
    _needs_card()
    masks = make_masks("serving", "cuda")
    with pytest.raises(TypeError, match="bool"):
        nms.pairwise_iou(masks.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        nms.pairwise_iou(masks.transpose(2, 3))
    scores, cats = make_scores(8, 100, "cuda")
    with pytest.raises(ValueError, match="one device"):
        nms.mask_nms(masks, scores.cpu(), cats)
    # mask_nms reads a non-contiguous mask through its contiguous copy
    keep, out = nms.mask_nms(masks.transpose(2, 3), scores, cats)
    want_keep, want_out = nms.nms_rounds_reference(
        *nms.pairwise_iou_reference(masks.transpose(2, 3)), scores, cats)
    assert torch.equal(keep, want_keep) and same_bits(out, want_out)


@pytest.mark.parametrize("name", ["serving", "q 129, K 391", "q 1",
                                  "serving, base off 16 bytes"])
def test_cpu_tensors_take_the_plain_version(name):
    """A CPU tensor never launches; the plain counts equal numpy's integer
    product and its IoU numpy's f32 operations in the JAX package's order,
    bit for bit."""
    masks = make_masks(name)
    before = nms.pairwise_iou.launches
    iou, areas = nms.pairwise_iou(masks)
    assert nms.pairwise_iou.launches == before
    b, q = masks.shape[:2]
    m = masks.reshape(b, q, -1).numpy().astype(np.int64)
    counts = np.einsum("bqk,bpk->bqp", m, m)
    np.testing.assert_array_equal(
        nms.intersection_counts_reference(masks).long().numpy(), counts)
    inter = counts.astype(np.float32)
    a = np.diagonal(inter, axis1=1, axis2=2)
    union = (a[:, :, None] + a[:, None, :]) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.where(union > 0, inter / np.maximum(union, np.float32(1e-12)),
                        np.float32(0)).astype(np.float32)
    assert iou.dtype == torch.float32 and areas.dtype == torch.float32
    np.testing.assert_array_equal(iou.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(areas.numpy(), a)


def test_refusals_before_any_launch():
    """Dimensions, type, layout, Q > 1024, masks past 2^31 - 1 pixels and
    devices are refused from the tensors' metadata alone (meta tensors
    here); mask_nms refuses tensors on more than one device."""
    def meta(*shape, dtype=torch.bool):
        return torch.empty(*shape, dtype=dtype, device="meta")

    before = nms.pairwise_iou.launches
    with pytest.raises(ValueError, match=r"\[b, Q, \.\.\.\]"):
        nms.pairwise_iou(meta(5))
    with pytest.raises(TypeError, match="bool"):
        nms.pairwise_iou(meta(2, 5, 4, 4, dtype=torch.uint8))
    with pytest.raises(TypeError, match="bool"):
        nms.pairwise_iou(meta(2, 5, 4, 4, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        nms.pairwise_iou(meta(2, 5, 4, 4).transpose(2, 3))
    with pytest.raises(ValueError, match="at most 1024"):
        nms.pairwise_iou(meta(1, 1025, 4, 4))
    with pytest.raises(ValueError, match="pixels"):
        nms.pairwise_iou(meta(1, 2, 2**16, 2**15))
    with pytest.raises(ValueError, match="CUDA tensors"):
        nms.pairwise_iou(meta(2, 5, 4, 4))
    with pytest.raises(ValueError, match="one device"):
        nms.mask_nms(torch.zeros(1, 2, 3, 3, dtype=torch.bool),
                     meta(1, 2, dtype=torch.float32),
                     torch.zeros(1, 2, dtype=torch.int64))
    assert nms.pairwise_iou.launches == before


def test_source_carries_its_note_and_c_interface():
    src = (_build.CSRC / "mask_iou.cu").read_text()
    assert "zutis_tpu/ops/nms.py::mask_nms (:46-51)" in src
    assert "Bound: bytes" in src and "Launches:" in src
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in src
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in src and "__funnelshift_r" in src
    assert "atomicAdd(cnt" in src and "iou_kernel<<<" in src
    assert "int zutis_mask_iou(" in src
    assert "const char* zutis_cuda_error_string(" in src
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert nms.IOU_SOURCE.name == "mask_iou.cu"
    assert nms.MAX_PIXELS == 2**31 - 1
