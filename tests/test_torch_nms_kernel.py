"""The NMS kernel (csrc/nms.cu) against its plain version on the card, and
the wrapper's CPU route, its refusals and the source's interface here.

The kernel has no CPU mode, so the tests that launch it are marked `cuda`
and skip without a card. The file imports no JAX, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_nms_kernel.py

The kernel runs the plain version's f32 operations in the same order, so
`keep` must be equal and the scores bit-equal to the plain version run on
the same card tensors (NaN for NaN: a NaN's payload is not compared), for
all three NMS types, with tied scores, empty masks, category 0, an image
with no eligible candidate and NaN scores; at Q = 100 and 240 (the IoU
block in shared memory, by a bulk copy), Q = 37 (in shared memory by the
warp's loads: 4 Q^2 bytes are no multiple of 16), Q = 300 and 1024 (each
round's IoU row read from device memory), and b = 1, 8 and 32."""
import numpy as np
import pytest
import torch

from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import nms

SETS = {  # name -> (b, Q, side of the square masks)
    "random": (8, 100, 24),
    "ties": (8, 100, 24),
    "empty masks and category 0": (8, 100, 24),
    "no eligible candidate": (8, 100, 24),
    "nan score": (8, 100, 24),
    "b 1": (1, 100, 24),
    "b 32": (32, 100, 24),
    "q 37": (4, 37, 16),
    "q 240": (2, 240, 24),
    "q 300": (8, 300, 24),
    "q 1024": (2, 1024, 32),
}


def make_set(name: str, seed: int = 0):
    """(masks [b, Q, S, S] bool, scores [b, Q] f32, category_ids [b, Q]
    int64): overlapping rectangles, so that many pairs fall on either side
    of the threshold, over 4 categories (0 the background)."""
    b, q, side = SETS[name]
    rng = np.random.RandomState(seed)
    y0 = rng.randint(0, side - 4, (b, q))
    x0 = rng.randint(0, side - 4, (b, q))
    hs = rng.randint(3, side // 2, (b, q))
    ws = rng.randint(3, side // 2, (b, q))
    ys, xs = np.arange(side)[:, None], np.arange(side)[None, :]
    masks = ((ys >= y0[..., None, None]) & (ys < (y0 + hs)[..., None, None])
             & (xs >= x0[..., None, None]) & (xs < (x0 + ws)[..., None, None]))
    scores = rng.rand(b, q).astype(np.float32)
    scores[:, 5] = 0.0005  # below the floor from the start: still selectable
    cats = rng.randint(0, 4, (b, q)).astype(np.int64)
    if name == "ties":
        scores = rng.randint(0, 5, (b, q)).astype(np.float32) / 4
    if name == "empty masks and category 0":
        masks[:, ::3] = False
        cats[:, 1::4] = 0
    if name == "no eligible candidate":
        cats[0] = 0
        masks[1] = False
        cats[2, :] = 0
        cats[2, 7] = 2  # one eligible candidate alone
    if name == "nan score":
        scores[0, 10] = np.nan  # a live candidate: nothing is selected after
        cats[0, 10] = 1
        scores[1, 20] = np.nan
        cats[1, 20] = 0  # never live: the rest of the image is unaffected
        scores[2, 30] = np.nan
        masks[2, 30] = False
    return (torch.from_numpy(masks), torch.from_numpy(scores),
            torch.from_numpy(cats))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN's payload aside."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _rounds_inputs(name, device):
    masks, scores, cats = make_set(name)
    iou, areas = nms.pairwise_iou(masks.to(device))
    return iou, areas, scores.to(device), cats.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("nms_type", nms.NMS_TYPES)
@pytest.mark.parametrize("name", list(SETS))
def test_kernel_equals_plain_version(name, nms_type):
    _needs_card()
    inputs = _rounds_inputs(name, "cuda")
    before = nms.mask_nms.launches
    keep, out = nms.nms_rounds(*inputs, nms_type=nms_type)
    torch.cuda.synchronize()
    assert nms.mask_nms.launches == before + 1
    want_keep, want_out = nms.nms_rounds_reference(*inputs, nms_type=nms_type)
    assert torch.equal(keep, want_keep)
    assert same_bits(out, want_out)
    q = inputs[0].shape[1]
    assert nms.iou_in_shared_memory(q) == (q <= 240)


@pytest.mark.cuda
@pytest.mark.parametrize("nms_type", nms.NMS_TYPES)
def test_mask_nms_launches_once_and_keeps_the_plain_answer(nms_type):
    _needs_card()
    masks, scores, cats = make_set("random", seed=3)
    before = nms.mask_nms.launches
    keep, out = nms.mask_nms(masks.cuda(), scores.cuda(), cats.cuda(),
                             nms_type=nms_type)
    torch.cuda.synchronize()
    assert nms.mask_nms.launches == before + 1
    want_keep, want_out = nms.mask_nms(masks, scores, cats, nms_type=nms_type)
    assert nms.mask_nms.launches == before + 1  # the CPU never launches
    assert torch.equal(keep.cpu(), want_keep)
    torch.testing.assert_close(out.cpu(), want_out, rtol=1e-6, atol=0)
    assert keep.any() and keep.dtype == torch.bool


@pytest.mark.cuda
def test_kernel_refusals_on_the_card():
    _needs_card()
    iou, areas, scores, cats = _rounds_inputs("random", "cuda")
    with pytest.raises(TypeError, match="float32"):
        nms.nms_rounds(iou.double(), areas, scores, cats)
    with pytest.raises(TypeError, match="integers"):
        nms.nms_rounds(iou, areas, scores, cats.float())
    with pytest.raises(ValueError, match="1024"):
        z = torch.zeros(1, 1025, device="cuda")
        nms.nms_rounds(torch.zeros(1, 1025, 1025, device="cuda"), z, z,
                       z.long())
    with pytest.raises(ValueError, match="one device"):
        nms.nms_rounds(iou, areas.cpu(), scores, cats)
    keep, out = nms.nms_rounds(iou, areas, scores, cats.int())  # int32 ids
    want_keep, want_out = nms.nms_rounds_reference(iou, areas, scores, cats)
    assert torch.equal(keep, want_keep) and same_bits(out, want_out)


@pytest.mark.parametrize("nms_type", nms.NMS_TYPES)
@pytest.mark.parametrize("name", ["random", "no eligible candidate",
                                  "nan score", "q 37"])
def test_cpu_tensors_take_the_plain_version(name, nms_type):
    """A CPU tensor never launches; masks of category 0, empty masks and
    every candidate after a live NaN are never kept."""
    masks, scores, cats = make_set(name)
    before = nms.mask_nms.launches
    keep, out = nms.mask_nms(masks, scores, cats, nms_type=nms_type)
    assert nms.mask_nms.launches == before
    iou, areas = nms.pairwise_iou(masks)
    want_keep, want_out = nms.nms_rounds_reference(iou, areas, scores, cats,
                                                   nms_type=nms_type)
    assert torch.equal(keep, want_keep) and same_bits(out, want_out)
    assert keep.dtype == torch.bool and out.dtype == torch.float32
    assert not keep[(cats == 0) | (areas == 0)].any()
    if name == "no eligible candidate":
        assert not keep[:2].any() and keep[2].nonzero().flatten().tolist() == [7]
    if name == "nan score":
        assert not keep[0].any()  # the NaN wins round 0 and is never selected
        assert keep[1].any() and keep[2].any()


def test_refusals_before_any_launch():
    """Shapes, types, Q > 1024 and devices are refused from the tensors'
    metadata alone (meta tensors here); a bad NMS type on any device."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    iou, vec, cats = meta(2, 5, 5), meta(2, 5), meta(2, 5, dtype=torch.int64)
    with pytest.raises(ValueError, match="nms_type"):
        nms.nms_rounds(iou, vec, vec, cats, nms_type="soft")
    with pytest.raises(ValueError, match="nms_type"):
        nms.mask_nms(torch.zeros(1, 2, 3, 3), torch.zeros(1, 2),
                     torch.zeros(1, 2, dtype=torch.int64), nms_type="soft")
    with pytest.raises(ValueError, match=r"\[b, Q, Q\]"):
        nms.nms_rounds(meta(2, 5, 4), vec, vec, cats)
    with pytest.raises(ValueError, match="scores must be"):
        nms.nms_rounds(iou, vec, meta(2, 4), cats)
    with pytest.raises(TypeError, match="float32"):
        nms.nms_rounds(meta(2, 5, 5, dtype=torch.float16), vec, vec, cats)
    with pytest.raises(TypeError, match="floating point"):
        nms.nms_rounds(iou, vec, meta(2, 5, dtype=torch.int32), cats)
    with pytest.raises(TypeError, match="integers"):
        nms.nms_rounds(iou, vec, vec, meta(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="at most 1024"):
        nms.nms_rounds(meta(1, 1025, 1025), meta(1, 1025), meta(1, 1025),
                       meta(1, 1025, dtype=torch.int64))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nms.nms_rounds(iou, vec, vec, cats)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        nms.nms_rounds(torch.zeros(2, 5, 5), vec, vec, cats)


def test_source_carries_its_note_and_c_interface():
    src = (_build.CSRC / "nms.cu").read_text()
    assert "zutis_tpu/ops/nms.py" in src and "Bound:" in src
    assert "Early stop" in src and "__syncthreads" not in src
    assert "redux.sync" in src and "__reduce_max_sync" in src
    assert "int zutis_nms_rounds(" in src
    assert "int zutis_nms_iou_in_smem(" in src
    assert "const char* zutis_cuda_error_string(" in src
    assert nms.SOURCE.name == "nms.cu" and nms.MAX_Q == 1024


@pytest.mark.parametrize("name", ["nms_shuffle_max", "matcher_shuffle_min",
                                  "nms_warp_loads", "nms_device_rows",
                                  "nms_no_rounds", "matcher_no_rows",
                                  "iou_no_split", "iou_one_box"])
def test_selection_bench_ablations_still_match_the_source(name, tmp_path):
    """Each ablation of the selection tool edits one line that the source
    still holds, once."""
    from zutis_tpu_torch.tools import selection_bench as sb

    file, edits = sb.ABLATIONS[name]
    text = (_build.CSRC / file).read_text()
    for old, new in edits:
        assert text.count(old) == 1 and old != new
    edited = sb.ablated_source(name, _build.CSRC, tmp_path / name).read_text()
    assert edited != text and all(new in edited for _, new in edits)


def test_selection_bench_timer_script_compiles():
    import ast

    from zutis_tpu_torch.tools import selection_bench as sb

    tree = ast.parse(sb.timer_script())
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"measure", "kernel_times", "path_times", "device_ms"} <= defined
    assert set(sb.NMS_SHAPES) == {"serving [8,100]", "eval [32,100]"}
