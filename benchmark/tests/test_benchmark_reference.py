"""The plain reference against the port on the CPU at a tiny size, in
float32, where the two compute the same function and differ by rounding:
the forward, a training step's losses, gradients and updates and the
server's answers; COCO's RLE read back; and the instance checks on a
decode made by hand."""
import json

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import instances as ref_instances
from benchmark.reference import model as ref_model
from benchmark.reference.precision import Precision
from conftest import TINY_MODEL

SEED = 2**31 + 77


def cell_driver(tiny, name):
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    cell = harness.load_cell(spec, name, SEED, tiny)
    cell.device = torch.device("cpu")
    return harness.driver_for(cell, tiny).Driver(cell)


@pytest.mark.parametrize("last", [False, True])
def test_forward_matches_the_port(last):
    from zutis_tpu_torch.models.zutis import ZUTIS
    model = ZUTIS(**TINY_MODEL, device="cpu")
    weights.load_into(model, weights.make_weights(TINY_MODEL, SEED, "cpu"))
    P = weights.make_weights(TINY_MODEL, SEED, "cpu")
    x = torch.randn(2, 3, 80, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(x, inference=last)
        ref = ref_model.forward(x, P, TINY_MODEL, Precision(),
                                last_layer_only=last)
    for k in got:
        assert torch.allclose(got[k], ref[k], atol=2e-6), k


def test_training_steps_match_the_port(tiny):
    d = cell_driver(tiny, "tiny-train")
    d.setup()
    d.free()
    nums = d.numbers(d.readings, d.reference_readings(Precision()))
    assert nums["loss_gap"] < 1e-5 and nums["ce_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-3 and nums["update_gap"] < 1e-3


@pytest.mark.parametrize("cell", ["tiny-rate", "tiny-max"])
def test_answers_match_the_port(tiny, cell):
    from benchmark.tracing import Window
    d = cell_driver(tiny, cell)
    d.setup()
    d.run_window(Window(1.0))
    ids = d.sample()
    answers = d.program_answers(ids)
    nums = d.numbers(answers, d.reference_decodes(ids, Precision()))
    assert max(v for k, v in nums.items() if k.endswith("_gap")) < 1e-5, nums
    assert nums["kept_missed"] == 0
    assert nums["nms_overlap"] <= d.t["nms_threshold"]
    assert sum(len(a["instances"]) for a in answers.values()) > 0


def test_rle_read_back_equals_the_ports_codec():
    from zutis_tpu_torch.native import native_encode
    rng = np.random.default_rng(0)
    for h, w in [(1, 1), (37, 23), (48, 48), (375, 500)]:
        m = rng.random((h, w)) > rng.random()
        assert np.array_equal(ref_instances.rle_decode(native_encode(m), h, w),
                              m)


def _two_objects(q2_value=0.7, q2_shift=1):
    """A decode of three queries on an 8 x 8 grid: q0 the top-left block,
    q1 the bottom-right one (another category), q2 the top-left block
    shifted down by `q2_shift` rows at proposal `q2_value` (q0's category,
    overlapping it), with q0 and q1 what hard NMS keeps."""
    p = torch.full((3, 8, 8), 0.1)
    p[0, :4, :4] = 0.9
    p[1, 4:, 4:] = 0.9
    p[2, q2_shift:4 + q2_shift, :4] = q2_value
    tokens = torch.zeros(8, 8, 3)
    tokens[..., 1] = 1.0
    tokens[4:, 4:] = torch.tensor([0.0, 0.0, 1.0])
    text = torch.eye(3)
    ref = ref_instances.decode(p, tokens, text, 0.5, 20.0)
    kept = ref_instances.nms(ref["masks"], ref["score"], ref["category"], 0.3)
    return ref, kept


def _answer(ref, qs):
    return [{"category": int(ref["category"][q]),
             "score": float(ref["score"][q]),
             "mask": ref["masks"][q].numpy()} for q in qs]


def test_clearly_kept_instances_are_looked_for():
    ref, kept = _two_objects()
    assert sorted(kept) == [0, 1]
    assert sorted(ref_instances.clearly_kept(ref, kept, 0.3)) == [0, 1]
    sound = ref_instances.compare(_answer(ref, kept), ref, kept, 0.3)
    assert sound["kept_missed"] == 0 and sound["nms_overlap"] == 0
    assert sound["instance_gap"] < 1e-6
    # an answer short of one kept instance, as long as one remains
    short = ref_instances.compare(_answer(ref, [0]), ref, kept, 0.3)
    assert short["kept_missed"] == 1 and short["instance_gap"] < 1e-6


def test_an_nms_that_fails_to_suppress_reads_above_its_threshold():
    ref, kept = _two_objects()
    got = ref_instances.compare(_answer(ref, [0, 1, 2]), ref, kept, 0.3)
    assert got["nms_overlap"] == pytest.approx(12 / 20)
    assert got["kept_missed"] == 0


def test_a_near_tie_that_stands_in_is_not_missed():
    # q2 has q0's mask and a score within rounding of q0's: which of the
    # two NMS keeps is rounding's to decide, and either answer matches
    ref, kept = _two_objects(q2_value=0.899, q2_shift=0)
    assert 0 in ref_instances.clearly_kept(ref, kept, 0.3)
    swapped = ref_instances.compare(_answer(ref, [2, 1]), ref, kept, 0.3)
    assert swapped["kept_missed"] == 0
    # a rival with another mask and a near-tied score makes q0 unclear
    ref, kept = _two_objects(q2_value=0.899, q2_shift=1)
    assert 0 not in ref_instances.clearly_kept(ref, kept, 0.3)
