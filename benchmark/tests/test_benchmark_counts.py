"""The count file against PERF.md's bounds and against the products the
plain reference runs."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference import model as ref_model
from benchmark.reference.precision import Precision

VIT_B16 = dict(width=768, encoder_layers=12, encoder_heads=12, patch_size=16,
               text_dim=512, input_resolution=224, n_queries=100,
               n_decoder_layers=6, n_heads=8)


def test_attention_bound_of_the_serving_encoder():
    # PERF.md §6: [8,12,577,577,64] bf16, bound by its bytes
    assert counts.attention_bound_s(8, 12, 577, 577, 64) * 1e3 == \
        pytest.approx(0.0085, abs=5e-5)
    assert counts.forward_attention_bound_s(VIT_B16, 8, (24, 24)) * 1e3 == \
        pytest.approx(0.2162, abs=5e-5)


def test_iou_bound_of_the_eval_batch():
    # PERF.md §6: the eval's [32,100,512x640] masks once at 3.35 TB/s
    assert counts.iou_bound_s(32, 100, 512 * 640) * 1e3 == \
        pytest.approx(0.3134, abs=5e-5)


@pytest.mark.parametrize("grid,last", [((2, 3), True), ((3, 3), False)])
def test_forward_products_match_the_reference(grid, last):
    cfg = dict(width=64, encoder_layers=2, encoder_heads=2, patch_size=16,
               text_dim=32, input_resolution=32, n_queries=12,
               n_decoder_layers=2, n_heads=2)
    from benchmark import weights
    P = weights.make_weights(cfg, 1, "cpu")
    x = torch.randn(2, 3, 16 * grid[0], 16 * grid[1])
    with FlopCounterMode(display=False) as fc:
        ref_model.forward(x, P, cfg, Precision(), last_layer_only=last)
    got = counts.forward_flops(cfg, 2, grid, 1 if last else 2)
    h, w = grid
    upsample = 4.0 * 2 * (h * 2 * w + 4 * h * w) * cfg["width"]
    assert sum(got.values()) - upsample == pytest.approx(
        fc.get_total_flops(), rel=1e-9)


def test_train_step_counts_three_times_the_products():
    f = counts.train_step_flops(VIT_B16, 8, 384, 919, 10)
    fwd = sum(counts.forward_flops(VIT_B16, 8, (24, 24), 6).values())
    assert 2.9 * fwd < f["model"] < 3 * fwd
    # the text logits at label size dominate the criterion
    assert f["criterion"] > 4.0 * 8 * 384 * 384 * 512 * 919
