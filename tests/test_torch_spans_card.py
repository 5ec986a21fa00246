"""The training step's spans on the card: their device events time the
device, and the children of a step fit inside it. The test launches the
matcher kernel, which has no CPU mode, so it is marked `cuda` and skips
without a card. The file imports no JAX, so that it runs on a machine with
a card and no JAX:

    python -m pytest --noconftest tests/test_torch_spans_card.py
"""
import numpy as np
import pytest
import torch

from zutis_tpu_torch.core import profiling
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.models.zutis import ZUTIS

CFG = dict(width=64, encoder_layers=2, encoder_heads=1, patch_size=16,
           text_dim=32, n_queries=12, n_decoder_layers=2, n_heads=1,
           input_resolution=64, attn_impl="torch")
DEVICE_CHILDREN = ("train.forward", "train.criterion", "train.backward",
                   "train.optimizer")
STEPS = 3
SLACK_MS = 0.01  # elapsed_time's resolution, over a handful of intervals


def _batch(rng, b=2, size=64, n_max=4, n_cat=6):
    masks = np.zeros((b, n_max, size, size), np.float32)
    for j in range(3):
        masks[:, j, 16 * j:16 * j + 24, 8:40] = 1.0
    valid = np.zeros((b, n_max), bool)
    valid[:, :3] = True
    return {"image": rng.randn(b, 3, size, size).astype(np.float32),
            "instance_masks": masks, "instance_valid": valid,
            "semantic_mask": rng.randint(0, n_cat, (b, size, size)
                                         ).astype(np.int32)}


@pytest.mark.cuda
def test_step_spans_time_the_device_inside_the_step():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the matcher kernel has no CPU mode")
    torch.manual_seed(0)
    model = ZUTIS(**CFG, device="cuda").init_params()
    text = np.random.RandomState(0).randn(6, 32).astype(np.float32)
    state = TrainState.create(model, base_lr=1e-3, n_iters=2 * STEPS)
    step = make_train_step(model, text, 6, device="cuda")
    rng = np.random.RandomState(1)
    step(state, _batch(rng))  # builds and warms up, unrecorded
    torch.cuda.synchronize()
    profiling.clear()
    profiling.record_spans(True)
    try:
        for _ in range(STEPS):
            with profiling.span("whole step", device=True):
                step(state, _batch(rng))
    finally:
        profiling.record_spans(False)
    (session,) = profiling.sessions()
    spans = session["spans"]
    by_id = {s["id"]: s for s in spans}
    wholes = [s for s in spans if s["name"] == "whole step"]
    assert len(wholes) == STEPS
    for whole in wholes:
        (train_step,) = [s for s in spans if s["parent"] == whole["id"]]
        children = [s for s in spans if s["parent"] == train_step["id"]]
        device = [s for s in children if s["name"] in DEVICE_CHILDREN]
        assert sorted(s["name"] for s in device) == sorted(
            DEVICE_CHILDREN + ("train.optimizer",))
        for s in device:
            assert s["device_ms"] > 0, s["name"]
        assert sum(s["device_ms"] for s in device) <= (
            whole["device_ms"] + SLACK_MS)
        (upload,) = [s for s in children if s["name"] == "train.upload"]
        assert upload["device_ms"] is None
    for matcher in (s for s in spans if s["name"] == "train.matcher"):
        criterion = by_id[matcher["parent"]]
        assert criterion["name"] == "train.criterion"
        assert 0 < matcher["device_ms"] <= criterion["device_ms"] + SLACK_MS
    profiling.clear()
