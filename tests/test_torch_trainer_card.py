"""The port's Trainer on the card: fit with checkpoints and the resume
after a kill, and a fit whose steps between log points wait for nothing.

The file imports no JAX, so that it runs on a machine with a card and no
JAX:

    python -m pytest --noconftest tests/test_torch_trainer_card.py

On the card, atomics in some backward passes (bilinear upsampling's, for
one) can make two identical runs differ, so the resumed run is held to the
spread of two straight runs (bit-equal if those are); on the CPU the resume
is bit-exact (tests/test_torch_trainer.py)."""
import numpy as np
import pytest
import torch

from zutis_tpu_torch.core.checkpoint import latest_step_dir, restore_train_state
from zutis_tpu_torch.engine.trainer import Trainer
from zutis_tpu_torch.engine.train_step import TrainState
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.ops import flash_attention as fa
from zutis_tpu_torch.ops import hungarian as hg

CFG = dict(width=128, encoder_layers=2, encoder_heads=2, patch_size=16,
           text_dim=32, n_queries=8, n_decoder_layers=2, n_heads=2,
           input_resolution=64)
N_CAT, H, N_ITERS = 5, 64, 6  # head dim 64, which the flash kernel takes
# the resumed run against the straight one, as a multiple of the spread of
# two straight runs
SPREAD_FACTOR = 4.0


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def batch_at(step: int) -> dict:
    rng = np.random.default_rng([11, step])
    inst = np.zeros((2, 3, H, H), np.float32)
    inst[:, 0, 8:40, 8:32] = 1
    inst[:, 1, 40:60, 30:60] = 1
    sem = np.zeros((2, H, H), np.int32)
    sem[inst[:, 0] > 0], sem[inst[:, 1] > 0] = 1, 2
    return {"image": rng.standard_normal((2, 3, H, H)).astype(np.float32),
            "instance_masks": inst,
            "instance_valid": np.array([[True, True, False]] * 2),
            "semantic_mask": sem}


def batches(start: int = 0):
    step = start
    while True:
        yield batch_at(step)
        step += 1


def _trainer(start_state=None):
    model = ZUTIS(**CFG, dtype=torch.bfloat16, device="cuda").init_params(
        torch.Generator().manual_seed(0))
    state = TrainState.create(model, base_lr=1e-3, n_iters=N_ITERS)
    if start_state is not None:
        state = restore_train_state(start_state, state)
    text = np.eye(N_CAT, CFG["text_dim"], dtype=np.float32)
    return Trainer(model, text, device="cuda"), state


def _run(n_iters, start_state=None, **fit_kw):
    trainer, state = _trainer(start_state)
    return trainer.fit(state, batches(state.step), n_iters=n_iters,
                       n_categories=N_CAT, **fit_kw)


def _max_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a.model.state_dict().values(),
                               b.model.state_dict().values()))


@pytest.mark.cuda
def test_resume_on_the_card_within_the_straight_runs_spread(tmp_path):
    _needs_card()
    fa.flash_attention.launches = hg.batched_hungarian.launches = 0
    straight = _run(N_ITERS)
    # 2 encoder layers, 2 decoder layers of self- and cross-attention
    assert fa.flash_attention.launches == 6 * N_ITERS
    assert hg.batched_hungarian.launches == N_ITERS
    again = _run(N_ITERS)
    _run(3, checkpoint_every=3, checkpoint_dir=str(tmp_path))
    resume_dir = latest_step_dir(str(tmp_path))
    assert resume_dir.endswith("step_3")
    trainer, state = _trainer(resume_dir)
    # restored onto the card, with AdamW's step counts on the host as in a
    # fresh optimiser: one on the card would be read back at every step
    assert next(state.model.parameters()).is_cuda
    for moments in state.optimizer.state.values():
        assert moments["exp_avg"].is_cuda and not moments["step"].is_cuda
    resumed = trainer.fit(state, batches(state.step), n_iters=N_ITERS,
                          n_categories=N_CAT)
    assert resumed.step == straight.step == N_ITERS
    spread = _max_diff(straight, again)
    diff = _max_diff(straight, resumed)
    if spread == 0.0:
        assert diff == 0.0
    else:
        assert diff <= SPREAD_FACTOR * spread, (diff, spread)


@pytest.mark.cuda
def test_fit_steps_between_log_points_do_not_sync():
    """iter_log 4: steps 1-3 and 5-7 run with the sync debug mode set to
    "error"; the lag-2 loss fetch and the device-side histogram make no
    synchronising call."""
    _needs_card()

    def guard(num_iter, _state):
        torch.cuda.set_sync_debug_mode(
            "default" if (num_iter + 1) % 4 == 0 else "error")

    trainer, state = _trainer()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.fit(state, batches(), n_iters=7, n_categories=N_CAT,
                    iter_log=4, eval_every_cb=guard)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step == 7
