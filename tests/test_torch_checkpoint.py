"""The port's checkpoints (zutis_tpu_torch/core/checkpoint.py) and weight
export (zutis_tpu_torch/models/weights.py::export_params) at the tiny
setup of tests/test_checkpoint_resume.py:

  * export_params equals the JAX package's export_zutis for the same
    parameters: the same keys, every array bit-equal;
  * load_params_any reads a JAX-written .npz and a reference torch .pt into
    the same module as params_from_jax;
  * save_train_state then restore_train_state gives an equal state: every
    tensor of the model, the AdamW moments and the scheduler bit-equal, the
    step and the learning rates equal; nothing is left under a temporary
    name; latest_step_dir skips incomplete checkpoints."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.models.weights import export_zutis, save_torch_checkpoint
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.core import checkpoint
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.models.weights import export_params, load_params
from zutis_tpu_torch.models.zutis import ZUTIS

CFG = dict(width=32, encoder_layers=1, encoder_heads=2, patch_size=16,
           text_dim=16, n_queries=6, n_decoder_layers=2, n_heads=2,
           input_resolution=32)
N_CAT = 3


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JZUTIS(**CFG).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 3, 32, 32)))["params"])


def _model(params):
    return load_params(ZUTIS(**CFG, device="cpu"), params)


def test_export_params_equals_jax_export_zutis(params):
    got, want = export_params(_model(params)), export_zutis(params)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_export_params_is_a_copy(params):
    model = _model(params)
    exported = export_params(model)
    with torch.no_grad():
        model.query_embed.add_(1.0)
    np.testing.assert_array_equal(exported["query_embed"],
                                  params["query_embed"])


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_load_params_any_reads_jax_exports(params, tmp_path, fmt):
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "npz":
        np.savez(path, **export_zutis(params))
    else:
        save_torch_checkpoint(params, path)
    model = ZUTIS(**CFG, device="cpu")
    model.load_state_dict(checkpoint.load_params_any(path), strict=True)
    for name, value in _model(params).state_dict().items():
        torch.testing.assert_close(model.state_dict()[name], value, rtol=0,
                                   atol=0, msg=name)


def test_load_params_any_reads_a_wrapped_state_dict(params, tmp_path):
    model = _model(params)
    torch.save({"state_dict": model.state_dict(), "epoch": 3},
               tmp_path / "wrapped.pt")
    got = checkpoint.load_params_any(str(tmp_path / "wrapped.pt"))
    assert sorted(got) == sorted(model.state_dict())


def test_load_params_any_refuses_other_encoders(tmp_path):
    np.savez(tmp_path / "rn.npz", **{"__flax_raw__/encoder/conv1": np.ones(2)})
    with pytest.raises(NotImplementedError, match="item 7"):
        checkpoint.load_params_any(str(tmp_path / "rn.npz"))


def _trained_state(params, steps=2):
    model = _model(params)
    state = TrainState.create(model, base_lr=1e-3, n_iters=10)
    text = np.eye(N_CAT, 16, dtype=np.float32)
    step = make_train_step(model, text, N_CAT, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(steps):
        inst = np.zeros((2, 3, 32, 32), np.float32)
        inst[:, 0, 4:20, 4:16] = 1
        step(state, {"image": rng.randn(2, 3, 32, 32).astype(np.float32),
                     "instance_masks": inst,
                     "instance_valid": np.array([[True, False, False]] * 2),
                     "semantic_mask": (inst[:, 0] > 0).astype(np.int32)})
    return state


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (name, x), (_, y) in zip(a.model.state_dict().items(),
                                 b.model.state_dict().items()):
        torch.testing.assert_close(y, x, rtol=0, atol=0, msg=name)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for m, x in sa["state"][k].items():
            torch.testing.assert_close(sb["state"][k][m], x, rtol=0, atol=0)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert a.scheduler.get_last_lr() == b.scheduler.get_last_lr()


def test_save_then_restore_gives_an_equal_state(params, tmp_path):
    state = _trained_state(params)
    path = str(tmp_path / "step_2")
    checkpoint.save_train_state(path, state)
    assert os.listdir(path) == [checkpoint.STATE_FILE]
    fresh = TrainState.create(_model(params), base_lr=1e-3, n_iters=10)
    restored = checkpoint.restore_train_state(path, fresh)
    assert restored is fresh and restored.step == 2
    _assert_states_equal(state, restored)
    for moments in restored.optimizer.state.values():  # host step counts
        assert moments["step"].device.type == "cpu"
    # the restored state trains on as the saved one does
    _assert_states_equal(_trained_state(params, 3),
                         _continue(restored, params))


def _continue(state, params):
    text = np.eye(N_CAT, 16, dtype=np.float32)
    step = make_train_step(state.model, text, N_CAT, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(2):  # the batches of steps 1 and 2, then step 3's
        rng.randn(2, 3, 32, 32)
    inst = np.zeros((2, 3, 32, 32), np.float32)
    inst[:, 0, 4:20, 4:16] = 1
    step(state, {"image": rng.randn(2, 3, 32, 32).astype(np.float32),
                 "instance_masks": inst,
                 "instance_valid": np.array([[True, False, False]] * 2),
                 "semantic_mask": (inst[:, 0] > 0).astype(np.int32)})
    return state


def test_restore_returns_none_without_a_checkpoint(params, tmp_path):
    fresh = TrainState.create(_model(params), base_lr=1e-3, n_iters=10)
    assert checkpoint.restore_train_state(str(tmp_path / "missing"), fresh) is None
    assert checkpoint.latest_step_dir(str(tmp_path / "missing")) is None


def test_latest_step_dir_skips_incomplete_checkpoints(params, tmp_path):
    state = _trained_state(params, 1)
    for n in (2, 10):
        checkpoint.save_train_state(str(tmp_path / f"step_{n}"), state)
    os.makedirs(tmp_path / "step_12")  # killed before its file was renamed
    (tmp_path / "step_12" / f"{checkpoint.STATE_FILE}.123.tmp").write_bytes(b"")
    os.makedirs(tmp_path / "step_x")
    assert checkpoint.latest_step_dir(str(tmp_path)) == str(tmp_path / "step_10")
