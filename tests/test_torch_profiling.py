"""The port's tracing and numeric guards (zutis_tpu_torch/core/profiling.py),
the counterpart of tests/test_profiling.py: a trace writes its Chrome trace
with the annotated span; check_finite finds a NaN or an infinity in a
nested dict, a module's parameters, bf16 tensors and numpy arrays and names
its path, and passes finite and integer leaves; enable_debug_nans turns
autograd's anomaly detection on and off."""
import json

import numpy as np
import pytest
import torch

from zutis_tpu_torch.core import profiling as prof


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with prof.trace(str(tmp_path / "trace")):
        with prof.annotate("matmul"):
            x = torch.ones(64, 64)
            (x @ x).sum().item()
    with open(tmp_path / "trace" / prof.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_check_finite_names_the_leaf(dtype, bad):
    tree = {"a": torch.ones(3, dtype=dtype),
            "b": {"c": torch.tensor([1.0, bad], dtype=dtype)}}
    with pytest.raises(prof.NonFiniteError, match="'b/c'"):
        prof.check_finite(tree, where="unit-test")


def test_check_finite_catches_a_bf16_nan_scalar():
    with pytest.raises(prof.NonFiniteError, match="loss"):
        prof.check_finite({"loss": torch.tensor(float("nan"),
                                                dtype=torch.bfloat16)},
                          where="bf16-test")
    prof.check_finite({"ok": torch.tensor(1.5, dtype=torch.bfloat16)}, "ok")


def test_check_finite_walks_module_parameters():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    model.to(torch.bfloat16)
    prof.check_finite(model, "model")
    with torch.no_grad():
        model[1].bias[0] = float("nan")
    with pytest.raises(prof.NonFiniteError, match="'1.bias'"):
        prof.check_finite(model, "model")


def test_check_finite_reads_numpy_and_skips_integers():
    prof.check_finite({"a": np.ones(2), "i": np.arange(3),
                       "t": torch.arange(3), "l": [np.ones(1), 2]}, "ok")
    with pytest.raises(prof.NonFiniteError, match="'l/1'"):
        prof.check_finite({"l": [np.ones(1), np.array([np.nan])]}, "x")


def test_enable_debug_nans_switches_anomaly_detection():
    try:
        prof.enable_debug_nans()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
    finally:
        prof.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
