"""The port's attention tuning tool (zutis_tpu_torch.tools.kernel_tune), the
counterpart of tools/pallas_tune.py's main(), run on the CPU at a small
shape. The kernels take the CPU tensors' plain versions there, so the tool's
control flow, result lines and error check are what is tested; its device
times come only from a card."""
import numpy as np
import pytest
import torch

from zutis_tpu_torch.tools import kernel_tune as kt

SMALL = (2, 3, 40, 70, 64)  # b, h, sq, sk, d: ragged against block_q and 128


def _result_lines(text):
    return [line for line in text.splitlines() if line.startswith("RESULT_")]


@pytest.mark.parametrize("variant", [v for v in kt.VARIANTS
                                     if v not in ("sdpa", "ship")])
def test_run_on_cpu_prints_the_three_result_lines(variant, capsys):
    res = kt.run(variant, 32, shape=SMALL, device="cpu")
    lines = _result_lines(capsys.readouterr().out)
    assert [line.split()[0] for line in lines] == [
        "RESULT_DISPATCH_OK", "RESULT_MAXERR", "RESULT_OK"]
    assert lines[0].startswith(f"RESULT_DISPATCH_OK sum={res['sum']:.3f} ")
    assert float(lines[1].split()[1]) == pytest.approx(res["max_err"], abs=1e-6)
    assert lines[2].startswith(f"RESULT_OK variant={variant} block_q=32 ms=")
    assert res["exact"] and res["max_err"] <= kt.TOL_BF16
    assert res["ms"] is None and res["shape"] == list(SMALL)


@pytest.mark.parametrize("variant,exp_mode,dots_only,exact", [
    ("single", "mul", False, False),
    ("batched", "mul", False, True),   # batched always takes exp
    ("fastsm-mxu", "bf16", False, True),
    ("kt", "exp", True, False),
])
def test_run_on_cpu_with_probe_modes(variant, exp_mode, dots_only, exact,
                                     capsys):
    res = kt.run(variant, 16, exp_mode, dots_only, shape=SMALL, device="cpu")
    assert len(_result_lines(capsys.readouterr().out)) == 3
    assert res["exact"] is exact
    if exact:
        assert res["max_err"] <= kt.TOL_BF16
    else:
        assert res["max_err"] > kt.TOL_BF16  # not softmax attention


def test_run_takes_given_inputs():
    q, k, v = kt.make_inputs(SMALL, "cpu")
    a = kt.run("fastsm-lane", 64, shape=SMALL, device="cpu")
    b = kt.run("fastsm-lane", 64, device="cpu", inputs=(q, k, v))
    assert a["sum"] == b["sum"] and b["shape"] == list(SMALL)


def test_make_inputs_follow_the_jax_tool():
    q, k, v = kt.make_inputs((1, 2, 3, 5, 64), "cpu")
    assert q.dtype == torch.bfloat16 and q.shape == (1, 2, 3, 64)
    assert k.shape == v.shape == (1, 2, 5, 64)
    rng = np.random.RandomState(0)
    rng.randn(1, 2, 3, 64)
    want_k = torch.from_numpy(rng.randn(1, 2, 5, 64).astype(np.float32))
    assert torch.equal(k, want_k.bfloat16())


def test_main_parses_the_command_line(monkeypatch):
    seen = {}
    monkeypatch.setattr(kt, "run", lambda *a, **kw: seen.update(a=a, kw=kw))
    kt.main(["single"])
    assert seen["a"] == ("single", 128, "exp", False)
    assert seen["kw"] == {"device": "cuda"}
    kt.main(["kt", "64", "--exp", "mul", "--dots-only", "--device", "cpu"])
    assert seen["a"] == ("kt", 64, "mul", True)
    assert seen["kw"] == {"device": "cpu"}
    for bad in (["xla"], ["single", "--exp", "exp2"], ["single", "--device", "tpu"]):
        with pytest.raises(SystemExit):
            kt.main(bad)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        kt.main(["single"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        kt.run("kt", shape=SMALL)


def test_bound_is_set_by_bytes_at_the_probe_shape():
    ms, by = kt.bound(*kt.SHAPE)
    # 227 MB of q, k, v and o at 3.35 TB/s; 65.5 GFLOP at 989 TFLOP/s
    assert by == "bytes" and ms == pytest.approx(0.0678, abs=1e-4)
    ms, by = kt.bound(8, 8, 100, 100, 96)
    assert by == "bytes"
    assert kt.bound(1, 1, 4096, 4096, 128)[1] == "operations"
