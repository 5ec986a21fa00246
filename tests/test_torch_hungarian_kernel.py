"""The matcher kernel (csrc/hungarian.cu) against its plain version on the
card, and the wrapper's CPU route and the source's interface here.

The kernel has no CPU mode, so the tests that launch it are marked `cuda`
and skip without a card. The file imports no JAX, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_hungarian_kernel.py

The kernel runs the plain version's f32 operations in the same order with
no multiply to contract, so col4row must be equal bit for bit, also on
integer costs full of ties and on padded rows, at every number of columns
a lane holds (C = 1 to 1024); a cost set with NaN must terminate."""
import numpy as np
import pytest
import torch

from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import hungarian as hg

SETS = {  # name -> [P, R, C], as the training step's 48 problems of 10 x 100
    "random": (48, 10, 100),
    "ties": (48, 10, 100),
    "padded rows": (48, 10, 100),
    "square": (16, 33, 33),
    "wide": (8, 12, 1024),
    "large shared memory": (4, 64, 300),  # 80 KB: above the 48 KB default
    # every columns-per-lane instantiation (1, 2, 4, 8, 16, 32), square
    # problems among them
    "one column": (16, 1, 1),
    "square 31": (16, 31, 31),
    "33 columns": (16, 5, 33),
    "square 129": (4, 129, 129),
    "129 columns": (8, 10, 129),
    "1024 columns, 50 rows": (2, 50, 1024),  # 218 KB of shared memory
}


def make_set(name: str, seed: int = 0) -> torch.Tensor:
    shape = SETS[name]
    rng = np.random.RandomState(seed)
    if name == "ties":
        c = rng.randint(0, 4, shape).astype(np.float32)
    else:
        c = (rng.rand(*shape) * 3).astype(np.float32)
    if name == "padded rows":
        c[:, 4:] = 0.0
        c[::7] = 0.0
    return torch.from_numpy(c)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SETS))
def test_kernel_equals_plain_version(name):
    _needs_card()
    cost = make_set(name)
    before = hg.batched_hungarian.launches
    got = hg.batched_hungarian(cost.cuda())
    torch.cuda.synchronize()
    assert hg.batched_hungarian.launches == before + 1
    want = hg.batched_hungarian_reference(cost)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_terminates_on_nan():
    _needs_card()
    cost = make_set("random", seed=1)
    cost[0] = float("nan")
    cost[1, 2, 3] = float("nan")
    got = hg.batched_hungarian(cost.cuda())
    torch.cuda.synchronize()
    want = hg.batched_hungarian_reference(cost)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_refusals_on_the_card():
    _needs_card()
    with pytest.raises(TypeError, match="float32"):
        hg.batched_hungarian(torch.zeros(2, 3, 4, dtype=torch.float64, device="cuda"))
    with pytest.raises(ValueError, match="R <= C"):
        hg.batched_hungarian(torch.zeros(2, 5, 4, device="cuda"))
    with pytest.raises(ValueError, match="1024"):
        hg.batched_hungarian(torch.zeros(1, 2, 1025, device="cuda"))
    # 800 KB of shared memory a block: the launch itself refuses it
    with pytest.raises(RuntimeError, match="hungarian kernel launch failed"):
        hg.batched_hungarian(torch.zeros(1, 200, 1024, device="cuda"))
    cost = make_set("random")
    got = hg.batched_hungarian(cost.cuda())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), hg.batched_hungarian_reference(cost),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", list(SETS))
def test_cpu_tensors_take_the_plain_version(name):
    """A CPU tensor never launches; each problem's answer is a matching
    (distinct columns, all in range)."""
    cost = make_set(name)
    before = hg.batched_hungarian.launches
    got = hg.batched_hungarian(cost)
    assert hg.batched_hungarian.launches == before
    torch.testing.assert_close(got, hg.batched_hungarian_reference(cost),
                               rtol=0, atol=0)
    P, R, C = cost.shape
    assert got.shape == (P, R) and got.dtype == torch.int32
    assert bool(((got >= 0) & (got < C)).all())
    assert all(len(set(row.tolist())) == R for row in got)


def test_source_carries_its_note_and_c_interface():
    src = (_build.CSRC / "hungarian.cu").read_text()
    assert "zutis_tpu/ops/hungarian.py" in src and "Bound:" in src
    assert "int zutis_hungarian(" in src
    assert "one warp a problem" in src and "__syncthreads" not in src
    assert "const char* zutis_cuda_error_string(" in src
