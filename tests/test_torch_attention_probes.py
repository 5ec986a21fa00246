"""The port's attention-tuning probes (zutis_tpu_torch.ops.attention_probes)
against the Pallas probes of tools/pallas_tune.py.

The JAX probes run on the CPU in TPU interpret mode; tools/pallas_tune.py is
loaded from its file as it stands. Its exp mode is a module global read at
trace time, and its dots-only switch an environment variable read when
`make_kt` builds the probe. The same numpy-seeded inputs go to both sides, at
ragged sizes: sq not a multiple of block_q and sk not a multiple of 128, so
that the padded keys' share of the row sum under "mul" shows.

Tolerances. Outputs are compared after dividing both sides by the largest
|output| where that is below 1: "mul" drives the single probe's output to
~1e-30, where an absolute tolerance would hold nothing.
  - f32 inputs: rtol 2e-4, atol 2e-5 (ROADMAP's parity tolerance; the two
    sides differ only in summation order).
  - bf16 inputs, and the "bf16" exp mode on either: rtol 2^-7 and atol 2^-8,
    one ulp of bf16's 8-bit mantissa. The mode rounds s to bf16 and every
    bf16 probe rounds p and the output, so a last-bit difference in an f32
    logit from summation order can flip one rounding.
The CUDA kernels need the card: tests/test_torch_probe_kernels.py holds
them against these plain versions there.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from zutis_tpu_torch.ops import attention_probes as ap

REPO = Path(__file__).resolve().parents[1]
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -8)
BLOCK_Q = 16
SHAPES = {  # [b, h, sq, sk, d]
    "f32": (2, 3, 40, 70, 96),
    "bf16": (2, 2, 37, 150, 64),
}
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}

# (family, layout or sum mode, exp mode, dots_only)
CASES = (
    [("single", hp, mode, False) for hp in ap.HEADS_PER_CELL
     for mode in ap.EXP_MODES]
    + [("fastsm", sm, mode, False) for sm in ap.SUM_MODES
       for mode in ap.EXP_MODES]
    + [("kt", None, mode, False) for mode in ap.EXP_MODES]
    + [("kt", None, "exp", True)]
)


@pytest.fixture(scope="module")
def pallas_tune():
    spec = importlib.util.spec_from_file_location(
        "pallas_tune_under_test", REPO / "tools" / "pallas_tune.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)]


def _jax_probe(pallas_tune, monkeypatch, family, option, mode, dots_only):
    monkeypatch.setattr(pallas_tune, "_EXP_MODE", mode)
    if family == "single":
        return pallas_tune.make_single(BLOCK_Q, option)
    if family == "fastsm":
        return pallas_tune.make_fastsm(BLOCK_Q, option)
    monkeypatch.setenv("TUNE_DOTS_ONLY", "1" if dots_only else "0")
    return pallas_tune.make_kt(BLOCK_Q)


def _torch_reference(family, option, mode, dots_only):
    if family == "single":
        return lambda q, k, v: ap.single_attention_reference(q, k, v, option, mode)
    if family == "fastsm":
        return lambda q, k, v: ap.fastsm_attention_reference(q, k, v, option, mode)
    return lambda q, k, v: ap.kt_attention_reference(q, k, v, mode, dots_only)


def _assert_close(got, want, tol):
    scale = min(1.0, float(np.abs(want).max()))
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family,option,mode,dots_only", CASES)
def test_reference_matches_pallas_probe(pallas_tune, monkeypatch, dtype,
                                        family, option, mode, dots_only):
    b, h, sq, sk, d = SHAPES[dtype]
    _, tdtype, jdtype = DTYPES[dtype]
    q, k, v = _inputs(0, b, h, sq, sk, d)
    fn = _jax_probe(pallas_tune, monkeypatch, family, option, mode, dots_only)
    with pltpu.force_tpu_interpret_mode():
        want = fn(*(jnp.asarray(x, jdtype) for x in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    got = _torch_reference(family, option, mode, dots_only)(
        *(torch.from_numpy(x).to(tdtype) for x in (q, k, v)))
    assert got.dtype == tdtype and got.shape == (b, h, sq, d)
    tol = F32 if dtype == "f32" and mode != "bf16" else BF16
    _assert_close(got.float().numpy(), want, tol)


def test_probes_in_exp_mode_are_softmax_attention_in_f32():
    """In f32 the probes differ from softmax attention only by where q is
    scaled and the order of sums: a few f32 ulps of the output."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 3, 40, 70, 96))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 96 ** -0.5
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
    for got in (ap.single_attention_reference(q, k, v),
                ap.fastsm_attention_reference(q, k, v, "mxu"),
                ap.kt_attention_reference(q, k, v)):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def test_mul_mode_counts_the_padded_keys_in_the_row_sum():
    """Under "mul" the row sum takes ceil(sk/128)*128 - sk padded keys, each
    adding its biased logit times 1.0002, as the kernels count them."""
    sk, n_pad = 70, 58
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 1, 2, 8, sk, 64))
    s = torch.einsum("bhqd,bhkd->bhqk", q * 0.125, k)
    p = s.clamp(-80, 80) * 1.0002
    l = p.sum(-1, keepdim=True) + n_pad * (-200.0 * 1.0002)
    torch.testing.assert_close(
        ap.fastsm_attention_reference(q, k, v, exp_mode="mul"), p @ v / l,
        rtol=1e-5, atol=1e-7)
    p = (s - s.amax(-1, keepdim=True)) * 1.0002
    l = p.sum(-1, keepdim=True) + n_pad * (-1e30 * 1.0002)
    got = ap.single_attention_reference(q, k, v, exp_mode="mul")
    assert got.abs().max() < 1e-27  # collapsed towards 0 by the padding
    torch.testing.assert_close(got / 1e-30, p @ v / l / 1e-30, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("wrapper,reference,kwargs", [
    (ap.single_attention, ap.single_attention_reference,
     dict(heads_per_cell="grid", exp_mode="bf16")),
    (ap.fastsm_attention, ap.fastsm_attention_reference,
     dict(sum_mode="mxu", exp_mode="mul")),
    (ap.kt_attention, ap.kt_attention_reference,
     dict(exp_mode="exp", dots_only=True)),
])
def test_wrapper_on_cpu_takes_the_plain_version(wrapper, reference, kwargs):
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(3, 1, 2, 20, 30, 64))
    before = wrapper.launches
    got = wrapper(q, k, v, 32, **kwargs)
    assert wrapper.launches == before
    torch.testing.assert_close(got, reference(q, k, v, *kwargs.values()),
                               rtol=0, atol=0)


@pytest.mark.parametrize("wrapper", [ap.single_attention, ap.fastsm_attention,
                                     ap.kt_attention])
def test_wrappers_refuse_other_devices_and_unknown_modes(wrapper):
    q = torch.zeros(1, 1, 16, 64, device="meta")
    with pytest.raises(ValueError):
        wrapper(q, q, q)
    q = torch.zeros(1, 1, 16, 64)
    with pytest.raises(ValueError):
        wrapper(q, q, q, exp_mode="exp2")


def test_kt_kernel_entry_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ap.kt_attention_kernel(q, ap.transpose_keys(q), q)


@pytest.mark.parametrize("shape,dtype,block_q,family,error", [
    ((1, 2, 16, 64), torch.float32, 128, "fastsm", TypeError),
    ((1, 2, 16, 64), torch.float16, 128, "kt", TypeError),
    ((1, 2, 16, 32), torch.bfloat16, 128, "single", ValueError),
    ((1, 2, 16, 128), torch.bfloat16, 128, "fastsm", ValueError),
    ((1, 2, 16, 64), torch.bfloat16, 24, "fastsm", ValueError),
    ((1, 2, 16, 64), torch.bfloat16, 0, "kt", ValueError),
    ((1, 2, 16, 64), torch.bfloat16, 144, "single", ValueError),
    ((1, 2, 769, 64), torch.bfloat16, 128, "single", ValueError),
    ((1, 2, 513, 96), torch.bfloat16, 64, "single", ValueError),
])
def test_kernel_input_check_rejects_what_the_kernels_do_not_take(
        shape, dtype, block_q, family, error):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(error):
        ap.check_kernel_inputs(q, q, q, block_q, family)


@pytest.mark.parametrize("sk,d", [(768, 64), (512, 96)])
def test_kernel_input_check_accepts_single_up_to_its_shared_memory_limit(sk, d):
    assert ap.single_smem_bytes(sk, d) <= ap.SMEM_LIMIT
    assert ap.single_smem_bytes(sk + 1, d) > ap.SMEM_LIMIT
    q = torch.zeros(1, 2, 16, d, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, sk, d, dtype=torch.bfloat16)
    ap.check_kernel_inputs(q, k, k, 16, "single")
    ap.check_kernel_inputs(q, torch.zeros(1, 2, 2 * sk, d, dtype=torch.bfloat16),
                           torch.zeros(1, 2, 2 * sk, d, dtype=torch.bfloat16),
                           128, "fastsm")  # streaming: no such limit


def test_transpose_keys_pads_rows_to_eight_keys_with_zeros():
    k = torch.from_numpy(_inputs(4, 2, 3, 5, 13, 64)[1]).bfloat16()
    kt = ap.transpose_keys(k)
    assert kt.shape == (2, 3, 64, 16) and kt.is_contiguous()
    assert torch.equal(kt[..., :13], k.transpose(-1, -2))
    assert (kt[..., 13:] == 0).all()
