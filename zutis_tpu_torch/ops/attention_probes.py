"""Attention-tuning probes: three hand-written Hopper kernel families
(csrc/attention_probes.cu) and their plain PyTorch versions.

They replace the Pallas probes of tools/pallas_tune.py, and each computes its
probe's function as the JAX `fn` does, wrapper and kernel together:

  - `single_attention` (make_single): the exact single-shot softmax over the
    whole key axis, with a row max. `heads_per_cell` picks the layout:
    "unroll" and "batched" blocks walk the heads of one (batch, q tile),
    "grid" blocks own one head. "batched" always takes `exp`, whatever
    `exp_mode` says: the JAX `kernel_batched` calls jnp.exp, not `_exp`
    (pallas_tune.py:88).
  - `fastsm_attention` (make_fastsm): the max-free clamped softmax,
    clip(s, -80, 80) and p = bf16(exp(s)), with the row sum on the vector
    unit ("lane") or as p @ ones on the matrix unit ("mxu").
  - `kt_attention` (make_kt): `fastsm` with the lane sum, reading K
    pre-transposed as [b, h, d, sk]; `dots_only` takes p = bf16(s), with no
    clamp and no bias, and l = 1.

All three pre-scale q by d^-1/2 in f32 and round it back to q's dtype, and
pad sk to a multiple of 128 with zero K/V rows and a bias on the padded keys
(-1e30 for single, -200 for the others). `exp_mode` picks the exponential:
"exp"; "mul", s * 1.0002, a timing probe under which the padded keys add to
the row sum, so the output depends on the padding; or "bf16", exp of s
rounded to bf16, rounded to bf16.

Each wrapper takes the plain version only for tensors that lie on the CPU.
For a CUDA tensor it launches its kernel or raises: the kernels take bf16 at
head dims 64 and 96 and `block_q` a multiple of 16 up to 128, and `single`
keeps one head's K and V in shared memory, so its sk is at most 768 at d = 64
and 512 at d = 96 (`single_smem_bytes`). `block_q` sets the query rows a
block owns and does not change the result. The plain versions also take f32.
Launch counts are the wrappers' `.launches`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import flash_attention as fa

SOURCE = _build.CSRC / "attention_probes.cu"
STEM = "libzutis_probes"
EXP_MODES = ("exp", "mul", "bf16")
HEADS_PER_CELL = ("unroll", "batched", "grid")
SUM_MODES = ("lane", "mxu")
KEY_PAD = 128      # the JAX fns pad sk to a multiple of this
KEY_TILE = 64      # keys per shared-memory tile in the kernels
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use


def build():
    """Compile the kernel library if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("zutis_probe_single", "zutis_probe_fastsm", "zutis_probe_kt"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]


def _check_mode(value: str, allowed: tuple, what: str) -> None:
    if value not in allowed:
        raise ValueError(f"{what} {value!r} not in {allowed}")


# ---------------------------------------------------------------- plain versions

def _exp(s: torch.Tensor, mode: str) -> torch.Tensor:
    """pallas_tune.py::_exp."""
    if mode == "mul":
        return s * 1.0002
    if mode == "bf16":
        return torch.exp(s.bfloat16()).float()
    return torch.exp(s)


def _prepare(q, k, v):
    """Pre-scaled q, K/V padded to a multiple of KEY_PAD keys, and the f32
    logits q k^T over the padded keys (products exact, sums in f32)."""
    q = (q.float() * q.shape[-1] ** -0.5).to(q.dtype)
    sk = k.shape[2]
    pad = -(-sk // KEY_PAD) * KEY_PAD - sk
    k, v = (F.pad(x, (0, 0, 0, pad)) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    return s, v, sk


def _bias(sk: int, sk_pad: int, value: float, device) -> torch.Tensor:
    return torch.where(torch.arange(sk_pad, device=device) < sk, 0.0, value)


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())


def single_attention_reference(q, k, v, heads_per_cell="unroll", exp_mode="exp"):
    """Plain version of the `single` probe (pallas_tune.py:54-111)."""
    _check_mode(heads_per_cell, HEADS_PER_CELL, "heads_per_cell")
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if heads_per_cell == "batched":
        exp_mode = "exp"  # kernel_batched calls jnp.exp (pallas_tune.py:88)
    s, v, sk = _prepare(q, k, v)
    s = s + _bias(sk, s.shape[-1], -1e30, s.device)
    p = _exp(s - s.amax(dim=-1, keepdim=True), exp_mode)
    l = p.sum(dim=-1, keepdim=True)
    return (_pv(p, v) / l).to(q.dtype)


def _maxfree(q, k, v, sum_mode, exp_mode, dots_only):
    s, v, sk = _prepare(q, k, v)
    if dots_only:
        return _pv(s, v).to(q.dtype)  # p = s in v's dtype, l = 1
    s = s.clamp(-80.0, 80.0) + _bias(sk, s.shape[-1], -200.0, s.device)
    p = _exp(s, exp_mode).to(v.dtype)
    if sum_mode == "mxu":  # p @ ones (pallas_tune.py:183-189)
        l = p.float() @ torch.ones(s.shape[-1], 1, device=s.device)
    else:
        l = p.float().sum(dim=-1, keepdim=True)
    return (_pv(p, v) / l).to(q.dtype)


def fastsm_attention_reference(q, k, v, sum_mode="lane", exp_mode="exp"):
    """Plain version of the `fastsm` probe (pallas_tune.py:173-212)."""
    _check_mode(sum_mode, SUM_MODES, "sum_mode")
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    return _maxfree(q, k, v, sum_mode, exp_mode, False)


def kt_attention_reference(q, k, v, exp_mode="exp", dots_only=False):
    """Plain version of the `kt` probe (pallas_tune.py:250-288). It takes K
    as [b, h, sk, d], as the JAX fn does; the transpose changes no value."""
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    return _maxfree(q, k, v, "lane", exp_mode, dots_only)


# ---------------------------------------------------------------- kernels

def single_smem_bytes(sk: int, d: int) -> int:
    """Shared memory of one `single` block: one head's K and V, sk rounded
    up to a 64-key tile, rows padded by 16 bytes, in bf16."""
    return 2 * (-(-sk // KEY_TILE) * KEY_TILE) * (d + 8) * 2


def check_kernel_inputs(q, k, v, block_q: int, family: str) -> None:
    """Raise on anything the probe kernels do not take: what
    `flash_attention.check_kernel_inputs` refuses (rank, shapes, head dims,
    devices, grid size, a head dim that is not contiguous, strides or
    addresses not 16-byte aligned), and a dtype other than bf16, no keys, a
    `block_q` that is not a multiple of 16 in [16, 128], and for `single` a
    head's K and V over the shared-memory limit."""
    fa.check_kernel_inputs(q, k, v, None)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"dtype {q.dtype}: the probe kernels take bfloat16")
    sk, d = k.shape[2], k.shape[3]
    if sk == 0:
        raise ValueError("the probes need at least one key")
    if not (isinstance(block_q, int) and 16 <= block_q <= 128
            and block_q % 16 == 0):
        raise ValueError(f"block_q {block_q!r}: a multiple of 16 in [16, 128]")
    if family == "single" and single_smem_bytes(sk, d) > SMEM_LIMIT:
        raise ValueError(
            f"single keeps one head's K and V in shared memory: sk {sk} at "
            f"d {d} needs {single_smem_bytes(sk, d)} bytes, over {SMEM_LIMIT} "
            "(sk <= 768 at d 64, <= 512 at d 96)")


def _on_cpu(q: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (take the plain version); False for CUDA;
    raises for any other device."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA, not {q.device}")
    return False


def _launch(name: str, q, k, v, sk: int, block_q: int, opt1: int, opt2: int):
    """Launch the C entry `name` on q, k (or K^T), v with its two mode
    arguments; returns the output."""
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = _build.load(SOURCE, STEM, _bind)
    bb, h, sq, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            bb, h, sq, sk, d, strides, d ** -0.5, block_q, opt1, opt2, stream)
    _build.check_launch(lib, err, name)
    return o


def single_attention(q, k, v, block_q=128, heads_per_cell="unroll",
                     exp_mode="exp"):
    """The `single` probe on q, k, v [b, h, s, d] -> [b, h, sq, d]."""
    _check_mode(heads_per_cell, HEADS_PER_CELL, "heads_per_cell")
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if _on_cpu(q, "single_attention"):
        return single_attention_reference(q, k, v, heads_per_cell, exp_mode)
    check_kernel_inputs(q, k, v, block_q, "single")
    if heads_per_cell == "batched":
        exp_mode = "exp"  # kernel_batched calls jnp.exp (pallas_tune.py:88)
    o = _launch("zutis_probe_single", q, k, v, k.shape[2], block_q,
                int(heads_per_cell != "grid"), EXP_MODES.index(exp_mode))
    single_attention.launches += 1
    return o


def fastsm_attention(q, k, v, block_q=128, sum_mode="lane", exp_mode="exp"):
    """The `fastsm` probe on q, k, v [b, h, s, d] -> [b, h, sq, d]."""
    _check_mode(sum_mode, SUM_MODES, "sum_mode")
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if _on_cpu(q, "fastsm_attention"):
        return fastsm_attention_reference(q, k, v, sum_mode, exp_mode)
    check_kernel_inputs(q, k, v, block_q, "fastsm")
    o = _launch("zutis_probe_fastsm", q, k, v, k.shape[2], block_q,
                SUM_MODES.index(sum_mode), EXP_MODES.index(exp_mode))
    fastsm_attention.launches += 1
    return o


def transpose_keys(k: torch.Tensor) -> torch.Tensor:
    """K [b, h, sk, d] as K^T [b, h, d, sk8] in one transposing copy, sk8 =
    sk rounded up to 8 with zero columns so that each row of K^T starts
    16-byte aligned. (The JAX fn transposes its keys after padding them to
    128, one XLA pass outside its kernel: pallas_tune.py:286.)"""
    b, h, sk, d = k.shape
    kt = k.new_empty(b, h, d, -(-sk // 8) * 8)
    kt[..., :sk].copy_(k.transpose(-1, -2))
    kt[..., sk:].zero_()
    return kt


def kt_attention_kernel(q, kt, v, block_q=128, exp_mode="exp",
                        dots_only=False):
    """The `kt` kernel alone, on CUDA tensors, with K^T from
    `transpose_keys`; its time excludes the transpose."""
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if q.device.type != "cuda":
        raise ValueError(f"kt_attention_kernel runs on CUDA, not {q.device}")
    check_kernel_inputs(q, v, v, block_q, "kt")
    b, h, sk, d = v.shape
    if (kt.shape != (b, h, d, -(-sk // 8) * 8) or not kt.is_contiguous()
            or kt.dtype != v.dtype or kt.device != v.device):
        raise ValueError(
            f"K^T {tuple(kt.shape)} {kt.dtype}: expected a contiguous "
            f"{(b, h, d, -(-sk // 8) * 8)} {v.dtype} from transpose_keys")
    o = _launch("zutis_probe_kt", q, kt, v, sk, block_q,
                EXP_MODES.index(exp_mode), int(dots_only))
    kt_attention.launches += 1
    return o


def kt_attention(q, k, v, block_q=128, exp_mode="exp", dots_only=False):
    """The `kt` probe on q, k, v [b, h, s, d] -> [b, h, sq, d]: one
    transposing copy of K, then the kernel."""
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if _on_cpu(q, "kt_attention"):
        return kt_attention_reference(q, k, v, exp_mode, dots_only)
    check_kernel_inputs(q, k, v, block_q, "kt")
    return kt_attention_kernel(q, transpose_keys(k), v, block_q, exp_mode,
                               dots_only)


single_attention.launches = 0
fastsm_attention.launches = 0
kt_attention.launches = 0
