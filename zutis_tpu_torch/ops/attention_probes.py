"""Attention-tuning probes: hand-written Hopper kernels
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
head dims 64 and 96, and `block_q` 64 or 128 (one or two consumer
warpgroups of 64 query rows). Both kernels run on Hopper's TMA, mbarriers
and wgmma and read q, k (or K^T) and v through tensor maps. `single` keeps
one head's K resident in shared memory beside its Q tile and a two-stage V
ring, so its sk is at most 1,536 at d = 64 and 896 at d = 96 with `block_q`
128 (1,600 and 960 with 64; `single_smem_bytes`). `fastsm` and `kt` share
one max-free kernel that streams K (or K^T) and V through a four-stage
ring (`maxfree_smem_layout`) and takes any sk >= 1. `single_occupancy` and
`maxfree_occupancy` report a kernel's shared memory and blocks per SM on
the card. `block_q` sets the query rows a block owns and does not change the
result. The plain versions also take f32. `launches` counts the kernels'
launches by C entry.
"""
from __future__ import annotations

import collections
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
KEY_TILE = 64      # keys per K/V chunk, and query rows per warpgroup
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
BLOCK_Q = (64, 128)  # one or two consumer warpgroups of 64 rows
HEAD_DIMS = (64, 96)  # the probe kernels' instantiations
# launches by C entry (zutis_probe_single, _fastsm, _kt), counted in _launch
launches: collections.Counter = collections.Counter()
SINGLE_V_STAGES = 2  # V chunks in `single`'s ring
MAXFREE_STAGES = 4   # K and V chunks each in the max-free kernel's ring
ONES_BYTES = 512     # the max-free kernel's tile of bf16 ones ("mxu" sum)


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
    fn = lib.zutis_probe_single_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn = lib.zutis_probe_maxfree_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2


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

def single_smem_bytes(sk: int, d: int, block_q: int = 128) -> int:
    """Dynamic shared memory of one `single` block: one head's K (sk rounded
    up to a 64-key chunk), the Q tile and SINGLE_V_STAGES V chunks, all
    64-key (or 64-row) chunks of d bf16 columns with no padding, then the
    mbarriers: a full and an empty one per K chunk, per Q and per V stage."""
    chunks = -(-sk // KEY_TILE)
    tiles = chunks + block_q // KEY_TILE + SINGLE_V_STAGES
    return tiles * KEY_TILE * d * 2 + (2 * chunks + 2 + 2 * SINGLE_V_STAGES) * 8


def maxfree_smem_layout(d: int, block_q: int = 128) -> dict:
    """Byte offsets into one `fastsm` or `kt` block's dynamic shared memory,
    as the kernel lays it out (maxfree_layout in csrc/attention_probes.cu):
    block_q / 64 Q chunks, MAXFREE_STAGES K chunks and MAXFREE_STAGES V
    chunks (each 64 rows, or keys, of d bf16 columns with no padding), the
    ONES_BYTES tile of ones, then the mbarriers: q_full and a full and an
    empty one per K and V stage. `total` is the block's size, whatever sk."""
    chunk = KEY_TILE * d * 2
    k = block_q // KEY_TILE * chunk
    v = k + MAXFREE_STAGES * chunk
    ones = v + MAXFREE_STAGES * chunk
    bars = ones + ONES_BYTES
    return dict(q=0, k=k, v=v, ones=ones, bars=bars,
                total=bars + (1 + 4 * MAXFREE_STAGES) * 8)


def check_kernel_inputs(q, k, v, block_q: int, family: str) -> None:
    """Raise on anything the probe kernels do not take: what
    `flash_attention.check_kernel_inputs` refuses (rank, shapes, head dims,
    devices, grid size, a head dim that is not contiguous, strides or
    addresses not 16-byte aligned), a head dim outside HEAD_DIMS (the flash
    kernels take more), and a dtype other than bf16, no keys, a
    `block_q` other than 64 or 128; for `single` also a block over the
    shared-memory limit (`fastsm` and `kt` stream K and V, so any sk
    fits)."""
    fa.check_kernel_inputs(q, k, v, None)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not supported by the probe "
                         f"kernels (supported: {HEAD_DIMS})")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"dtype {q.dtype}: the probe kernels take bfloat16")
    sk, d = k.shape[2], k.shape[3]
    if sk == 0:
        raise ValueError("the probes need at least one key")
    if block_q not in BLOCK_Q:
        raise ValueError(
            f"block_q {block_q!r}: {family} takes {BLOCK_Q} (one or two "
            "64-row warpgroups)")
    if family == "single" and single_smem_bytes(sk, d, block_q) > SMEM_LIMIT:
        raise ValueError(
            f"single keeps one head's K in shared memory: sk {sk} at d {d} "
            f"and block_q {block_q} needs {single_smem_bytes(sk, d, block_q)}"
            f" bytes, over {SMEM_LIMIT} (with block_q 128, sk <= 1536 at "
            "d 64 and <= 896 at d 96)")


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
    launches[name] += 1
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
    return _launch("zutis_probe_single", q, k, v, k.shape[2], block_q,
                   int(heads_per_cell != "grid"), EXP_MODES.index(exp_mode))


def single_occupancy(d: int, sk: int, block_q: int = 128,
                     heads_per_cell: str = "unroll",
                     exp_mode: str = "exp") -> tuple[int, int]:
    """(dynamic shared memory bytes, blocks per SM) of the `single` kernel
    that these arguments launch, from the current card's occupancy
    calculator."""
    _check_mode(heads_per_cell, HEADS_PER_CELL, "heads_per_cell")
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if heads_per_cell == "batched":
        exp_mode = "exp"
    lib = _build.load(SOURCE, STEM, _bind)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.zutis_probe_single_occupancy(
        d, sk, block_q, int(heads_per_cell != "grid"),
        EXP_MODES.index(exp_mode), ctypes.byref(smem), ctypes.byref(blocks))
    _build.check_launch(lib, err, "single occupancy")
    return smem.value, blocks.value


def maxfree_occupancy(d: int, block_q: int = 128, family: str = "fastsm",
                      sum_mode: str = "lane", exp_mode: str = "exp",
                      dots_only: bool = False) -> tuple[int, int]:
    """(dynamic shared memory bytes, blocks per SM) of the `fastsm` or `kt`
    kernel that these arguments launch (`kt` takes the lane sum), from the
    current card's occupancy calculator."""
    _check_mode(family, ("fastsm", "kt"), "family")
    _check_mode(sum_mode, SUM_MODES, "sum_mode")
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if family == "kt":
        sum_mode = "lane"
    lib = _build.load(SOURCE, STEM, _bind)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.zutis_probe_maxfree_occupancy(
        d, block_q, int(family == "kt"), SUM_MODES.index(sum_mode),
        EXP_MODES.index(exp_mode), int(dots_only and family == "kt"),
        ctypes.byref(smem), ctypes.byref(blocks))
    _build.check_launch(lib, err, f"{family} occupancy")
    return smem.value, blocks.value


def fastsm_attention(q, k, v, block_q=128, sum_mode="lane", exp_mode="exp"):
    """The `fastsm` probe on q, k, v [b, h, s, d] -> [b, h, sq, d]."""
    _check_mode(sum_mode, SUM_MODES, "sum_mode")
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if _on_cpu(q, "fastsm_attention"):
        return fastsm_attention_reference(q, k, v, sum_mode, exp_mode)
    check_kernel_inputs(q, k, v, block_q, "fastsm")
    return _launch("zutis_probe_fastsm", q, k, v, k.shape[2], block_q,
                   SUM_MODES.index(sum_mode), EXP_MODES.index(exp_mode))


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
    return _launch("zutis_probe_kt", q, kt, v, sk, block_q,
                   EXP_MODES.index(exp_mode), int(dots_only))


def kt_attention(q, k, v, block_q=128, exp_mode="exp", dots_only=False):
    """The `kt` probe on q, k, v [b, h, s, d] -> [b, h, sq, d]: one
    transposing copy of K, then the kernel."""
    _check_mode(exp_mode, EXP_MODES, "exp_mode")
    if _on_cpu(q, "kt_attention"):
        return kt_attention_reference(q, k, v, exp_mode, dots_only)
    check_kernel_inputs(q, k, v, block_q, "kt")
    return kt_attention_kernel(q, transpose_keys(k), v, block_q, exp_mode,
                               dots_only)
