"""Batched Hungarian assignment (Jonker-Volgenant shortest augmenting path
with dual potentials): the hand-written CUDA kernel (csrc/hungarian.cu) and
its plain PyTorch version.

The port of zutis_tpu/ops/hungarian.py (`hungarian`, `batched_hungarian`),
which runs the matcher on the device inside the training step with two
`lax.while_loop`s. In eager PyTorch those data-dependent loops would need a
host sync per iteration, so on a card one kernel solves every problem, one
warp each, with no host round trip.

Rows are inserted one at a time; each insertion is a Dijkstra search over
reduced costs that adds one column per step (the unscanned column of least
`shortest`, lowest index on ties, as `jnp.argmin`) and stops at the first
unassigned column. Both loops keep the JAX package's iteration bounds (a
sink forced after C steps, the augment stopped after R + 1), so a cost
matrix with NaN terminates with a garbage assignment. Padded rows may hold
any constant cost: the matching of the other rows is then unchanged.

`batched_hungarian` takes the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from zutis_tpu_torch.ops import _build

SOURCE = _build.CSRC / "hungarian.cu"
STEM = "libzutis_hungarian"
MAX_COLS = 1024  # 32 columns a lane, in registers


def build():
    """Compile the kernel library if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def _bind(lib: ctypes.CDLL) -> None:
    lib.zutis_hungarian.restype = ctypes.c_int
    lib.zutis_hungarian.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A negative index counts from the end, as JAX's gathers and scatters
    read it (only garbage paths of a NaN cost reach one)."""
    return torch.where(idx < 0, idx + n, idx)


def batched_hungarian_reference(cost: torch.Tensor) -> torch.Tensor:
    """Plain version: cost [..., R, C] with R <= C -> col4row [..., R]
    int32, the JAX package's `hungarian` run on every problem at once with
    the same f32 operations in the same order."""
    R, C = cost.shape[-2:]
    if R > C:
        raise ValueError(f"hungarian expects R <= C, got {tuple(cost.shape)}")
    c = cost.reshape(-1, R, C).float()
    P, dev = c.shape[0], c.device
    ar = torch.arange(P, device=dev)
    cols = torch.arange(C, device=dev)
    rows = torch.arange(R, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    u = torch.zeros(P, R, device=dev)
    v = torch.zeros(P, C, device=dev)
    col4row = torch.full((P, R), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((P, C), -1, dtype=torch.int64, device=dev)
    for cur in range(R):
        shortest = torch.full((P, C), float("inf"), device=dev)
        path = torch.full((P, C), -1, dtype=torch.int64, device=dev)
        sc = torch.zeros(P, C, dtype=torch.bool, device=dev)
        sr = torch.zeros(P, R, dtype=torch.bool, device=dev)
        i = torch.full((P,), cur, dtype=torch.int64, device=dev)
        minval = torch.zeros(P, device=dev)
        active = torch.ones(P, dtype=torch.bool, device=dev)
        sink = torch.full((P,), -1, dtype=torch.int64, device=dev)
        it = 1
        while bool(active.any()):
            a = active[:, None]
            sr = sr | ((rows[None] == i[:, None]) & a)
            reduced = (minval[:, None] + c[ar, i]) - u[ar, i][:, None] - v
            better = (reduced < shortest) & ~sc & a
            shortest = torch.where(better, reduced, shortest)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(sc, inf, shortest)
            j = masked.argmin(dim=1)
            minval = torch.where(active, masked[ar, j], minval)
            sc = sc | ((cols[None] == j[:, None]) & a)
            nxt = row4col[ar, j]
            found = (nxt < 0) | (it >= C)
            sink = torch.where(active & found, j, sink)
            i = torch.where(active, nxt, i)
            active = active & ~found
            it += 1

        # dual updates
        u = u.clone()
        u[:, cur] = u[:, cur] + minval
        other = sr & (rows[None] != cur)
        delta_r = minval[:, None] - shortest.gather(1, _wrap(col4row, C))
        u = torch.where(other, u + delta_r, u)
        v = torch.where(sc, v - (minval[:, None] - shortest), v)

        # augment along the alternating path back to `cur`
        j, done, it = sink, torch.zeros(P, dtype=torch.bool, device=dev), 1
        while not bool(done.all()):
            act = ~done
            jw = _wrap(j, C)
            i = path[ar, jw]
            row4col[ar[act], jw[act]] = i[act]
            iw = _wrap(i, R)
            prev = col4row[ar, iw]
            col4row[ar[act], iw[act]] = j[act]
            done = done | (act & ((i == cur) | (it > R)))
            j = torch.where(act, prev, j)
            it += 1
    return col4row.to(torch.int32).reshape(cost.shape[:-1])


def batched_hungarian(cost: torch.Tensor) -> torch.Tensor:
    """cost [..., R, C] f32 -> col4row [..., R] int32: the column given to
    each row in a minimum-total-cost matching of the rows. The kernel
    launch count is `batched_hungarian.launches`."""
    if cost.device.type == "cpu":
        return batched_hungarian_reference(cost)
    if cost.device.type != "cuda":
        raise ValueError(f"batched_hungarian runs on CPU or CUDA, not {cost.device}")
    if cost.dim() < 2:
        raise ValueError(f"cost must be [..., R, C], got {tuple(cost.shape)}")
    R, C = cost.shape[-2:]
    if cost.dtype != torch.float32:
        raise TypeError(f"the matcher kernel takes float32 costs, not {cost.dtype}")
    if R > C:
        raise ValueError(f"hungarian expects R <= C, got {tuple(cost.shape)}")
    if C > MAX_COLS:
        raise ValueError(f"the matcher kernel takes at most {MAX_COLS} columns, got {C}")
    flat = cost.reshape(-1, R, C).contiguous()
    P = flat.shape[0]
    out = torch.empty(P, R, dtype=torch.int32, device=cost.device)
    if P == 0 or R == 0:
        return out.reshape(cost.shape[:-1])
    # a problem too large for one block's shared memory fails in the
    # launch's own cudaFuncSetAttribute, which check_launch raises
    lib = _build.load(SOURCE, STEM, _bind)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = lib.zutis_hungarian(flat.data_ptr(), out.data_ptr(), P, R, C, stream)
    _build.check_launch(lib, err, "hungarian")
    batched_hungarian.launches += 1
    return out.reshape(cost.shape[:-1])


batched_hungarian.launches = 0
