"""The fast bilateral solver that refines SelfMask's masks, in torch float64
on the device the caller names (the port of zutis_tpu/ops/bilateral.py).

Barron & Poole (ECCV 2016) as SelfMask's reference uses it: a 5-D
(x, y, luma, u, v) bilateral grid over the image, the mask and a constant
confidence splatted into it, (lam * smoothness + data) y = splat(w * t)
solved by Jacobi-preconditioned CG, the result sliced back to the pixels,
then thresholded at 0.5, its holes filled, and the second-largest
4-connected component kept (the largest is the background). Parameters are
the reference call's: sigma_spatial 16, sigma_luma 16, sigma_chroma 8, lam
256, 25 CG iterations at rtol 1e-5, confidence 0.999.

It reproduces the JAX package's host solver (numpy, scipy.sparse and
scipy.ndimage) step for step, so that its soft output agrees to ~1e-14 and
its masks are equal:
  - The grid's cells are computed on the host with the reference's own
    numpy expression (`grid_keys`): another summation order of the RGB ->
    YUV product moves colours across a cell edge, and a card's DGEMM does
    not give numpy's bits. Only the int64 keys go to the device.
  - Vertices are the sorted unique keys. A neighbour one cell away along
    dimension d is the key +- 256**d: the reference adds the offset to the
    vertex's coordinates and packs them again, and packing is linear and
    exact in int64, so the two are the same integer. Neighbours are found
    once by `searchsorted`; the blur is gathers, each dimension's (-1, then
    +1) neighbour sum added in dimension order, as scipy's CSR rows sum.
  - The splat is an `index_add_`. The path only splats values in {0, c}
    for one c at a time, whose sums come out the same in any order, so a
    card's atomics give scipy's bits.
  - The CG is scipy's loop (scipy/sparse/linalg/_isolve/iterative.py,
    `cg`): atol = rtol * |b|, b itself when |b| == 0, r = b - A x0 only if
    x0 has a nonzero, the residual test at the top of each iteration. Each
    test reads one norm back to the host.
  - The final choice is made on the host (`refine_mask`): threshold, the
    C++ hole fill and labelling of `native/labels.py` (scipy.ndimage's
    results), the component sizes through `np.argsort` with its default
    kind, so that ties fall as the reference's do.
Dot products and norms sum in torch's order, not BLAS's, and torch's
float64 sqrt on the CPU is not correctly rounded (numpy's and CUDA's are):
that is where the soft outputs part, by a few 1e-15.

The JAX package's device solver (zutis_tpu/ops/bilateral_device.py, which
agrees with the host solver to 0.96 IoU) has no counterpart: this function
on a CUDA tensor is the solve on the accelerator.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from zutis_tpu_torch.core.device import resolve_device
from zutis_tpu_torch.native import labels

_RGB2YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168736, -0.331264, 0.5],
     [0.5, -0.418688, -0.081312]]
)
_YUV_OFFSET = np.array([0.0, 128.0, 128.0])
DIM = 5  # x, y, luma, u, v


def grid_keys(image: np.ndarray, sigma_spatial: float = 16,
              sigma_luma: float = 16, sigma_chroma: float = 8) -> np.ndarray:
    """[H, W, 3] RGB -> each pixel's grid cell packed into one int64 key
    (base 256, x first), on the host with the reference's numpy arithmetic."""
    im = np.asarray(image, np.float64)
    yuv = im @ _RGB2YUV.T + _YUV_OFFSET
    h, w = im.shape[:2]
    ys, xs = np.mgrid[:h, :w]
    coords = np.stack([
        (xs / sigma_spatial).astype(np.int64).ravel(),
        (ys / sigma_spatial).astype(np.int64).ravel(),
        (yuv[..., 0] / sigma_luma).astype(np.int64).ravel(),
        (yuv[..., 1] / sigma_chroma).astype(np.int64).ravel(),
        (yuv[..., 2] / sigma_chroma).astype(np.int64).ravel(),
    ], axis=1)  # [npix, 5]
    return coords @ (256 ** np.arange(DIM))


class BilateralGrid:
    """Splat, blur and slice over the grid's occupied vertices, on
    `device`."""

    def __init__(self, image: np.ndarray, sigma_spatial: float = 16,
                 sigma_luma: float = 16, sigma_chroma: float = 8,
                 device="cuda"):
        self.device = resolve_device(device)
        keys = torch.from_numpy(grid_keys(
            image, sigma_spatial, sigma_luma, sigma_chroma)).to(self.device)
        self.npixels, self.dim = keys.numel(), DIM
        uniq, self.inverse = torch.unique(keys, sorted=True,
                                          return_inverse=True)
        self.nvertices = uniq.numel()
        # per dimension, the (-1, +1) neighbours: (position, found)
        self._neighbours = []
        for d in range(self.dim):
            pair = []
            for offset in (-1, 1):
                nb = uniq + offset * 256 ** d
                pos = torch.searchsorted(uniq, nb).clamp_(
                    0, self.nvertices - 1)
                pair.append((pos, uniq[pos] == nb))
            self._neighbours.append(pair)

    def splat(self, x: torch.Tensor) -> torch.Tensor:
        """[npix, ...] -> [nvertices, ...]: each vertex's pixels summed."""
        out = torch.zeros((self.nvertices, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, self.inverse, x)

    def slice(self, y: torch.Tensor) -> torch.Tensor:
        return y[self.inverse]

    def blur(self, x: torch.Tensor) -> torch.Tensor:
        """[nvertices] -> 2 * dim * x plus every neighbour's value."""
        out = 2 * self.dim * x
        for (pos_lo, hit_lo), (pos_hi, hit_hi) in self._neighbours:
            out = out + (torch.where(hit_lo, x[pos_lo], 0.0)
                         + torch.where(hit_hi, x[pos_hi], 0.0))
        return out


def _bistochastize(grid: BilateralGrid, maxiter: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The diagonals (n, m) of the normalisation Dn, Dm."""
    m = grid.splat(torch.ones(grid.npixels, dtype=torch.float64,
                              device=grid.device))
    n = torch.ones(grid.nvertices, dtype=torch.float64, device=grid.device)
    for _ in range(maxiter):
        n = torch.sqrt(n * m / grid.blur(n))
    return n, n * grid.blur(n)


def _cg(matvec, psolve, b: torch.Tensor, x0: torch.Tensor, rtol: float,
        maxiter: int) -> torch.Tensor:
    """scipy.sparse.linalg.cg(A, b, x0=x0, M=M, maxiter, rtol), its loop."""
    bnrm2 = float(torch.linalg.vector_norm(b))
    atol = max(0.0, rtol * bnrm2)
    if bnrm2 == 0:
        return b
    x = x0.clone()
    r = b - matvec(x) if bool(x.any()) else b.clone()
    rho_prev = p = None
    for iteration in range(maxiter):
        if float(torch.linalg.vector_norm(r)) < atol:
            return x
        z = psolve(r)
        rho_cur = torch.dot(r, z)
        if iteration > 0:
            beta = rho_cur / rho_prev
            p *= beta
            p += z
        else:
            p = z.clone()
        q = matvec(p)
        alpha = rho_cur / torch.dot(p, q)
        x += alpha * p
        r -= alpha * q
        rho_prev = rho_cur
    return x


def solve(
    grid: BilateralGrid,
    target: torch.Tensor,  # [npix, k] float64
    confidence: torch.Tensor,  # [npix, 1] float64
    lam: float = 256.0,
    a_diag_min: float = 1e-5,
    cg_tol: float = 1e-5,
    cg_maxiter: int = 25,
) -> torch.Tensor:
    """The solver's output sliced back to the pixels: [npix, k] float64."""
    n_vec, m_vec = _bistochastize(grid)
    w_splat = grid.splat(confidence)
    a_diag = torch.clamp(
        lam * (m_vec - n_vec * (2 * grid.dim) * n_vec) + w_splat[:, 0],
        min=a_diag_min)

    def a_mv(y):
        # lam * (Dm y - Dn blur(Dn y)) + w y, matrix-free
        smooth = lam * (m_vec * y - n_vec * grid.blur(n_vec * y))
        return smooth + w_splat[:, 0] * y

    b = grid.splat(target * confidence)
    y0 = b / w_splat
    out = torch.empty_like(y0)
    for k in range(target.shape[1]):
        out[:, k] = _cg(a_mv, lambda y: y / a_diag, b[:, k], y0[:, k],
                        cg_tol, cg_maxiter)
    return grid.slice(out)


def refine_mask(soft: np.ndarray) -> np.ndarray:
    """The host's final choice on the soft output [H, W]: threshold at 0.5,
    fill holes, keep the second-largest 4-connected component (labels
    counted with the background as label 0), or all ones when there is
    none -> bool [H, W]."""
    labeled, n_objects = labels.label(labels.fill_holes(soft > 0.5))
    sizes = np.bincount(labeled.ravel(), minlength=n_objects + 1)
    order = np.argsort(sizes.astype(np.int64))
    if len(order) < 2:
        return np.ones(soft.shape, bool)
    return labeled == order[-2]


def bilateral_solver_output(
    image: np.ndarray,  # [H, W, 3] uint8 RGB
    target: np.ndarray,  # [H, W] float or binary
    sigma_spatial: float = 16,
    sigma_luma: float = 16,
    sigma_chroma: float = 8,
    lam: float = 256.0,
    confidence_value: float = 0.999,
    cg_maxiter: int = 25,
    cg_tol: float = 1e-5,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (soft solver output [H, W] float64, refined mask [H, W] bool), both
    on the host; the grid and the solve run on `device`."""
    if target.ndim != 2:
        raise ValueError(f"target must be [H, W], got {target.shape}")
    h, w = target.shape
    grid = BilateralGrid(image, sigma_spatial=sigma_spatial,
                         sigma_luma=sigma_luma, sigma_chroma=sigma_chroma,
                         device=device)
    t = torch.from_numpy(np.asarray(target, np.float64).reshape(-1, 1))
    c = torch.full((h * w, 1), confidence_value, dtype=torch.float64,
                   device=grid.device)
    soft = solve(grid, t.to(grid.device), c, lam=lam, cg_maxiter=cg_maxiter,
                 cg_tol=cg_tol).reshape(h, w).cpu().numpy()
    return soft, refine_mask(soft)
