"""SO(3) machinery for the equivariant GNNs (NequIP, EquiformerV2/eSCN).

The port of ``repro/models/gnn/so3.py``.  Every static tensor that depends
on representation-theoretic conventions (Wigner J matrices, Gaunt
couplings) is computed numerically at build time, in numpy, from the real
spherical harmonics themselves: J matrices are least-squares fits of D(R)
from Y(Rv) = D Y(v) sample systems, and couplings are exact
Gauss-Legendre x Fourier quadratures of triple products.  These build-time
parts are the JAX package's, copied.

At run time (torch, per edge) the rotation into an edge's frame is the zyz
factorization
    D(R_align) = J^{-1} . Z(-beta) . J . Z(-alpha)        (applied right-to-left)
where Z(theta) is the analytic block rotation mixing (m, -m) pairs and J is
the static change-of-axis matrix.

Component ordering: irrep l occupies slots [l^2, (l+1)^2), m from -l to +l.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def n_comps(l_max: int) -> int:
    return (l_max + 1) ** 2


def m_array(l_max: int) -> np.ndarray:
    """Signed m per component slot."""
    out = []
    for l in range(l_max + 1):
        out.extend(range(-l, l + 1))
    return np.asarray(out, dtype=np.int64)


def flip_index(l_max: int) -> np.ndarray:
    """Index permutation mapping slot (l, m) -> (l, -m)."""
    idx = []
    for l in range(l_max + 1):
        base = l * l
        idx.extend(base + (l - m) for m in range(-l, l + 1))
    return np.asarray(idx, dtype=np.int64)


# ------------------------------------------------------ real SH evaluator --

def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def real_sph_harm(vecs, l_max: int, xp=torch):
    """Real spherical harmonics of unit vectors.

    vecs: (..., 3) -> (..., (l_max+1)^2).  Pole-safe: uses the scaled
    Legendre polynomials Q_l^m = P_l^m / sin^m(theta) (polynomial in z) and
    the Chebyshev-style recurrences A_m = Re((x+iy)^m), B_m = Im((x+iy)^m).
    Works for numpy (``xp=np``, build time) and torch (run time).
    """
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    # No Condon-Shortley phase (standard *real* SH convention: Y_1 ~ (y,z,x)).
    q = {}
    for m in range(l_max + 1):
        q[(m, m)] = _double_factorial(2 * m - 1) * xp.ones_like(z)
        if m + 1 <= l_max:
            q[(m + 1, m)] = z * (2 * m + 1) * q[(m, m)]
        for l in range(m + 2, l_max + 1):
            q[(l, m)] = ((2 * l - 1) * z * q[(l - 1, m)]
                         - (l + m - 1) * q[(l - 2, m)]) / (l - m)
    # azimuthal parts: A_m = Re((x+iy)^m), B_m = Im((x+iy)^m)
    a = [xp.ones_like(z)]
    b = [xp.zeros_like(z)]
    for m in range(1, l_max + 1):
        a.append(a[m - 1] * x - b[m - 1] * y)
        b.append(a[m - 1] * y + b[m - 1] * x)
    comps = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = float(np.sqrt(
                (2 * l + 1)
                / (4 * np.pi)
                * float(math.factorial(l - am))
                / float(math.factorial(l + am))
            ))
            if m == 0:
                comps.append(norm * q[(l, 0)])
            elif m > 0:
                comps.append(float(np.sqrt(2.0) * norm) * q[(l, m)] * a[m])
            else:
                comps.append(float(np.sqrt(2.0) * norm) * q[(l, am)] * b[am])
    if xp is torch:
        return torch.stack(comps, dim=-1)
    return xp.stack(comps, axis=-1)


# --------------------------------------------- build-time fitted matrices --

def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    golden = np.pi * (1 + np.sqrt(5.0))
    theta = golden * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1
    )


def fit_rotation_rep(l: int, rot: np.ndarray) -> np.ndarray:
    """Least-squares fit of D^l(R) from Y(R v) = D Y(v); residual asserted."""
    vecs = _fibonacci_sphere(max(8 * (2 * l + 1), 64))
    y = real_sph_harm(vecs, l, xp=np)[..., l * l : (l + 1) * (l + 1)]
    y_rot = real_sph_harm(vecs @ rot.T, l, xp=np)[..., l * l : (l + 1) * (l + 1)]
    d, res, *_ = np.linalg.lstsq(y, y_rot, rcond=None)
    d = d.T  # we solved Y D^T = Y_rot
    err = np.abs(y_rot - y @ d.T).max()
    assert err < 1e-8, (l, err)
    return d


def _rot_x(t):
    c, s = np.cos(t), np.sin(t)
    return np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(t):
    c, s = np.cos(t), np.sin(t)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(t):
    c, s = np.cos(t), np.sin(t)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])


# R_J: maps z->y (rotation by -pi/2 about x); conjugation turns Rz into Ry.
_R_J = _rot_x(-np.pi / 2)


@functools.lru_cache(maxsize=None)
def j_matrix_big(l_max: int) -> np.ndarray:
    """Block-diag J = D(R_J) over l = 0..l_max, shape (C, C)."""
    c = n_comps(l_max)
    out = np.zeros((c, c))
    for l in range(l_max + 1):
        out[l * l : (l + 1) ** 2, l * l : (l + 1) ** 2] = fit_rotation_rep(l, _R_J)
    return out


@functools.lru_cache(maxsize=None)
def _frame_tensors(l_max: int, dtype: torch.dtype, device: str):
    """(m per slot as float32, the (l, -m) permutation, J) on ``device``."""
    return (torch.as_tensor(m_array(l_max), dtype=torch.float32, device=device),
            torch.as_tensor(flip_index(l_max), device=device),
            torch.as_tensor(j_matrix_big(l_max), dtype=dtype, device=device))


def _zrot_apply(x, theta, m_arr, flip_idx):
    """Apply D(Rz(theta)) to features x: (..., C) with per-... theta.

    out_i = cos(m_i t) x_i - sin(m_i t) x_flip(i)
    """
    ang = theta[..., None] * m_arr
    return torch.cos(ang) * x - torch.sin(ang) * x.index_select(-1, flip_idx)


def rotate_to_edge_frame(x: torch.Tensor, edge_vec: torch.Tensor, *,
                         l_max: int, inverse: bool = False) -> torch.Tensor:
    """Rotate SH-indexed features into (or back from) the edge-aligned frame.

    x: (..., C) with C = (l_max+1)^2 as the LAST axis; edge_vec (..., 3)
    unnormalized.  In the aligned frame the edge direction is the z-axis.
    """
    v = edge_vec / torch.clamp_min(
        torch.linalg.norm(edge_vec, dim=-1, keepdim=True), 1e-9)
    alpha = torch.atan2(v[..., 1], v[..., 0])
    beta = torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))
    m_arr, flip, jmat = _frame_tensors(l_max, x.dtype, str(x.device))

    # (J x)_d = x @ J^T;  (J^T x)_d = x @ J
    if not inverse:
        # D_align = D_J . Z(-beta) . D_J^{-1} . Z(-alpha)  (right-to-left)
        x = _zrot_apply(x, -alpha, m_arr, flip)
        x = x @ jmat  # D_J^{-1} x (orthogonal)
        x = _zrot_apply(x, -beta, m_arr, flip)
        return x @ jmat.T  # D_J x
    # D_align^{-1} = Z(alpha) . D_J . Z(beta) . D_J^{-1}
    x = x @ jmat
    x = _zrot_apply(x, beta, m_arr, flip)
    x = x @ jmat.T
    return _zrot_apply(x, alpha, m_arr, flip)


# ----------------------------------------------------------- couplings ----

@functools.lru_cache(maxsize=None)
def gaunt_tensor(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real Gaunt coefficients  G[m1, m2, m3] = ∮ Y_{l1 m1} Y_{l2 m2} Y_{l3 m3}.

    Exact product quadrature: Gauss-Legendre in cos(theta) (degree l1+l2+l3
    polynomial) x uniform trapezoid in phi (band-limited Fourier).  The
    resulting coupling map (x (x) y)_{m3} = sum G x_{m1} y_{m2} is SO(3)-
    equivariant and proportional to the real CG coefficients per (l1,l2,l3).
    """
    deg = l1 + l2 + l3
    n_t = deg + 2
    n_p = 2 * deg + 3
    nodes, weights = np.polynomial.legendre.leggauss(n_t)
    phis = 2 * np.pi * np.arange(n_p) / n_p
    ct, ph = np.meshgrid(nodes, phis, indexing="ij")
    st = np.sqrt(1 - ct**2)
    vecs = np.stack([st * np.cos(ph), st * np.sin(ph), ct], -1).reshape(-1, 3)
    w = np.broadcast_to(weights[:, None], (n_t, n_p)).reshape(-1) * (
        2 * np.pi / n_p
    )
    y = real_sph_harm(vecs, max(l1, l2, l3), xp=np)
    y1 = y[:, l1 * l1 : (l1 + 1) ** 2]
    y2 = y[:, l2 * l2 : (l2 + 1) ** 2]
    y3 = y[:, l3 * l3 : (l3 + 1) ** 2]
    return np.einsum("n,na,nb,nc->abc", w, y1, y2, y3)
