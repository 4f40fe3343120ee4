"""Irreducible-representation machinery for E(3)-equivariant GNNs (the
JAX package's ``models/gnn/irreps.py``).

* complex Clebsch-Gordan via the Racah formula (exact, float64);
* real-basis CG through the complex->real change-of-basis matrices;
* real spherical harmonics generated *recursively* through the CG
  coupling itself (``Y_l ∝ CG(l-1,1,l) : Y_{l-1} ⊗ Y_1``), so SH and CG
  are consistent *by construction*;
* Wigner rotations assembled as ``D(R) = exp(angle * G)`` from numerically
  extracted so(3) generators, block-diagonalized once on the host so the
  runtime cost per edge is a pair of small dense matmuls (the eSCN SO(2)
  convolution of Equiformer-v2).

The host constants are float64 numpy, computed by the reference's own
calls in the same order, so on one machine they equal its constants byte
for byte (``_z_pairing``'s Schur form follows the machine's LAPACK: a
different call would change the eSCN pairing).  The runtime pieces are
torch, on the device of their input.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch

__all__ = [
    "clebsch_gordan",
    "sph_harm",
    "sph_dim",
    "RotationBasis",
    "tp_paths",
]


def sph_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


# ----------------------------------------------------------------------
# complex CG (Racah) + real basis change
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _fact(n: int) -> float:
    return float(math.factorial(n))


def _cg_complex_coeff(j1, m1, j2, m2, j3, m3) -> float:
    """<j1 m1 j2 m2 | j3 m3> via the Racah formula (exact float64)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    pref = math.sqrt(
        (2 * j3 + 1)
        * _fact(j3 + j1 - j2)
        * _fact(j3 - j1 + j2)
        * _fact(j1 + j2 - j3)
        / _fact(j1 + j2 + j3 + 1)
    )
    pref *= math.sqrt(
        _fact(j3 + m3)
        * _fact(j3 - m3)
        * _fact(j1 - m1)
        * _fact(j1 + m1)
        * _fact(j2 - m2)
        * _fact(j2 + m2)
    )
    s = 0.0
    kmin = max(0, j2 - j3 - m1, j1 - j3 + m2)
    kmax = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    for k in range(kmin, kmax + 1):
        s += (-1.0) ** k / (
            _fact(k)
            * _fact(j1 + j2 - j3 - k)
            * _fact(j1 - m1 - k)
            * _fact(j2 + m2 - k)
            * _fact(j3 - j2 + m1 + k)
            * _fact(j3 - j1 - m2 + k)
        )
    return pref * s


@functools.lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """Q[l]: complex SH = Q @ real SH (rows m=-l..l complex, cols real)."""
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    # real basis ordered m = -l..l  (sin|m| terms for m<0, cos for m>0)
    for m in range(-l, l + 1):
        row = m + l
        if m < 0:
            q[row, m + l] = 1j / math.sqrt(2)
            q[row, -m + l] = 1 / math.sqrt(2)
        elif m == 0:
            q[row, l] = 1.0
        else:
            q[row, m + l] = (-1) ** m / math.sqrt(2)
            q[row, -m + l] = -1j * (-1) ** m / math.sqrt(2)
    return q


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis CG tensor C[(2l1+1), (2l2+1), (2l3+1)] (float64).

    ``(x ⊗ y)_l3 = einsum('ijk,i,j->k', C, x_l1, y_l2)`` transforms as l3.
    The cached array is shared by every caller: read it, never write it.
    """
    c = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), dtype=np.complex128)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                c[m1 + l1, m2 + l2, m3 + l3] = _cg_complex_coeff(
                    l1, m1, l2, m2, l3, m3
                )
    q1 = _real_to_complex(l1)
    q2 = _real_to_complex(l2)
    q3 = _real_to_complex(l3)
    real = np.einsum("abc,ai,bj,ck->ijk", c, q1, q2, np.conj(q3))
    # the result must be real or purely imaginary; fold phase in
    if np.abs(real.imag).max() > np.abs(real.real).max():
        real = real.imag
    else:
        real = real.real
    if not np.isfinite(real).all():
        raise FloatingPointError(f"CG({l1}, {l2}, {l3}) is not finite")
    return np.ascontiguousarray(real)


# ----------------------------------------------------------------------
# recursive real spherical harmonics (consistent with the CG above)
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _sh_norms(l_max: int) -> Tuple[float, ...]:
    """Normalization so that |Y_l(u)| = 1 for unit u (e3nn 'norm')."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=3)
    u /= np.linalg.norm(u)
    y = {1: u / np.linalg.norm(u)}
    norms = [1.0, 1.0]
    for l in range(2, l_max + 1):
        cg = clebsch_gordan(l - 1, 1, l)
        raw = np.einsum("ijk,i,j->k", cg, y[l - 1], y[1])
        n = np.linalg.norm(raw)
        norms.append(1.0 / n)
        y[l] = raw / n
    return tuple(norms)


@functools.lru_cache(maxsize=None)
def _cg_tensor(l1: int, l2: int, l3: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """:func:`clebsch_gordan` as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(clebsch_gordan(l1, l2, l3), dtype=dtype,
                           device=device)


def sph_harm(l_max: int, vecs: torch.Tensor) -> torch.Tensor:
    """Real SH of unit vectors, concatenated l=0..l_max: (..., (l_max+1)^2).

    Built by recursive CG coupling; |Y_l| = 1 for every l on unit input.
    Y_0 = 1; Y_1 = the vector itself (basis order [x, y, z]).
    """
    out = [torch.ones(vecs.shape[:-1] + (1,), dtype=vecs.dtype,
                      device=vecs.device), vecs]
    norms = _sh_norms(l_max) if l_max >= 2 else (1.0, 1.0)
    prev = vecs
    for l in range(2, l_max + 1):
        cg = _cg_tensor(l - 1, 1, l, vecs.dtype, vecs.device)
        nxt = torch.einsum("...i,...j,ijk->...k", prev, vecs, cg) * norms[l]
        out.append(nxt)
        prev = nxt
    return torch.cat(out, dim=-1)


def tp_paths(l_in: List[int], l_edge: int, l_out_max: int):
    """All (l1, l2, l3) tensor-product paths for a NequIP-style layer."""
    paths = []
    for l1 in l_in:
        for l2 in range(l_edge + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_out_max) + 1):
                paths.append((l1, l2, l3))
    return paths


# ----------------------------------------------------------------------
# Wigner rotations via numerically-extracted so(3) generators
# ----------------------------------------------------------------------
def _sh_numpy(l_max, vecs):
    """Pure-numpy float64 SH (float32 generators are too noisy for the
    Schur pairing)."""
    vecs = np.asarray(vecs, np.float64)
    out = [np.ones(vecs.shape[:-1] + (1,)), vecs]
    norms = _sh_norms(l_max) if l_max >= 2 else (1.0, 1.0)
    prev = vecs
    for l in range(2, l_max + 1):
        cg = clebsch_gordan(l - 1, 1, l)
        nxt = np.einsum("...i,...j,ijk->...k", prev, vecs, cg) * norms[l]
        out.append(nxt)
        prev = nxt
    return np.concatenate(out, axis=-1)


@functools.lru_cache(maxsize=None)
def _generator(l: int, axis: int) -> np.ndarray:
    """G_axis for irrep l: d/dθ D(R_axis(θ)) at 0, via least squares."""
    rng = np.random.default_rng(l * 13 + axis)
    pts = rng.normal(size=(8 * (2 * l + 1), 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    eps = 1e-5

    def rot(theta):
        from scipy.spatial.transform import Rotation

        return Rotation.from_euler("xyz"[axis], theta).as_matrix()

    def d_of(R):
        y0 = _block(l, pts)
        y1 = _block(l, pts @ R.T)
        return np.linalg.lstsq(y0, y1, rcond=None)[0].T

    dp = d_of(rot(eps))
    dm = d_of(rot(-eps))
    g = (dp - dm) / (2 * eps)
    return g


def _block(l: int, pts: np.ndarray) -> np.ndarray:
    full = _sh_numpy(l, pts)
    return full[:, l * l : (l + 1) * (l + 1)]


@functools.lru_cache(maxsize=None)
def _z_pairing(l: int):
    """Block-diagonalize G_z for irrep l via the real Schur decomposition.

    G_z is real antisymmetric; Schur gives an orthogonal Q with
    Qᵀ G Q block-diagonal: 2x2 blocks [[0, m], [-m, 0]] (plus an m=0 line),
    so ``D(R_z(a)) = Q · blockrot(m·a) · Qᵀ`` analytically.
    Returns (Q (d,d), pairs [(i, j, m_signed)]).
    """
    import scipy.linalg

    g = _generator(l, 2)
    tmat, q = scipy.linalg.schur(g, output="real")
    d = 2 * l + 1
    pairs = []
    i = 0
    while i < d:
        if i + 1 < d and abs(tmat[i, i + 1]) > 0.5:
            m = round(float(tmat[i, i + 1]), 6)
            if abs(m - round(m)) >= 1e-3:
                raise ArithmeticError(f"irrep {l}: Schur block {m} is no "
                                      "integer")
            pairs.append((i, i + 1, float(round(m))))
            i += 2
        else:
            i += 1
    if len(pairs) != l:  # irrep l has exactly l (m, -m) pairs
        raise ArithmeticError(f"irrep {l}: {len(pairs)} Schur pairs {pairs}")
    return q, tuple(pairs)


@functools.lru_cache(maxsize=None)
def _j_matrix(l: int) -> np.ndarray:
    """Constant Wigner matrix J_l = D_l(S) with S·ẑ = ŷ (S = R_x(-π/2)),
    so that D(R_y(β)) = J · Z(β) · Jᵀ, computed once by least squares."""
    from scipy.spatial.transform import Rotation

    s = Rotation.from_euler("x", -np.pi / 2).as_matrix()
    rng = np.random.default_rng(l * 7 + 3)
    pts = rng.normal(size=(8 * (2 * l + 1), 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    y0 = _block(l, pts)
    y1 = _block(l, pts @ s.T)
    j = np.linalg.lstsq(y0, y1, rcond=None)[0].T
    return j


class RotationBasis:
    """Host-precomputed constants for runtime Wigner rotations up to l_max,
    as float32 tensors on ``device``.

    ``D(R_z(a))`` is analytic through the pairing basis; ``D(R_y(b)) =
    J Z(b) Jᵀ``; ``align_z(edge)`` is the eSCN alignment rotation, the D
    mapping the edge direction onto the z-axis (per l).
    """

    def __init__(self, l_max: int, device=None):
        from ...device import resolve_device

        dev = resolve_device(device)
        self.l_max = l_max
        self.T = [torch.as_tensor(_z_pairing(l)[0], dtype=torch.float32,
                                  device=dev) for l in range(l_max + 1)]
        self.pairs = [_z_pairing(l)[1] for l in range(l_max + 1)]
        self.J = [torch.as_tensor(_j_matrix(l), dtype=torch.float32,
                                  device=dev) for l in range(l_max + 1)]

    def z_rot(self, l: int, angle: torch.Tensor) -> torch.Tensor:
        """D_l(R_z(angle)) for batched angles: (..., d, d).

        exp(a·G) = Q · blockrot(m·a) · Qᵀ from the Schur pairing.
        """
        d = 2 * l + 1
        t = self.T[l].to(angle.dtype)
        eye = torch.eye(d, dtype=angle.dtype, device=angle.device)
        blocks = (torch.zeros(angle.shape + (d, d), dtype=angle.dtype,
                              device=angle.device) + eye)
        for (i, j, m) in self.pairs[l]:
            c, s = torch.cos(m * angle), torch.sin(m * angle)
            blocks[..., i, i] = c
            blocks[..., i, j] = s
            blocks[..., j, i] = -s
            blocks[..., j, j] = c
        return torch.einsum("pi,...ij,qj->...pq", t, blocks, t)

    def y_rot(self, l: int, angle: torch.Tensor) -> torch.Tensor:
        """D_l(R_y(angle)) = J · Z(angle) · Jᵀ."""
        j = self.J[l].to(angle.dtype)
        z = self.z_rot(l, angle)
        return torch.einsum("pi,...ij,qj->...pq", j, z, j)

    def align_z(self, l: int, vecs: torch.Tensor) -> torch.Tensor:
        """D_l(R) with R·v = |v| ẑ for unit-ish edge vectors v (..., 3)."""
        x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
        phi = torch.atan2(y, x)
        theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
        # R = Ry(-theta) Rz(-phi)
        return torch.einsum(
            "...ij,...jk->...ik",
            self.y_rot(l, -theta),
            self.z_rot(l, -phi),
        )
