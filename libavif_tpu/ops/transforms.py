"""Integer block transforms: DCT / ADST / identity / Walsh-Hadamard.

Design note
-----------
The AV1 spec and CPU decoders (dav1d, libaom) realize the inverse transforms
as butterfly networks — the right call for scalar code. Here each 1-D
transform is a single **12-bit fixed-point integer matrix multiply** over a
large batch of blocks, with spec-style round-half-up shifting (``round2``):
one batched einsum per pass instead of a data-dependent butterfly. No GPU
has an int32 tensor-core product, so XLA lowers these einsums to its own
integer loop fusions. The basis matrices use the
same 12-bit ``cospi``/``sinpi`` precision as AV1 (cospi[j] =
round(4096·cos(pi·j/128))), so numerics track the spec closely, and all
arithmetic is exact int32 — encoder and decoder are bit-identical by
construction on any backend.

The lossless path uses an exact Hadamard pair (H·Hᵀ = N·I) so integer
round-trips are bit-exact, mirroring the role of AV1's WHT4x4
(spec §7.13.3 lossless; reference behavior via codec_aom.c:989-994).

Layout: coefficient blocks are batched as (B, N, N) int32 arrays. 2-D
transforms apply the 1-D matrix along columns then rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Transform type enums (subset of AV1 TX_TYPE table, spec §6.9.21)
DCT_DCT = 0
ADST_DCT = 1
DCT_ADST = 2
ADST_ADST = 3
IDTX = 4
WHT_WHT = 9  # lossless

TX_SIZES = (4, 8, 16, 32, 64)

_COS_BIT = 12
_FWD_SHIFT_EXTRA = 3  # coefficient headroom above orthonormal, like AV1


# ------------------------------------------------------------------- basis


def _dct_matrix(n: int) -> np.ndarray:
    """Fixed-point DCT-II basis, rows are basis vectors: (4096·orthonormal)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0, :] *= 1.0 / np.sqrt(2.0)
    return np.round(m * (1 << _COS_BIT)).astype(np.int64)


def _adst_matrix(n: int) -> np.ndarray:
    """Fixed-point ADST (DST-IV flavored, as used for intra residuals)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sin(np.pi * (2 * k + 1) * (2 * i + 1) / (4 * n)) * np.sqrt(2.0 / n)
    return np.round(m * (1 << _COS_BIT)).astype(np.int64)


_IDTX_SCALE = {4: 1.0, 8: np.sqrt(2.0), 16: 2.0, 32: 2.0 * np.sqrt(2.0), 64: 4.0}


def _idtx_matrix(n: int) -> np.ndarray:
    """Identity transform with AV1-style sqrt2 gain per dimension."""
    return np.round(np.eye(n) * _IDTX_SCALE[n] * (1 << _COS_BIT)).astype(np.int64)


def _idtx_inv_matrix(n: int) -> np.ndarray:
    """Inverse identity kernel: the identity matrix is not orthogonal-scaled,
    so the inverse pass needs the reciprocal gain, not the transpose."""
    return np.round(np.eye(n) / _IDTX_SCALE[n] * (1 << _COS_BIT)).astype(np.int64)


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_BASIS: dict[tuple[str, int], np.ndarray] = {}
for _n in TX_SIZES:
    _BASIS[("dct", _n)] = _dct_matrix(_n)
    _BASIS[("idtx", _n)] = _idtx_matrix(_n)
    _BASIS[("idtx_inv", _n)] = _idtx_inv_matrix(_n)
    if _n <= 16:
        _BASIS[("adst", _n)] = _adst_matrix(_n)
_BASIS[("wht", 4)] = _hadamard(4)


def _kernels(tx_type: int, n: int, inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(col_kernel, row_kernel) basis matrices for a tx type."""
    idtx = _BASIS[("idtx_inv", n)] if inverse else _BASIS[("idtx", n)]
    if tx_type == DCT_DCT:
        return _BASIS[("dct", n)], _BASIS[("dct", n)]
    if tx_type == ADST_DCT:  # ADST vertical, DCT horizontal
        return _BASIS[("adst", n)], _BASIS[("dct", n)]
    if tx_type == DCT_ADST:
        return _BASIS[("dct", n)], _BASIS[("adst", n)]
    if tx_type == ADST_ADST:
        return _BASIS[("adst", n)], _BASIS[("adst", n)]
    if tx_type == IDTX:
        return idtx, idtx
    if tx_type == WHT_WHT:
        return _BASIS[("wht", n)], _BASIS[("wht", n)]
    raise ValueError(f"tx_type {tx_type}")


# ------------------------------------------------------------------ round2


def _round2(x: jnp.ndarray, bit: int) -> jnp.ndarray:
    """AV1 Round2: (x + 2^(bit-1)) >> bit with arithmetic shift (spec §4.7)."""
    if bit == 0:
        return x
    return (x + (1 << (bit - 1))) >> bit


# ------------------------------------------------------------ 2-D transforms


@functools.partial(jax.jit, static_argnames=("tx_type", "n"))
def forward_transform(residual: jnp.ndarray, tx_type: int, n: int) -> jnp.ndarray:
    """Batched 2-D forward transform: (B, n, n) int32 residual -> coeffs.

    Output scale: 2^_FWD_SHIFT_EXTRA × orthonormal (AV1-like 3-bit headroom).
    """
    if tx_type == WHT_WHT:
        h = jnp.asarray(_hadamard(n), dtype=jnp.int32)
        # Exact: coeff = H X Hᵀ (no rounding). Inverse divides by n².
        t = jnp.einsum("ij,bjk->bik", h, residual.astype(jnp.int32))
        return jnp.einsum("bik,jk->bij", t, h)
    col_k, row_k = _kernels(tx_type, n)
    ck = jnp.asarray(col_k, dtype=jnp.int32)
    rk = jnp.asarray(row_k, dtype=jnp.int32)
    x = residual.astype(jnp.int32)
    # Columns: C = round2(K·X, cos_bit - extra/2 … split headroom over passes)
    t = _round2(jnp.einsum("ij,bjk->bik", ck, x), _COS_BIT - 2)
    c = _round2(jnp.einsum("bik,jk->bij", t, rk), _COS_BIT - 1)
    return c


@functools.partial(jax.jit, static_argnames=("tx_type", "n"))
def inverse_transform(coeffs: jnp.ndarray, tx_type: int, n: int) -> jnp.ndarray:
    """Batched 2-D inverse transform: (B, n, n) int32 coeffs -> residual.

    Exactly inverts ``forward_transform``'s scaling: fwd gain is
    2^(2·cos_bit) / 2^(2·cos_bit - 3) = 2^3 over orthonormal, so the inverse
    applies the transposed kernels and shifts 2·cos_bit + 3 total.
    """
    if tx_type == WHT_WHT:
        h = jnp.asarray(_hadamard(n), dtype=jnp.int32)
        t = jnp.einsum("ji,bjk->bik", h, coeffs.astype(jnp.int32))
        out = jnp.einsum("bik,kj->bij", t, h)
        shift = 2 * int(np.log2(n))  # H·Hᵀ = n·I per dimension
        return out >> shift  # exact: out is divisible by n²
    col_k, row_k = _kernels(tx_type, n, inverse=True)
    ck = jnp.asarray(col_k, dtype=jnp.int32)
    rk = jnp.asarray(row_k, dtype=jnp.int32)
    c = coeffs.astype(jnp.int32)
    t = _round2(jnp.einsum("ji,bjk->bik", ck, c), _COS_BIT)
    x = _round2(jnp.einsum("bik,kj->bij", t, rk), _COS_BIT + 3)
    return x


def available_tx_types(n: int, lossless: bool) -> tuple[int, ...]:
    if lossless:
        return (WHT_WHT,)
    if n <= 16:
        return (DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX)
    return (DCT_DCT, IDTX)
