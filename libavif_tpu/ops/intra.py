"""Intra predictors, batched over blocks.

Mode numbering follows AV1 (spec §6.10.18): DC=0, V=1, H=2, D45..D67=3..8
(directional, later round), SMOOTH=9, SMOOTH_V=10, SMOOTH_H=11, PAETH=12.

All predictors are vectorized over a batch of blocks: inputs are the
reconstructed neighbor row above (``top``: (B, N)), the neighbor column to
the left (``left``: (B, N)) and the corner pixel (``topleft``: (B,)).
Neighbor synthesis for unavailable edges happens in ``prepare_neighbors`` so
encoder and decoder share identical semantics.

The smooth-prediction weight table is a generated profile asset (quadratic
fade, same shape as the spec's sm_weights) kept swappable for a
spec-extracted table.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

DC_PRED = 0
V_PRED = 1
H_PRED = 2
D45_PRED = 3
D67_PRED = 4
D113_PRED = 5
D135_PRED = 6
D157_PRED = 7
D203_PRED = 8
SMOOTH_PRED = 9
SMOOTH_V_PRED = 10
SMOOTH_H_PRED = 11
PAETH_PRED = 12

# Full 13-mode set (the AV1 intra mode family: DC, V/H, six directional
# angles, three smooth variants, Paeth).
MODE_SET = (
    DC_PRED, V_PRED, H_PRED,
    D45_PRED, D67_PRED, D113_PRED, D135_PRED, D157_PRED, D203_PRED,
    SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED,
)
N_MODES = len(MODE_SET)
MODE_TO_INDEX = {m: i for i, m in enumerate(MODE_SET)}

# Directional prediction angles in degrees (measured like AV1's p_angle:
# 90 = straight up/vertical, 180 = straight left/horizontal).
_DIR_ANGLES = {
    D45_PRED: 45.0,
    D67_PRED: 67.5,
    D113_PRED: 112.5,
    D135_PRED: 135.0,
    D157_PRED: 157.5,
    D203_PRED: 202.5,
}


@functools.lru_cache(maxsize=None)
def _dir_tables(mode: int, n: int):
    """Precomputed gather tables for one directional mode at size n.

    Returns (use_top (n,n) bool, idx (n,n) int, frac (n,n) int in 1/32):
    prediction interpolates edge_top / edge_left vectors of length 2n+1
    laid out as [topleft, edge(0..n-1), replicated(n..2n-1)]. Geometry is
    derived from the angle directly (not AV1's dr tables): each pixel
    projects along the angle onto the top row (y = -1) or left column
    (x = -1), whichever it hits inside the prediction zone.
    """
    a = np.deg2rad(_DIR_ANGLES[mode])
    # Direction pointing from the pixel toward the reference samples.
    dx = np.cos(a)
    dy = -np.sin(a)  # screen coords: up is negative y
    r = np.arange(n)[:, None] + 0.0  # pixel row
    c = np.arange(n)[None, :] + 0.0  # pixel col
    use_top = np.zeros((n, n), dtype=bool)
    pos = np.zeros((n, n))
    if dy < 0:  # ray can reach the top row
        t_top = (r + 1.0) / (-dy)  # steps to reach y = -1
        x_top = c + t_top * dx
        use_top = x_top >= -1.0
        pos = np.where(use_top, x_top, 0.0)
    if dx < 0:  # ray can reach the left column
        t_left = (c + 1.0) / (-dx)
        y_left = r + t_left * dy
        pos = np.where(use_top, pos, y_left)
    # Map to edge-vector indices: edge[0] = topleft sits at coordinate -1.
    coord = pos + 1.0  # -1 -> 0
    coord = np.clip(coord, 0.0, 2.0 * n - 1.0 - 1e-6)
    idx = np.floor(coord).astype(np.int32)
    frac = np.round((coord - idx) * 32.0).astype(np.int32)
    idx = np.where(frac == 32, idx + 1, idx)
    frac = np.where(frac == 32, 0, frac)
    idx = np.clip(idx, 0, 2 * n - 1)
    return use_top, idx, frac


def directional_pred(top, left, topleft, n: int, mode: int):
    """Directional prediction (B, n, n) from (B, n) edges + corner.

    The above-right / below-left extensions are replications of the last
    known edge sample (they are never reconstructed yet in the wavefront —
    a consistent encoder/decoder convention)."""
    use_top, idx, frac = _dir_tables(mode, n)
    B = top.shape[0]
    t = top.astype(jnp.int32)
    l = left.astype(jnp.int32)
    tl = topleft.astype(jnp.int32)[:, None]
    ext_t = jnp.concatenate(
        [tl, t, jnp.broadcast_to(t[:, -1:], (B, n))], axis=1
    )  # (B, 2n+1)
    ext_l = jnp.concatenate(
        [tl, l, jnp.broadcast_to(l[:, -1:], (B, n))], axis=1
    )
    idx_j = jnp.asarray(idx)
    frac_j = jnp.asarray(frac)
    use_top_j = jnp.asarray(use_top)

    def interp(edge):
        e0 = edge[:, idx_j.reshape(-1)].reshape(B, n, n)
        e1 = edge[:, jnp.clip(idx_j + 1, 0, 2 * n).reshape(-1)].reshape(B, n, n)
        return (e0 * (32 - frac_j) + e1 * frac_j + 16) >> 5

    return jnp.where(use_top_j[None], interp(ext_t), interp(ext_l))


def smooth_weights(n: int) -> np.ndarray:
    """Quadratic fade 255 -> 32 (profile asset; same role as spec sm_weights)."""
    i = np.arange(n, dtype=np.float64)
    t = i / max(n - 1, 1)
    w = 32 + (255 - 32) * (1.0 - t) ** 2
    return np.round(w).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("n", "mid"))
def prepare_neighbors(top, left, topleft, have_top, have_left, n: int, mid: int):
    """Synthesize unavailable neighbors (shared encoder/decoder semantics).

    have_top/have_left: (B,) bool. Missing top -> replicate left[0] (or mid);
    missing left -> replicate top[0] (or mid); missing corner -> blend.
    """
    have_top = have_top[:, None]
    have_left = have_left[:, None]
    mid_v = jnp.full_like(top, mid)
    top_fill = jnp.where(have_left, left[:, :1], mid_v[:, :1])
    left_fill = jnp.where(have_top, top[:, :1], mid_v[:, :1])
    top = jnp.where(have_top, top, jnp.broadcast_to(top_fill, top.shape))
    left = jnp.where(have_left, left, jnp.broadcast_to(left_fill, left.shape))
    topleft = jnp.where(
        (have_top & have_left)[:, 0],
        topleft,
        jnp.where(have_top[:, 0], top[:, 0], jnp.where(have_left[:, 0], left[:, 0], mid)),
    )
    return top, left, topleft


@functools.partial(jax.jit, static_argnames=("n",))
def predict_all_modes(top, left, topleft, n: int):
    """All 13 modes at once: returns (B, N_MODES, n, n) int32 in MODE_SET
    order. Used by the encoder's exhaustive parallel mode search (the
    device replaces libaom's pruned search with brute force, SURVEY §7 #4)."""
    preds = [
        dc_pred(top, left, n),
        v_pred(top, n),
        h_pred(left, n),
        directional_pred(top, left, topleft, n, D45_PRED),
        directional_pred(top, left, topleft, n, D67_PRED),
        directional_pred(top, left, topleft, n, D113_PRED),
        directional_pred(top, left, topleft, n, D135_PRED),
        directional_pred(top, left, topleft, n, D157_PRED),
        directional_pred(top, left, topleft, n, D203_PRED),
        smooth_pred(top, left, n),
        smooth_v_pred(top, left, n),
        smooth_h_pred(top, left, n),
        paeth_pred(top, left, topleft, n),
    ]
    return jnp.stack(preds, axis=1)


@functools.partial(jax.jit, static_argnames=("n", "mode"))
def predict_mode(top, left, topleft, n: int, mode: int):
    """Single-mode prediction: (B, n, n) int32."""
    if mode == DC_PRED:
        return dc_pred(top, left, n)
    if mode == V_PRED:
        return v_pred(top, n)
    if mode == H_PRED:
        return h_pred(left, n)
    if mode in _DIR_ANGLES:
        return directional_pred(top, left, topleft, n, mode)
    if mode == SMOOTH_PRED:
        return smooth_pred(top, left, n)
    if mode == SMOOTH_V_PRED:
        return smooth_v_pred(top, left, n)
    if mode == SMOOTH_H_PRED:
        return smooth_h_pred(top, left, n)
    if mode == PAETH_PRED:
        return paeth_pred(top, left, topleft, n)
    raise ValueError(f"mode {mode}")


def dc_pred(top, left, n: int):
    """(sum(top)+sum(left)+n) >> (log2(n)+1) — AV1 DC for square blocks."""
    s = jnp.sum(top.astype(jnp.int32), axis=1) + jnp.sum(left.astype(jnp.int32), axis=1)
    shift = int(np.log2(n)) + 1
    dc = (s + n) >> shift
    return jnp.broadcast_to(dc[:, None, None], (top.shape[0], n, n)).astype(jnp.int32)


def v_pred(top, n: int):
    return jnp.broadcast_to(top[:, None, :], (top.shape[0], n, n)).astype(jnp.int32)


def h_pred(left, n: int):
    return jnp.broadcast_to(left[:, :, None], (left.shape[0], n, n)).astype(jnp.int32)


def paeth_pred(top, left, topleft, n: int):
    t = top[:, None, :].astype(jnp.int32)  # (B,1,N)
    l = left[:, :, None].astype(jnp.int32)  # (B,N,1)
    tl = topleft[:, None, None].astype(jnp.int32)
    base = t + l - tl
    pt = jnp.abs(base - t)
    pl = jnp.abs(base - l)
    ptl = jnp.abs(base - tl)
    take_l = (pl <= pt) & (pl <= ptl)
    take_t = (pt <= ptl)
    b = jnp.broadcast_to
    shape = (top.shape[0], n, n)
    return jnp.where(take_l, b(l, shape), jnp.where(take_t, b(t, shape), b(tl, shape)))


def _smooth_core(top, left, n: int, vertical: bool, horizontal: bool):
    B = top.shape[0]
    w = jnp.asarray(smooth_weights(n), dtype=jnp.int32)
    t = top.astype(jnp.int32)
    l = left.astype(jnp.int32)
    bottom_left = l[:, -1]  # (B,)
    top_right = t[:, -1]
    acc = jnp.zeros((B, n, n), dtype=jnp.int32)
    count = 0
    if vertical:
        wv = w[None, :, None]  # weight by row
        acc = acc + wv * t[:, None, :] + (256 - wv) * bottom_left[:, None, None]
        count += 1
    if horizontal:
        wh = w[None, None, :]  # weight by col
        acc = acc + wh * l[:, :, None] + (256 - wh) * top_right[:, None, None]
        count += 1
    return (acc + (128 * count)) >> (8 + (count - 1))


def smooth_pred(top, left, n: int):
    return _smooth_core(top, left, n, True, True)


def smooth_v_pred(top, left, n: int):
    return _smooth_core(top, left, n, True, False)


def smooth_h_pred(top, left, n: int):
    return _smooth_core(top, left, n, False, True)
