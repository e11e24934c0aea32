"""Device-side codec core: wavefront reconstruction & encoder mode search.

Design
------
The sequential dependency of intra prediction (each block predicts from its
reconstructed top/left neighbors — SURVEY.md §7 hard-parts #3) is scheduled
as a **wavefront over anti-diagonals**: all blocks with the same r+c are
independent, so a `lax.scan` over diagonals processes up to `Rb` blocks per
step as one batched tensor op.

The key layout decision: the scan carries only the **wavefront boundary
state** — per-lane bottom rows, right columns, and top-row corners —
never the growing plane. Lane r at diagonal d handles block (r, d-r), so

  top(r, c)      = bottom row of (r-1, c)   = roll(bottoms, 1)[r]
  left(r, c)     = right col  of (r, c-1)   = same lane, previous step
  topleft(r, c)  = last pixel of top(r, c-1) = carried per lane

which turns every neighbor access into a lane shift (elementwise work on
the carried state) instead of a gather/scatter against device memory. Block data moves through the scan as
pre-arranged diagonal-major tensors (one parallel gather before the scan,
one after) — this is what makes the wavefront latency-bound only on real
dependencies.

The encoder replaces libaom's pruned mode search (codec_aom.c speed
ladder) with an exhaustive parallel search: every mode's full
residual→transform→quant→dequant→inverse→distortion pipeline runs for
every block in the diagonal at once (SURVEY.md §7 hard-parts #4).

All arithmetic is int32; costs are integer so mode decisions — hence the
bitstream — are backend-deterministic. Unavailable neighbors use the
mid-level value (the codec's halo convention, shared encoder/decoder).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.filters import cdef_plane, deblock_plane
from ..ops.intra import N_MODES, predict_all_modes
from ..ops.transforms import (
    ADST_ADST,
    ADST_DCT,
    DCT_ADST,
    DCT_DCT,
    IDTX,
    WHT_WHT,
    forward_transform,
    inverse_transform,
)

# Transform-type alphabet for lossy coding (entropy symbol order).
TX_SET_ALL = (DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX)
N_TX = len(TX_SET_ALL)


def tx_search_set(speed: int, n: int, breadth: int | None = None) -> tuple:
    """Speed ladder -> transform search breadth (the codec_aom.c:695-726
    speed-to-effort role). The bitstream alphabet is always TX_SET_ALL;
    speed only limits the encoder's search. ADST bases exist for n<=16.
    `breadth` (1-5, the tx-breadth codec option) overrides the ladder
    with the first k of (DCT, IDTX, ADST_ADST, ADST_DCT, DCT_ADST)."""
    if breadth is not None:
        order = (DCT_DCT, IDTX, ADST_ADST, ADST_DCT, DCT_ADST)
        sel = order[: max(1, min(5, int(breadth)))]
        if n > 16:
            sel = tuple(t for t in sel if t in (DCT_DCT, IDTX)) or (DCT_DCT,)
        return sel
    if n > 16:
        return (DCT_DCT, IDTX)
    if speed >= 6:
        return (DCT_DCT,)
    if speed >= 3:
        return (DCT_DCT, ADST_ADST, IDTX)
    return TX_SET_ALL


def mode_search_set(speed: int, breadth: int | None = None) -> tuple:
    """Speed ladder -> intra-mode search breadth (indices into
    ops.intra.MODE_SET). Shrinking the candidate tensor shrinks every
    downstream transform/SSE tensor on device — real wall-clock, not just
    a mask. The bitstream alphabet stays all 13 modes."""
    from ..ops.intra import (
        DC_PRED, H_PRED, PAETH_PRED, SMOOTH_PRED, V_PRED,
        D45_PRED, D135_PRED, N_MODES,
    )

    if breadth is not None:
        order = (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED,
                 D45_PRED, D135_PRED) + tuple(
            m for m in range(N_MODES)
            if m not in (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED,
                         D45_PRED, D135_PRED)
        )
        return order[: max(1, min(N_MODES, int(breadth)))]
    if speed >= 9:
        return (DC_PRED, V_PRED, H_PRED)
    if speed >= 8:
        return (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED)
    if speed >= 7:
        return (DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED,
                SMOOTH_PRED, PAETH_PRED)
    return tuple(range(N_MODES))


def pad_to_blocks(plane: np.ndarray, n: int) -> np.ndarray:
    """Pad (H, W) to whole n×n blocks with edge replication (host-side)."""
    h, w = plane.shape
    hp = -(-h // n) * n
    wp = -(-w // n) * n
    return np.pad(plane, ((0, hp - h), (0, wp - w)), mode="edge")


def _steps_mat(n: int, dc_step, ac_step):
    dc_mask = jnp.zeros((n, n), dtype=bool).at[0, 0].set(True)
    return jnp.where(dc_mask, dc_step, ac_step).astype(jnp.int32)


def _bitlength(a: jnp.ndarray, maxbits: int = 16) -> jnp.ndarray:
    """Integer bit length of |a| (exact, no float): sum of threshold tests."""
    bits = jnp.zeros_like(a)
    for k in range(maxbits):
        bits = bits + (a >= (1 << k)).astype(a.dtype)
    return bits


def _rate_bits(levels: jnp.ndarray) -> jnp.ndarray:
    """Integer rate proxy (bits) per block for the entropy layer: roughly
    3 + 2·bitlen per nonzero coefficient. Sums over the last two axes."""
    a = jnp.abs(levels)
    per = jnp.where(a > 0, 3 + 2 * _bitlength(a), 0)
    return jnp.sum(per, axis=(-1, -2))


def _diag_indices(rb: int, cb: int):
    """(c_idx, valid) per (diagonal, lane): lane i on diagonal d is block
    (i, d-i)."""
    d = jnp.arange(rb + cb - 1, dtype=jnp.int32)[:, None]
    i = jnp.arange(rb, dtype=jnp.int32)[None, :]
    c = d - i
    return jnp.clip(c, 0, cb - 1), (c >= 0) & (c < cb), c


def _to_diag(blocks, cc):
    """(Rb, Cb, ...) block tensor -> (D, L, ...) diagonal-major."""
    rb = blocks.shape[0]
    i = jnp.arange(rb, dtype=jnp.int32)[None, :]
    return blocks[jnp.broadcast_to(i, cc.shape), cc]


def _from_diag(diag, rb: int, cb: int):
    """(D, L, ...) diagonal-major -> (Rb, Cb, ...) block tensor."""
    r = jax.lax.broadcasted_iota(jnp.int32, (rb, cb), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (rb, cb), 1)
    return diag[r + c, r]


def _blocks_to_plane(blocks, rb: int, cb: int, n: int):
    return blocks.transpose(0, 2, 1, 3).reshape(rb * n, cb * n)


def _wavefront_neighbors(carry, c_arr, mid):
    """Boundary-state bookkeeping shared by encode and decode scans."""
    bottoms, rights, toplasts = carry
    top = jnp.roll(bottoms, 1, axis=0).at[0, :].set(mid)
    topleft = jnp.roll(toplasts, 1, axis=0).at[0].set(mid)
    first_col = c_arr == 0
    left = jnp.where(first_col[:, None], mid, rights)
    topleft = jnp.where(first_col, mid, topleft)
    return top, left, topleft


# ------------------------------------------------------------------ decode


@functools.partial(jax.jit, static_argnames=("n", "depth", "lossless"))
def decode_plane(levels, modes, dc_step, ac_step, tx_types=None, *, n: int, depth: int, lossless: bool):
    """Reconstruct a padded plane from entropy-decoded levels and modes.

    levels: (Rb, Cb, n, n) int32; modes: (Rb, Cb) int32 (index into
    intra.MODE_SET); tx_types: (Rb, Cb) int32 index into TX_SET_ALL
    (ignored for lossless; None means all-DCT). Returns (Rb*n, Cb*n)
    int32 reconstruction.
    """
    rb, cb = modes.shape
    maxv = (1 << depth) - 1
    mid = 1 << (depth - 1)

    # Residual synthesis is recon-independent: one big batched pass.
    flat = levels.reshape(-1, n, n)
    if lossless:
        residuals = inverse_transform(flat, WHT_WHT, n)
    else:
        deq = flat * _steps_mat(n, dc_step, ac_step)[None]
        # Hostile-stream guard: bound dequantized coefficients to the
        # largest magnitude a legitimate encode can produce (8·n·maxv
        # transform gain) so adversarial levels can't wrap the inverse.
        cmax = 1 << (depth + 4 + n.bit_length())
        deq = jnp.clip(deq, -cmax, cmax)
        if tx_types is None:
            residuals = inverse_transform(deq, DCT_DCT, n)
        else:
            # Per-block transform type: evaluate each basis over all
            # blocks (batched) and mask-select (no gathers).
            txf = jnp.clip(tx_types.reshape(-1), 0, N_TX - 1)
            if n > 16:
                # ADST bases exist only for n<=16; treat those symbols as DCT.
                txf = jnp.where((txf >= 1) & (txf <= 3), 0, txf)
                pairs = [(0, DCT_DCT), (4, IDTX)]
            else:
                pairs = list(enumerate(TX_SET_ALL))
            residuals = jnp.zeros_like(deq)
            for ti, t in pairs:
                sel = (txf == ti)[:, None, None]
                residuals = jnp.where(sel, inverse_transform(deq, t, n), residuals)
    residuals = residuals.reshape(rb, cb, n, n)

    cc, _, _ = _diag_indices(rb, cb)
    resid_diag = _to_diag(residuals, cc)  # (D, L, n, n)
    modes_diag = _to_diag(modes, cc)  # (D, L)

    def step(carry, xs):
        resid, mode, c_arr = xs
        top, left, topleft = _wavefront_neighbors(carry, c_arr, mid)
        preds = predict_all_modes(top, left, topleft, n)  # (L, M, n, n)
        pred = jnp.take_along_axis(preds, mode[:, None, None, None], axis=1)[:, 0]
        block = jnp.clip(pred + resid, 0, maxv)
        carry = (block[:, -1, :], block[:, :, -1], top[:, -1])
        return carry, block

    L = rb
    init = (
        jnp.full((L, n), mid, jnp.int32),
        jnp.full((L, n), mid, jnp.int32),
        jnp.full((L,), mid, jnp.int32),
    )
    _, rec_diag = jax.lax.scan(step, init, (resid_diag, modes_diag, cc))
    blocks = _from_diag(rec_diag, rb, cb)
    return _blocks_to_plane(blocks, rb, cb, n)


# ------------------------------------------------------------------ encode


@functools.partial(jax.jit, static_argnames=("n", "depth", "lossless", "speed", "search"))
def encode_plane(src, dc_step, ac_step, *, n: int, depth: int, lossless: bool, speed: int = 6,
                 search: tuple = (None, None)):
    """Exhaustive-parallel mode × transform search over a padded plane.

    src: (Rb*n, Cb*n) int32 (already padded). Returns (modes (Rb,Cb) int32,
    levels (Rb,Cb,n,n) int32, recon (Rb*n, Cb*n) int32, tx_types (Rb,Cb)
    int32 — indices into TX_SET_ALL). Speed limits the transform search
    breadth (tx_search_set); the joint RD winner over modes × transforms
    is selected per block.
    """
    hp, wp = src.shape
    rb, cb = hp // n, wp // n
    maxv = (1 << depth) - 1
    mid = 1 << (depth - 1)
    txs = (WHT_WHT,) if lossless else tx_search_set(speed, n, search[1])
    tx_syms = tuple(TX_SET_ALL.index(t) if t in TX_SET_ALL else 0 for t in txs)
    T = len(txs)
    mode_set = tuple(range(N_MODES)) if lossless else mode_search_set(speed, search[0])
    steps = _steps_mat(n, dc_step, ac_step)
    # Integer lambda for SSE (8-bit-scaled) + lam·bits cost. acs8 is the AC
    # step in 8-bit pixel units; transform gain is 2^3 over orthonormal, so
    # qstep_pix = acs8/8. Swept on kodim23: ~0.06·qstep_pix² is the RD
    # (re-swept after the v2 entropy model: 12/15/18/21 x/16000 all move
    # along the same kodim RD curve, so 15 stays; the 3+2·bitlen proxy
    # also re-checked against ladder-shaped variants — rank-equivalent)
    # sweet spot (+0.1 dB at matched rate vs the textbook 0.12).
    dshift = depth - 8
    acs8 = ac_step >> dshift if dshift else ac_step
    lam = jnp.maximum(1, (acs8 * acs8 * 15) // 16000).astype(jnp.int32)

    src_blocks = src.reshape(rb, n, cb, n).transpose(0, 2, 1, 3)  # (Rb,Cb,n,n)
    cc, _, _ = _diag_indices(rb, cb)
    src_diag = _to_diag(src_blocks, cc)  # (D, L, n, n)

    def step(carry, xs):
        sb, c_arr = xs
        top, left, topleft = _wavefront_neighbors(carry, c_arr, mid)
        preds = predict_all_modes(top, left, topleft, n)  # (L, 13, n, n)
        if len(mode_set) < preds.shape[1]:
            preds = preds[:, jnp.asarray(mode_set, dtype=jnp.int32)]
        resid = sb[:, None] - preds  # (L, M, n, n)
        rflat = resid.reshape(-1, n, n)

        lv_c, cand_c = [], []
        for t in txs:
            coeffs = forward_transform(rflat, t, n)
            if lossless:
                lv_t = coeffs
                deq = lv_t
            else:
                # Deadzone quantization (encoder-only): AC rounds with a
                # 3/8 bias toward zero (saves rate for near-threshold
                # coefficients), DC keeps round-half (the deadzone is an
                # encoder decision; the bitstream/dequant is unchanged).
                bias = (steps[None] * 3) // 8
                bias = bias.at[:, 0, 0].set(steps[0, 0] // 2)
                mag = (jnp.abs(coeffs) + bias) // steps[None]
                lv_t = jnp.sign(coeffs) * mag
                deq = lv_t * steps[None]
            res_hat = inverse_transform(deq, t, n).reshape(resid.shape)
            lv_c.append(lv_t.reshape(resid.shape))
            cand_c.append(jnp.clip(preds + res_hat, 0, maxv))
        lv = jnp.stack(lv_c, axis=2)  # (L, M, T, n, n)
        cand = jnp.stack(cand_c, axis=2)

        err = sb[:, None, None] - cand
        if dshift:
            err = err >> dshift
        sse = jnp.sum(err * err, axis=(-1, -2))  # (L, M, T)
        bits = _rate_bits(lv)  # (L, M, T)
        cost = (sse + lam * bits).reshape(sse.shape[0], -1)  # (L, M*T)
        best = jnp.argmin(cost, axis=1).astype(jnp.int32)
        best_mode = best // T
        best_tx = best % T

        flat_lv = lv.reshape(lv.shape[0], -1, n, n)
        flat_cand = cand.reshape(cand.shape[0], -1, n, n)
        sel = best[:, None, None, None]
        best_lv = jnp.take_along_axis(flat_lv, sel, axis=1)[:, 0]
        best_rec = jnp.take_along_axis(flat_cand, sel, axis=1)[:, 0]
        # map search index -> bitstream symbol
        sym_table = jnp.asarray(tx_syms, dtype=jnp.int32)
        best_tx_sym = sym_table[best_tx]
        mode_table = jnp.asarray(mode_set, dtype=jnp.int32)
        best_mode = mode_table[best_mode]

        carry = (best_rec[:, -1, :], best_rec[:, :, -1], top[:, -1])
        return carry, (best_mode, best_lv, best_rec, best_tx_sym)

    L = rb
    init = (
        jnp.full((L, n), mid, jnp.int32),
        jnp.full((L, n), mid, jnp.int32),
        jnp.full((L,), mid, jnp.int32),
    )
    _, (modes_diag, lv_diag, rec_diag, tx_diag) = jax.lax.scan(
        step, init, (src_diag, cc)
    )
    modes = _from_diag(modes_diag, rb, cb)
    levels = _from_diag(lv_diag, rb, cb)
    recon = _blocks_to_plane(_from_diag(rec_diag, rb, cb), rb, cb, n)
    tx_types = _from_diag(tx_diag, rb, cb)
    return modes, levels, recon, tx_types


# ------------------------------------------------- packed frame-level calls
#
# Every host<->device copy pays a fixed latency on top of its bytes, so
# the frame layer ships ALL planes in one packed buffer and gets all
# results back in one packed buffer: exactly one upload and one fetch per
# frame (SURVEY.md §7 hard-parts #6, host/device boundary hygiene).
#
# Packing layout per plane, concatenated in plane order:
#   [modes (Rb*Cb)] [tx_types (Rb*Cb)] [levels (Rb*Cb*n*n)]
# packed dtype: int16 for lossy (|level| <= ~10880 by construction),
# int32 for lossless (WHT levels need 17+ bits).


def plane_geometry(dims, n: int):
    """[(w, h)] -> tuple of (rb, cb) per plane."""
    return tuple((-(-h // n), -(-w // n)) for (w, h) in dims)


def pack_dtype(lossless: bool):
    return jnp.int32 if lossless else jnp.int16


@functools.partial(
    jax.jit, static_argnames=("geoms", "n", "depth", "lossless", "speed", "search")
)
def encode_frame_device(packed, dc_step, ac_step, *, geoms, n: int, depth: int, lossless: bool, speed: int = 6,
                        search: tuple = (None, None)):
    """packed: 1-D uint8/uint16 concat of padded planes (per `geoms`
    (rb, cb) entries). Returns a single 1-D int16/int32 result buffer.

    Same-geometry planes (U and V, grid cells) are grouped and vmapped so
    the compiled program contains ONE wavefront body per distinct shape —
    program size drives compile time."""
    out_dtype = pack_dtype(lossless)
    # plane index -> (offset, geom); group by geom preserving output order
    offs = []
    off = 0
    for rb, cb in geoms:
        offs.append(off)
        off += rb * cb * n * n
    groups: dict = {}
    for i, g in enumerate(geoms):
        groups.setdefault(g, []).append(i)

    results: list = [None, None, None] * len(geoms)
    for (rb, cb), idxs in groups.items():
        hp, wp = rb * n, cb * n
        planes = jnp.stack(
            [
                jax.lax.dynamic_slice(packed, (offs[i],), (hp * wp,))
                .reshape(hp, wp)
                .astype(jnp.int32)
                for i in idxs
            ]
        )
        enc = jax.vmap(
            lambda p: _encode_impl(p, dc_step, ac_step, n, depth, lossless, speed, search)
        )
        modes, levels, _, txs = enc(planes)
        for k, i in enumerate(idxs):
            results[3 * i] = modes[k].reshape(-1).astype(out_dtype)
            results[3 * i + 1] = txs[k].reshape(-1).astype(out_dtype)
            results[3 * i + 2] = levels[k].reshape(-1).astype(out_dtype)
    return jnp.concatenate(results)


@functools.partial(
    jax.jit, static_argnames=("geoms", "n", "depth", "lossless", "deblock", "cdef")
)
def decode_frame_device(
    packed, dc_step, ac_step, deblock_thresh, cdef_thresh=0, *, geoms, n: int,
    depth: int, lossless: bool, deblock: bool = False, cdef: bool = False,
):
    """packed: 1-D int16/int32 [modes, levels] per plane. Returns 1-D
    uint8/uint16 concat of reconstructed padded planes. Same-geometry
    planes share one vmapped wavefront body (see encode_frame_device).
    When `deblock` is set, the output pass applies the in-loop deblocking
    filter (ops/filters.py) — a fully parallel whole-plane op."""
    out_dtype = jnp.uint8 if depth == 8 else jnp.uint16
    offs = []
    off = 0
    for rb, cb in geoms:
        offs.append(off)
        off += 2 * rb * cb + rb * cb * n * n
    groups: dict = {}
    for i, g in enumerate(geoms):
        groups.setdefault(g, []).append(i)

    results: list = [None] * len(geoms)
    for (rb, cb), idxs in groups.items():
        nb = rb * cb
        modes = jnp.stack(
            [
                jnp.clip(
                    jax.lax.dynamic_slice(packed, (offs[i],), (nb,))
                    .reshape(rb, cb)
                    .astype(jnp.int32),
                    0,
                    N_MODES - 1,
                )
                for i in idxs
            ]
        )
        txs = jnp.stack(
            [
                jnp.clip(
                    jax.lax.dynamic_slice(packed, (offs[i] + nb,), (nb,))
                    .reshape(rb, cb)
                    .astype(jnp.int32),
                    0,
                    N_TX - 1,
                )
                for i in idxs
            ]
        )
        levels = jnp.stack(
            [
                jax.lax.dynamic_slice(packed, (offs[i] + 2 * nb,), (nb * n * n,))
                .reshape(rb, cb, n, n)
                .astype(jnp.int32)
                for i in idxs
            ]
        )
        dec = jax.vmap(
            lambda lv, md, tx: _decode_impl(lv, md, tx, dc_step, ac_step, n, depth, lossless)
        )
        planes = dec(levels, modes, txs)
        if deblock:
            planes = jax.vmap(lambda pl: deblock_plane(pl, deblock_thresh, n=n))(planes)
        if cdef:
            planes = jax.vmap(lambda pl: cdef_plane(pl, cdef_thresh))(planes)
        for k, i in enumerate(idxs):
            results[i] = planes[k].reshape(-1).astype(out_dtype)
    return jnp.concatenate(results)


def _encode_impl(src, dc_step, ac_step, n, depth, lossless, speed=6, search=(None, None)):
    return encode_plane.__wrapped__(
        src, dc_step, ac_step, n=n, depth=depth, lossless=lossless, speed=speed,
        search=search,
    )


def _decode_impl(levels, modes, tx_types, dc_step, ac_step, n, depth, lossless):
    return decode_plane.__wrapped__(
        levels, modes, dc_step, ac_step, tx_types, n=n, depth=depth, lossless=lossless
    )


assert N_MODES == 13  # entropy layer alphabet size; bump both together
