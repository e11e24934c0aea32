"""Device (JAX/XLA) batch kernels for the spec encoder's RD pre-pass.

Moves plan_luma's hot loops — batched intra prediction for every
candidate mode, SATD, and the quant-aware RD stage (orthonormal DCT +
quantizer + bit model) — onto the accelerator as a SINGLE jitted
program per frame shape. All blocks of every searched size, all modes,
and all transform sizes are evaluated together as large batched GEMMs
and gathers (the batched formulation of libaom's per-block intra RD,
codec_aom.c:695-726 role). One device round-trip returns one packed
f32 vector with every cost table; the partition/depth dynamic program
stays on the host (tiny, decision-heavy).

Numerics, and which results depend on the backend:
- SATD and the angle-delta argmins are exact on every backend: the
  Hadamard entries are ±1 and every sum stays below 2^24, so the f32
  GEMM is exact, and the argmin runs over those exact integers.
- The quant stage's dist and rate tables are f32 sums, and XLA's GPU
  and CPU backends take them in different orders (every dot runs at
  Precision.HIGHEST, so there is no TF32 rounding on top). At 4032x3024
  on an H100 (700 W) against the CPU backend, dist differed by at most
  4.2e-6 relative and unflipped rate entries by 4.2e-7; 753 of 13.2M
  rate entries (5.7e-5) moved because a coefficient on a rounding
  boundary quantised to the neighbouring level, by at most 1.45
  coefficients' bits (0.24 % relative). At 768x512, qindex 100, one
  entry moved by more than two coefficients' bits. The bounds checked
  are DIST_RATE_RTOL and RATE_FLIP_SHARE below. The numpy reference sums in f64, so its integer
  costs can differ in the same way.
- Such ulp differences can flip near-tie RD decisions, so the chosen
  plan, and with it the stream, may differ between backends and
  between this program and the numpy planner. Each stream stays
  conformant AV1: the planner only chooses; reconstruction is spec-exact.

Set LIBAVIF_TPU_DEVICE_RD=0 to force the numpy path.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from . import intra as I

__all__ = [
    "plan_costs_device", "dispatch_plan_costs", "materialize_plan_costs",
    "cost_program", "available",
]

# How far the dist/rate tables of two backends may differ (f32 sums in
# another order; see the module docstring): every dist entry agrees to
# DIST_RATE_RTOL relative, and so does every rate entry except at most
# RATE_FLIP_SHARE of them, in which coefficients sitting on a rounding
# boundary went to the neighbouring level. Such a flip moves the entry by
# up to one coefficient's bits (_COEF_NZ_X16 + _COEF_MAG_X16) per
# coefficient, and a block can hold several boundary coefficients, so
# the size of a flip is reported, not bounded (chip_smoke.py).
DIST_RATE_RTOL = 1e-5
RATE_FLIP_SHARE = 1e-3

# Transform sizes up to this use one flat GEMM against kron(M, M) instead
# of two small-K einsums (see _compiled): on an H100 (700 W) the kron
# form took 0.96 ms against 3.1 ms at txs 8 and 2.06 ms against 2.66 ms
# at txs 16, over a 4032x3024 frame's quant-stage batch.
_KRON_MAX_TXS = 16

# Frames below this many pixels stay on the numpy planner: each frame
# shape compiles its own program, which only pays off for real frames.
_MIN_PELS = 131072


def available() -> bool:
    return os.environ.get("LIBAVIF_TPU_DEVICE_RD", "1") != "0"


# ----------------------------------------------------------- jit body


def _hadamard(n):
    h = np.array([[1]], dtype=np.float32)
    h2 = np.array([[1, 1], [1, -1]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.kron(h2, h)
    return h


_DIR_DELTAS = (-3, -2, -1, 1, 2, 3)


def _dir_index_tables(mode, px, angle):
    """Static gather index/shift tables for one directional (mode, angle)
    at size px (mirrors rdsearch._directional; ext arrays are
    [corner, border(2px), pad] so ref i -> i+1)."""
    dr = I._dr_derivative()
    h = w = px
    ext_len = 1 + 2 * px + max(0, (w + h + 16) - 2 * px)
    ii = np.arange(h).reshape(h, 1)
    jj = np.arange(w).reshape(1, w)
    if angle < 90:
        dx = int(dr[angle])
        idx = (ii + 1) * dx
        base = np.minimum((idx >> 6) + jj, w + h - 1)
        shift = np.broadcast_to((idx >> 1) & 0x1F, (h, w))
        b0 = np.clip(base + 1, 0, ext_len - 1)
        b1 = np.clip(base + 2, 0, ext_len - 1)
        return ("a", b0, b1, shift, None, None, None, None)
    if angle > 180:
        dy = int(dr[270 - angle])
        idx = (jj + 1) * dy
        base = np.minimum((idx >> 6) + ii, w + h - 1)
        shift = np.broadcast_to((idx >> 1) & 0x1F, (h, w))
        b0 = np.clip(base + 1, 0, ext_len - 1)
        b1 = np.clip(base + 2, 0, ext_len - 1)
        return ("l", b0, b1, shift, None, None, None, None)
    dx = int(dr[180 - angle])
    dy = int(dr[angle - 90])
    idx = (jj << 6) - (ii + 1) * dx
    base = idx >> 6
    shift = np.broadcast_to((idx >> 1) & 0x1F, (h, w))
    b0 = np.clip(base + 1, 0, ext_len - 1)
    b1 = np.clip(base + 2, 0, ext_len - 1)
    idx2 = (ii << 6) - (jj + 1) * dy
    base2 = idx2 >> 6
    shift2 = np.broadcast_to((idx2 >> 1) & 0x1F, (h, w))
    c0 = np.clip(base2 + 1, 0, ext_len - 1)
    c1 = np.clip(base2 + 2, 0, ext_len - 1)
    return ("b", b0, b1, shift, c0, c1, shift2, base >= -1)


def _ortho_dct(n):
    k = np.arange(n).reshape(-1, 1)
    i = np.arange(n).reshape(1, -1)
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _compiled(H, W, speed, bd, nplanes_unused=0):
    """Build + jit the whole-frame cost program for one frame shape."""
    import jax
    import jax.numpy as jnp
    from jax.lax import Precision

    from .rdsearch import (_MODE_BITS_X16, _ANGLE_BITS_X16, _COEF_NZ_X16,
                           _COEF_MAG_X16, _TXB_RATE_X16, _LOG2_LUT,
                           _valid_depths, speed_config)

    cfg = speed_config(speed)
    sizes = tuple(sorted(cfg["sizes"]))
    cand_modes = tuple(sorted(int(m) for m in cfg["modes"]))
    search_depth = speed <= 7
    txs_cfg = tuple(sorted(
        {px >> d for px in sizes for d in (_valid_depths(px) if search_depth else (0,))}
    ))
    all_px = tuple(sorted(set(sizes) | set(txs_cfg)))
    base = 1 << (bd - 1)
    sm_w = {k: v.astype(np.int32) for k, v in I._sm_weights().items()}
    dir_modes = tuple(m for m in cand_modes if I.is_directional(m))

    # layout of the packed output vector
    layout = []   # (kind, key, shape)
    off = 0

    def reserve(kind, key, shape):
        nonlocal off
        n = int(np.prod(shape))
        layout.append((kind, key, shape, off, off + n))
        off += n

    grid = {}
    for px in all_px:
        rows = -(-H // px)
        cols = -(-W // px)
        grid[px] = (rows, cols)
        if px in sizes:
            reserve("satd", px, (len(cand_modes), rows * cols))
            if px * px >= 64 and dir_modes:
                reserve("delta", px, (len(dir_modes), rows * cols))
    for txs in txs_cfg:
        rows, cols = grid[txs]
        reserve("dist", txs, (len(cand_modes), rows * cols))
        reserve("rate", txs, (len(cand_modes), rows * cols))
    total = off

    def borders(p, px):
        """blocks (n,px,px) i32, above (n,2px), left (n,2px), corner (n,)."""
        rows, cols = grid[px]
        Hp, Wp = rows * px, cols * px
        blocks = p.reshape(rows, px, cols, px).transpose(0, 2, 1, 3)
        pr = jnp.concatenate([p, jnp.repeat(p[:, -1:], px, axis=1)], axis=1)
        # above rows at y = k*px - 1 (k>=1); windows of 2px at col c*px
        ys = np.arange(1, rows) * px - 1
        cols_idx = (np.arange(cols) * px)[:, None] + np.arange(2 * px)[None, :]
        above = pr[ys][:, cols_idx]                     # (rows-1, cols, 2px)
        above = jnp.concatenate(
            [jnp.full((1, cols, 2 * px), base, jnp.int32), above], axis=0)
        pb = jnp.concatenate([p, jnp.repeat(p[-1:, :], px, axis=0)], axis=0)
        xs = np.arange(1, cols) * px - 1
        rows_idx = (np.arange(rows) * px)[:, None] + np.arange(2 * px)[None, :]
        left = pb[:, xs][rows_idx]                      # (rows, 2px, cols-1)
        left = left.transpose(0, 2, 1)                  # (rows, cols-1, 2px)
        left = jnp.concatenate(
            [jnp.full((rows, 1, 2 * px), base, jnp.int32), left], axis=1)
        corner = p[ys][:, xs]                           # (rows-1, cols-1)
        corner = jnp.concatenate(
            [jnp.full((1, cols - 1), base, jnp.int32), corner], axis=0)
        corner = jnp.concatenate(
            [jnp.full((rows, 1), base, jnp.int32), corner], axis=1)
        n = rows * cols
        return (blocks.reshape(n, px, px), above.reshape(n, 2 * px),
                left.reshape(n, 2 * px), corner.reshape(n))

    def predict(mode, above, left, corner, px, angle=None):
        n = above.shape[0]
        h = w = px
        if mode == I.DC_PRED:
            s = above[:, :w].sum(1) + left[:, :h].sum(1)
            return ((s + ((w + h) >> 1)) // (w + h))[:, None, None] * jnp.ones(
                (1, h, w), jnp.int32)
        # V/H with an angle delta are directional (angle-delta search)
        if mode == I.V_PRED and angle in (None, 90):
            return jnp.broadcast_to(above[:, None, :w], (n, h, w))
        if mode == I.H_PRED and angle in (None, 180):
            return jnp.broadcast_to(left[:, :h, None], (n, h, w))
        if mode == I.PAETH_PRED:
            a = above[:, None, :w]
            l = left[:, :h, None]
            c = corner[:, None, None]
            bse = a + l - c
            pa = jnp.abs(bse - a)
            pl = jnp.abs(bse - l)
            pc = jnp.abs(bse - c)
            return jnp.where((pa <= pl) & (pa <= pc),
                             jnp.broadcast_to(a, (n, h, w)),
                             jnp.where(pl <= pc, jnp.broadcast_to(l, (n, h, w)),
                                       jnp.broadcast_to(c, (n, h, w))))
        if mode in I.SMOOTH_MODES:
            a = above[:, None, :w]
            l = left[:, :h, None]
            below = left[:, h - 1][:, None, None]
            right = above[:, w - 1][:, None, None]
            if mode == I.SMOOTH_PRED:
                wy = sm_w[h].reshape(1, h, 1)
                wx = sm_w[w].reshape(1, 1, w)
                s = wy * a + (256 - wy) * below + wx * l + (256 - wx) * right
                return (s + 256) >> 9
            if mode == I.SMOOTH_V_PRED:
                wy = sm_w[h].reshape(1, h, 1)
                return (wy * a + (256 - wy) * below + 128) >> 8
            wx = sm_w[w].reshape(1, 1, w)
            return (wx * l + (256 - wx) * right + 128) >> 8
        # directional
        if angle is None:
            angle = I.MODE_TO_ANGLE[mode]
        kind, b0, b1, shift, c0, c1, shift2, use_a = _dir_index_tables(
            mode, px, angle)
        ext_a = jnp.concatenate(
            [corner[:, None], above,
             jnp.repeat(above[:, -1:], max(0, (w + h + 16) - 2 * px), axis=1)],
            axis=1)
        ext_l = jnp.concatenate(
            [corner[:, None], left,
             jnp.repeat(left[:, -1:], max(0, (w + h + 16) - 2 * px), axis=1)],
            axis=1)
        sh = jnp.asarray(shift, jnp.int32)
        if kind == "a":
            v = (ext_a[:, b0] * (32 - sh) + ext_a[:, b1] * sh + 16) >> 5
        elif kind == "l":
            v = (ext_l[:, b0] * (32 - sh) + ext_l[:, b1] * sh + 16) >> 5
        else:
            sh2 = jnp.asarray(shift2, jnp.int32)
            va = (ext_a[:, b0] * (32 - sh) + ext_a[:, b1] * sh + 16) >> 5
            vl = (ext_l[:, c0] * (32 - sh2) + ext_l[:, c1] * sh2 + 16) >> 5
            v = jnp.where(jnp.asarray(use_a)[None], va, vl)
        return jnp.clip(v, 0, (1 << bd) - 1)

    # --- intra predictions as ONE GEMM per block size -----------------
    # Every mode except PAETH is LINEAR in the border vector
    # ext1 = [corner, above(2px), left(2px), 1]: directional two-tap
    # interpolation, V/H copies, DC mean, smooth weighted blends. Bake
    # each (mode, angle) into a static (L1, px^2) matrix with the
    # dyadic scale + rounding bias folded in (all weights are exact
    # multiples of 1/512, so f32 is exact) — pred = floor(ext1 @ G),
    # clipped. Replaces a per-mode gather soup with one GEMM per stage.
    maxv_i = (1 << bd) - 1

    def _linear_G(mode, px, angle=None):
        h = w = px
        L1 = 4 * px + 2
        G = np.zeros((L1, h * w), np.float64)
        bias = L1 - 1
        cols = np.arange(h * w)
        ys, xs = cols // w, cols % w

        def a_col(i):  # ext_a index -> ext1 column
            return np.where(i <= 0, 0, np.minimum(i, 2 * px))

        def l_col(i):  # ext_l index -> ext1 column
            return np.where(i <= 0, 0, 2 * px + np.minimum(i, 2 * px))

        if mode == I.DC_PRED:
            G[1:1 + px, :] = 1.0 / (2 * px)
            G[2 * px + 1:3 * px + 1, :] = 1.0 / (2 * px)
            G[bias, :] = 0.5
        elif mode == I.V_PRED and angle in (None, 90):
            np.add.at(G, (1 + xs, cols), 1.0)
        elif mode == I.H_PRED and angle in (None, 180):
            np.add.at(G, (2 * px + 1 + ys, cols), 1.0)
        elif mode == I.SMOOTH_PRED:
            wy = sm_w[h][ys].astype(np.float64)
            wx = sm_w[w][xs].astype(np.float64)
            np.add.at(G, (1 + xs, cols), wy / 512)
            np.add.at(G, (np.full_like(cols, 2 * px + h), cols),
                      (256 - wy) / 512)
            np.add.at(G, (2 * px + 1 + ys, cols), wx / 512)
            np.add.at(G, (np.full_like(cols, w), cols), (256 - wx) / 512)
            G[bias, :] = 0.5
        elif mode == I.SMOOTH_V_PRED:
            wy = sm_w[h][ys].astype(np.float64)
            np.add.at(G, (1 + xs, cols), wy / 256)
            np.add.at(G, (np.full_like(cols, 2 * px + h), cols),
                      (256 - wy) / 256)
            G[bias, :] = 0.5
        elif mode == I.SMOOTH_H_PRED:
            wx = sm_w[w][xs].astype(np.float64)
            np.add.at(G, (2 * px + 1 + ys, cols), wx / 256)
            np.add.at(G, (np.full_like(cols, w), cols), (256 - wx) / 256)
            G[bias, :] = 0.5
        else:  # directional
            if angle is None:
                angle = I.MODE_TO_ANGLE[mode]
            kind, b0, b1, shift, c0, c1, shift2, use_a = _dir_index_tables(
                mode, px, angle)
            sh = shift.reshape(-1).astype(np.float64)
            if kind == "a":
                np.add.at(G, (a_col(b0.reshape(-1)), cols), (32 - sh) / 32)
                np.add.at(G, (a_col(b1.reshape(-1)), cols), sh / 32)
            elif kind == "l":
                np.add.at(G, (l_col(b0.reshape(-1)), cols), (32 - sh) / 32)
                np.add.at(G, (l_col(b1.reshape(-1)), cols), sh / 32)
            else:
                ua = use_a.reshape(-1)
                sh2 = shift2.reshape(-1).astype(np.float64)
                r0 = np.where(ua, a_col(b0.reshape(-1)),
                              l_col(c0.reshape(-1)))
                r1 = np.where(ua, a_col(b1.reshape(-1)),
                              l_col(c1.reshape(-1)))
                w0 = np.where(ua, (32 - sh) / 32, (32 - sh2) / 32)
                w1 = np.where(ua, sh / 32, sh2 / 32)
                np.add.at(G, (r0, cols), w0)
                np.add.at(G, (r1, cols), w1)
            G[bias, :] += 0.5
        return G

    gemm_pred = os.environ.get("LIBAVIF_TPU_RD_GEMM_PRED", "1") != "0"

    def pred_bank(px, variants, borders_px):
        """variants: list of (mode, angle|None) -> (V, n, px, px) i32."""
        blocks, above, left, corner = borders_px
        n = above.shape[0]
        outs = [None] * len(variants)
        Gcols, lin_pos = [], []
        for i, (m, ang) in enumerate(variants):
            if m == I.PAETH_PRED or not gemm_pred:
                outs[i] = predict(m, above, left, corner, px, angle=ang)
            else:
                Gcols.append(_linear_G(m, px, ang))
                lin_pos.append(i)
        if Gcols:
            G = jnp.asarray(np.concatenate(Gcols, 1).astype(np.float32))
            ext1 = jnp.concatenate(
                [corner[:, None], above, left,
                 jnp.ones((n, 1), jnp.int32)], axis=1).astype(jnp.float32)
            p = jnp.dot(ext1, G, precision=Precision.HIGHEST)
            p = jnp.clip(jnp.floor(p), 0, maxv_i).astype(jnp.int32)
            p = p.reshape(n, len(Gcols), px, px).transpose(1, 0, 2, 3)
            for k, i in enumerate(lin_pos):
                outs[i] = p[k]
        return jnp.stack(outs)

    # 2-D transforms as ONE flat GEMM per call: vec_row(M @ r @ M^T) =
    # vec_row(r) @ kron(M, M)^T. The einsum formulation contracts over
    # K = t (8..32); the kron form contracts over K = t^2 at t^2/2 times
    # the FLOPs, so it is used only for the small sizes.
    def _kron_t(M):
        k = np.kron(np.asarray(M, np.float64), np.asarray(M, np.float64))
        return jnp.asarray(k.T.astype(np.float32))

    kron_h = {t: _kron_t(_hadamard(t)) for t in (4, 8)}

    def satd(res, px):
        """res (n, px, px) int32 -> SATD (n,) int32. Hadamard entries
        are ±1, so the f32 GEMM is exact (values < 2^24)."""
        t = min(8, px)
        n = res.shape[0]
        r = res.astype(jnp.float32).reshape(n, px // t, t, px // t, t)
        r = r.transpose(0, 1, 3, 2, 4).reshape(-1, t * t)
        tr = jnp.dot(r, kron_h[t], precision=Precision.HIGHEST)
        s = jnp.abs(tr).astype(jnp.int32).reshape(n, -1).sum(axis=1)
        return s // (t * 2)

    kron_dct = {txs: _kron_t(_ortho_dct(txs))
                for txs in txs_cfg if txs <= _KRON_MAX_TXS}
    dct_m = {txs: jnp.asarray(_ortho_dct(min(txs, 64)))
             for txs in txs_cfg if txs > _KRON_MAX_TXS}

    def quant_cost(res, txs, qs, rq):
        """dist (n,), rate_x16 (n,) as f32."""
        n = res.shape[0]
        if txs in kron_dct:
            c = jnp.dot(res.astype(jnp.float32).reshape(n, txs * txs),
                        kron_dct[txs], precision=Precision.HIGHEST)
            dropped = 0.0
        elif txs <= 32:
            M = dct_m[txs]
            c = jnp.einsum("ab,nbc,dc->nad", M, res.astype(jnp.float32), M,
                           precision=Precision.HIGHEST).reshape(n, -1)
            dropped = 0.0
        else:
            M = dct_m[txs]
            c2 = jnp.einsum("ab,nbc,dc->nad", M, res.astype(jnp.float32), M,
                            precision=Precision.HIGHEST)
            dropped = (c2 * c2).reshape(n, -1).sum(1) - (
                c2[:, :32, :32] ** 2).reshape(n, -1).sum(1)
            c = c2[:, :32, :32].reshape(n, -1)
        qs = qs.reshape(-1)
        rq = rq.reshape(-1)
        lv = jnp.round(c * rq)
        err = c - lv * qs
        dist = (err * err).sum(1) + dropped
        alv = jnp.minimum(jnp.abs(lv), 4095.0)
        # log2(1+|lv|): arithmetic instead of a whole-frame gather from a
        # 4096-entry table
        rate = ((alv > 0).sum(1).astype(jnp.float32) * np.float32(_COEF_NZ_X16)
                + jnp.log2(1.0 + alv).sum(1) * np.float32(_COEF_MAG_X16)
                + np.float32(_TXB_RATE_X16))
        return dist, rate

    def body(src, lam_x16, qs_list, rq_list):
        out = jnp.zeros((total,), jnp.float32)
        pads = {}
        for px in all_px:
            rows, cols = grid[px]
            ph, pw = rows * px, cols * px
            p = src
            if ph > H:
                p = jnp.concatenate([p, jnp.repeat(p[-1:], ph - H, axis=0)], 0)
            if pw > W:
                p = jnp.concatenate([p, jnp.repeat(p[:, -1:], pw - W, axis=1)], 1)
            pads[px] = p

        bordered = {px: borders(pads[px], px) for px in all_px}

        for (kind, key, shape, lo, hi) in layout:
            if kind == "satd":
                px = key
                blocks, above, left, corner = bordered[px]
                use_angle = px * px >= 64
                # stack every mode's residual into ONE satd GEMM
                preds = pred_bank(px, [(m, None) for m in cand_modes],
                                  bordered[px])
                res = blocks[None] - preds            # (M, n, px, px)
                nM = len(cand_modes)
                cst = satd(res.reshape(-1, px, px), px).reshape(nM, -1)
                bits = np.array(
                    [_MODE_BITS_X16[m]
                     + (_ANGLE_BITS_X16
                        if I.is_directional(m) and use_angle else 0)
                     for m in cand_modes], np.int32)[:, None]
                rows = cst + ((lam_x16 * bits) >> 4)
                out = out.at[lo:hi].set(rows.astype(jnp.float32).reshape(-1))
            elif kind == "delta":
                px = key
                blocks, above, left, corner = bordered[px]
                # all (dir mode, angle delta) residuals in one satd GEMM
                dts = [0] + list(_DIR_DELTAS)
                preds = pred_bank(
                    px,
                    [(m, I.MODE_TO_ANGLE[m] + 3 * d)
                     for m in dir_modes for d in dts],
                    bordered[px])
                res = blocks[None] - preds
                cst = satd(res.reshape(-1, px, px), px).reshape(
                    len(dir_modes), len(dts), -1)
                bi = jnp.argmin(cst, axis=1)          # (Mdir, n)
                rowsv = jnp.asarray(np.array(dts, np.int32))[bi]
                out = out.at[lo:hi].set(rowsv.astype(jnp.float32).reshape(-1))
            elif kind == "dist":
                txs = key
                blocks, above, left, corner = bordered[txs]
                qs = qs_list[txs_cfg.index(txs)]
                rq = rq_list[txs_cfg.index(txs)]
                preds = pred_bank(txs, [(m, None) for m in cand_modes],
                                  bordered[txs])
                res = (blocks[None] - preds).reshape(-1, txs, txs)
                dist, rate = quant_cost(res, txs, qs, rq)
                nM = len(cand_modes)
                out = out.at[lo:hi].set(dist.reshape(nM, -1).reshape(-1))
                # matching rate entry comes right after in layout
                (k2, key2, shape2, lo2, hi2) = layout[
                    [i for i, e in enumerate(layout)
                     if e[0] == "rate" and e[1] == txs][0]]
                out = out.at[lo2:hi2].set(rate.reshape(nM, -1).reshape(-1))
            # "rate" handled with dist
        return out

    fn = jax.jit(body)
    meta = dict(layout=layout, total=total, sizes=sizes, txs_cfg=txs_cfg,
                cand_modes=cand_modes, dir_modes=dir_modes, grid=grid)
    return fn, meta


def plan_costs_device(src: np.ndarray, qindex: int, speed: int, bd: int):
    """Run the whole-frame cost program synchronously. Returns dict with:
    satd[px] -> (nmodes, rows, cols) int64 cost (SATD + lambda*rate),
    delta[px] -> (ndirmodes, rows, cols) int angle-delta argmin,
    qcost[txs][mode] -> (rows, cols) int64, plus 'cand_modes'/'dir_modes'.
    None when disabled or the frame is below the device gate."""
    return materialize_plan_costs(dispatch_plan_costs(src, qindex, speed, bd))


def cost_program(src: np.ndarray, qindex: int, speed: int, bd: int):
    """(fn, meta, args, lam_sse_x16): the jitted whole-frame cost program
    for src's shape and its host-side arguments; fn(*args) is the packed
    f32 table vector laid out as meta["layout"]."""
    from .rdsearch import _LAM_RD_C, _quant_ctx, _tx_gain
    from . import tables as T

    H, W = src.shape
    fn, meta = _compiled(H, W, speed, bd)
    lam_x16 = max(1, T.ac_q(qindex, bd) >> 1)
    dcq = T.dc_q(qindex, bd)
    acq = T.ac_q(qindex, bd)
    step16 = float(acq) * _tx_gain(16)
    lam_sse_x16 = max(1, int(round(_LAM_RD_C * step16 * step16 * 16)))
    qs_list = []
    rq_list = []
    for txs in meta["txs_cfg"]:
        _, _, qs, rq = _quant_ctx(txs, dcq, acq)
        qs_list.append(np.asarray(qs))
        rq_list.append(np.asarray(rq))
    args = (np.ascontiguousarray(src, dtype=np.int32), np.int32(lam_x16),
            tuple(qs_list), tuple(rq_list))
    return fn, meta, args, lam_sse_x16


def dispatch_plan_costs(src: np.ndarray, qindex: int, speed: int, bd: int):
    """Queue the whole-frame cost program on the device and return an
    opaque handle (None when disabled or the frame is below the device
    gate); materialize_plan_costs(handle) blocks and unpacks the tables.
    A failure of the device program propagates."""
    if not available():
        return None
    H, W = src.shape
    if H < 8 or W < 8 or H * W < int(
            os.environ.get("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", _MIN_PELS)):
        return None
    fn, meta, args, lam_sse_x16 = cost_program(src, qindex, speed, bd)
    out = fn(*args)
    # XLA has queued the program; start the device->host copy now so that
    # materialize only waits. Batch encoders dispatch every frame's
    # program up front, so device RD for frame k+1 overlaps host entropy
    # for frame k (codec/frame.py encode_frames_pipelined).
    out.copy_to_host_async()
    return (out, meta, lam_sse_x16)


def materialize_plan_costs(handle):
    """Block on a dispatch_plan_costs handle and unpack the cost tables."""
    if handle is None:
        return None
    out, meta, lam_sse_x16 = handle
    flat = np.asarray(out)
    res = {"satd": {}, "delta": {}, "qcost": {},
           "cand_modes": list(meta["cand_modes"]),
           "dir_modes": list(meta["dir_modes"]),
           "lam_sse_x16": lam_sse_x16}
    for (kind, key, shape, lo, hi) in meta["layout"]:
        arr = flat[lo:hi].reshape(shape)
        rows, cols = meta["grid"][key]
        if kind == "satd":
            res["satd"][key] = arr.astype(np.int64).reshape(-1, rows, cols)
        elif kind == "delta":
            res["delta"][key] = arr.astype(np.int64).reshape(-1, rows, cols)
        elif kind == "dist":
            res.setdefault("_dist", {})[key] = arr
        elif kind == "rate":
            res.setdefault("_rate", {})[key] = arr
    for txs in meta["txs_cfg"]:
        dist = res["_dist"][txs].astype(np.float64)
        rate = res["_rate"][txs].astype(np.float64)
        rows, cols = meta["grid"][txs]
        cost = np.rint(dist + (lam_sse_x16 * rate) / 256.0).astype(np.int64)
        res["qcost"][txs] = {
            m: cost[i].reshape(rows, cols)
            for i, m in enumerate(meta["cand_modes"])
        }
    res.pop("_dist", None)
    res.pop("_rate", None)
    return res
