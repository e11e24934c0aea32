"""Device (XLA) RD pre-pass: the jitted whole-frame cost program must
produce a valid plan whose encode decodes bit-exact by both our decoder
and the reference dav1d (via the bundled-libavif oracle), at quality
comparable to the numpy path."""

import os

import numpy as np
import pytest

from libavif_tpu.api import Decoder, encode


def _smooth(h, w, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 8, w + 8, 3)).astype(np.float32)
    k = 5
    c = np.cumsum(np.cumsum(base, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    sm = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)
    return np.clip(sm[:h, :w], 0, 255).astype(np.uint8)


@pytest.fixture()
def big_image():
    from libavif_tpu.constants import PixelFormat
    from libavif_tpu.image import Image

    rgb = _smooth(256, 512).astype(np.float32)
    im = Image(512, 256, 8, PixelFormat.YUV420)
    im.allocate_planes("yuv")
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    im.yuv_planes[0][:] = np.clip(y, 0, 255).astype(np.uint8)
    im.yuv_planes[1][:] = np.clip(
        128 + (rgb[0::2, 0::2, 2] - y[0::2, 0::2]) / 2, 0, 255
    ).astype(np.uint8)
    im.yuv_planes[2][:] = np.clip(
        128 + (rgb[0::2, 0::2, 0] - y[0::2, 0::2]) / 2, 0, 255
    ).astype(np.uint8)
    return im


def test_device_rd_conformant_and_comparable(big_image, monkeypatch):
    from libavif_tpu.codec.av1 import rdsearch_device as RDD

    if not RDD.available():
        pytest.skip("jax unavailable")
    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", "1")
    RDD._compiled.cache_clear()

    used = {}
    orig = RDD.plan_costs_device

    def probe(*a, **k):
        r = orig(*a, **k)
        used["dev"] = r is not None
        return r

    monkeypatch.setattr(RDD, "plan_costs_device", probe)
    data_dev = encode(big_image, quality=70, speed=6)
    assert used.get("dev"), "device path did not engage"

    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD", "0")
    data_host = encode(big_image, quality=70, speed=6)

    def ypsnr(data):
        d = Decoder()
        d.parse(data)
        d.next_image()
        a = d.image.yuv_planes[0].astype(np.float64)
        b = big_image.yuv_planes[0].astype(np.float64)
        return 10 * np.log10(255.0**2 / np.mean((a - b) ** 2))

    p_dev, p_host = ypsnr(data_dev), ypsnr(data_host)
    # same operating point: sizes within 10%, PSNR within 0.3 dB
    assert abs(len(data_dev) - len(data_host)) < 0.1 * len(data_host)
    assert abs(p_dev - p_host) < 0.3

    # reference decoder accepts the device-planned stream
    from libavif_tpu.interop import libavif_oracle as O

    if O.available():
        assert O.decode(data_dev) is not None


def _plane(h, w, bd, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << bd, (h + 8, w + 8)).astype(np.float64)
    k = 5
    c = np.pad(np.cumsum(np.cumsum(base, 0), 1), ((1, 0), (1, 0)))
    sm = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)
    return np.clip(sm[:h, :w], 0, (1 << bd) - 1).astype(np.int32)


@pytest.mark.parametrize("hw", [(37, 61), (72, 106)])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("speed", [5, 6])
def test_satd_and_delta_tables_equal_numpy(speed, bd, hw):
    """The device program's SATD and angle-delta tables are exact: they
    equal a numpy recomputation with the planner's own predictors."""
    from libavif_tpu.codec.av1 import intra as I
    from libavif_tpu.codec.av1 import rdsearch as R
    from libavif_tpu.codec.av1 import rdsearch_device as RDD
    from libavif_tpu.codec.av1 import tables as T

    src = _plane(*hw, bd, seed=speed + bd)
    q = 100
    fn, meta, args, _ = RDD.cost_program(src, q, speed, bd)
    flat = np.asarray(fn(*args))
    lam_x16 = max(1, T.ac_q(q, bd) >> 1)
    dts = [0, -3, -2, -1, 1, 2, 3]
    seen = set()
    for kind, px, shape, lo, hi in meta["layout"]:
        if kind not in ("satd", "delta"):
            continue
        seen.add(kind)
        tab = flat[lo:hi].reshape(shape).astype(np.int64)
        blocks, above, left, corner, _, _ = R._borders_for_size(src, px, bd)
        n = blocks.shape[0]
        modes = meta["cand_modes"] if kind == "satd" else meta["dir_modes"]
        for i, m in enumerate(modes):
            if kind == "satd":
                want = R.satd(blocks - R.predict_batch(m, above, left, corner, n, px, px, bd))
                bits = R._MODE_BITS_X16[m] + (
                    R._ANGLE_BITS_X16 if I.is_directional(m) and px * px >= 64 else 0)
                want = want + ((lam_x16 * bits) >> 4)
            else:
                # the planner's own refinement: base prediction for delta
                # 0, plain directional interpolation for the others
                costs = np.stack([
                    R.satd(blocks - (R.predict_batch(m, above, left, corner, n, px, px, bd)
                                     if d == 0 else R._directional(
                        above, left, corner, n, px, px, m, bd,
                        angle=I.MODE_TO_ANGLE[m] + 3 * d)))
                    for d in dts])
                want = np.asarray(dts)[np.argmin(costs, axis=0)]
            np.testing.assert_array_equal(tab[i], want, err_msg=f"{kind} px={px} mode={m}")
    assert seen == {"satd", "delta"}


def _raising_program(*a, **k):
    def fn(*args):
        raise RuntimeError("device program failed")

    return fn, {"txs_cfg": ()}


@pytest.mark.parametrize("batch", [False, True], ids=["encode", "encode_batch"])
def test_device_rd_failure_propagates(big_image, monkeypatch, batch):
    """No silent numpy fallback: a failing device RD program fails the encode."""
    from libavif_tpu.api import encode_batch
    from libavif_tpu.codec.av1 import rdsearch_device as RDD

    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", "1")
    monkeypatch.setattr(RDD, "_compiled", _raising_program)
    with pytest.raises(RuntimeError, match="device program failed"):
        if batch:
            encode_batch([big_image, big_image], quality=70, speed=6)
        else:
            encode(big_image, quality=70, speed=6)
