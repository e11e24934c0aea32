"""Public API tests: Encoder/Decoder full-file roundtrips.

Mirrors the reference tiers avifbasictest.cc (roundtrip), avifgridapitest.cc
(grid rules), avifanimationtest.cc, avifmetadatatest.cc (SURVEY.md §4).
"""

import numpy as np
import pytest

from libavif_tpu.api import Decoder, Encoder, decode, encode
from libavif_tpu.constants import (
    AvifError,
    PixelFormat,
    Range,
    Result,
    TransformFlags,
)
from libavif_tpu.image import Image, ImageRotation


def make_image(width, height, depth=8, fmt=PixelFormat.YUV420, seed=0, alpha=False):
    rng = np.random.default_rng(seed)
    img = Image(width, height, depth, fmt)
    img.allocate_planes("yuv")
    maxv = (1 << depth) - 1
    yy, xx = np.mgrid[0:height, 0:width]
    img.yuv_planes[0][:] = ((yy * 5 + xx * 3) * maxv // (5 * height + 3 * width)).astype(
        img.dtype
    )
    for c in (1, 2):
        if img.yuv_planes[c] is not None:
            img.yuv_planes[c][:] = rng.integers(
                maxv // 4, 3 * maxv // 4, img.yuv_planes[c].shape
            ).astype(img.dtype)
    if alpha:
        img.alpha_plane = np.zeros((height, width), dtype=img.dtype)
        img.alpha_plane[: height // 2] = maxv  # half transparent: no elision
    return img


class TestStillRoundtrip:
    def test_lossless_bit_exact(self):
        img = make_image(48, 32)
        data = encode(img, quality=100)
        assert data[4:8] == b"ftyp"
        out = decode(data)
        for c in range(3):
            np.testing.assert_array_equal(out.yuv_planes[c], img.yuv_planes[c])

    def test_lossy_psnr(self):
        img = make_image(48, 32)
        data = encode(img, quality=75)
        out = decode(data)
        err = out.yuv_planes[0].astype(np.int64) - img.yuv_planes[0].astype(np.int64)
        mse = float(np.mean(err**2))
        assert mse == 0 or 10 * np.log10(255**2 / mse) > 35

    def test_alpha_roundtrip(self):
        img = make_image(48, 32, alpha=True)
        data = encode(img, quality=100)
        d = Decoder()
        out = d.read(data)
        assert d.alpha_present
        np.testing.assert_array_equal(out.alpha_plane, img.alpha_plane)

    def test_opaque_alpha_elided(self):
        """write.c:1884-1902: fully-opaque alpha produces no aux item."""
        img = make_image(48, 32)
        img.alpha_plane = np.full((32, 48), 255, dtype=np.uint8)
        data = encode(img, quality=100)
        d = Decoder()
        d.read(data)
        assert not d.alpha_present

    def test_cicp_and_range_roundtrip(self):
        img = make_image(48, 32)
        img.color_primaries = 9
        img.transfer_characteristics = 16
        img.matrix_coefficients = 9
        img.yuv_range = Range.LIMITED
        out = decode(encode(img, quality=90))
        assert int(out.color_primaries) == 9
        assert int(out.transfer_characteristics) == 16
        assert int(out.matrix_coefficients) == 9
        assert out.yuv_range == Range.LIMITED

    def test_metadata_exif_xmp_transforms(self):
        img = make_image(48, 32)
        img.exif = b"II*\x00exifdata"
        img.xmp = b"<x:xmpmeta/>"
        img.transform_flags = TransformFlags.IROT
        img.irot = ImageRotation(angle=1)
        out = decode(encode(img, quality=90))
        assert out.exif == img.exif
        assert out.xmp == img.xmp
        assert out.transform_flags & TransformFlags.IROT
        assert out.irot.angle == 1

    def test_depth_10(self):
        img = make_image(48, 32, depth=10, fmt=PixelFormat.YUV444)
        out = decode(encode(img, quality=100))
        assert out.depth == 10
        for c in range(3):
            np.testing.assert_array_equal(out.yuv_planes[c], img.yuv_planes[c])


class TestGrid:
    def test_grid_roundtrip(self):
        cells = [make_image(64, 64, seed=i) for i in range(4)]
        enc = Encoder()
        enc.quality = 100
        data = enc.write_grid(cells, columns=2, rows=2)
        out = decode(data)
        assert (out.width, out.height) == (128, 128)
        for idx, cell in enumerate(cells):
            r, c = divmod(idx, 2)
            got = out.yuv_planes[0][r * 64 : (r + 1) * 64, c * 64 : (c + 1) * 64]
            np.testing.assert_array_equal(got, cell.yuv_planes[0])

    def test_grid_cell_too_small_rejected(self):
        """MIAF 64px minimum (avif.c:1034)."""
        cells = [make_image(32, 32, seed=i) for i in range(4)]
        enc = Encoder()
        with pytest.raises(AvifError) as e:
            enc.write_grid(cells, columns=2, rows=2)
        assert e.value.result == Result.INVALID_IMAGE_GRID

    def test_grid_count_mismatch(self):
        cells = [make_image(64, 64) for _ in range(3)]
        with pytest.raises(AvifError):
            Encoder().write_grid(cells, columns=2, rows=2)


class TestAnimation:
    def test_animation_roundtrip(self):
        frames = [make_image(48, 32, seed=i) for i in range(3)]
        enc = Encoder()
        enc.quality = 100
        enc.timescale = 30
        for f in frames:
            enc.add_image(f, duration=10)
        data = enc.finish()
        d = Decoder()
        d.parse(data)
        assert d.image_count == 3
        assert d.timescale == 30
        i = 0
        while d.next_image():
            np.testing.assert_array_equal(
                d.image.yuv_planes[0], frames[i].yuv_planes[0]
            )
            i += 1
        assert i == 3

    def test_nth_image_random_access(self):
        frames = [make_image(48, 32, seed=i) for i in range(3)]
        enc = Encoder()
        enc.quality = 100
        for f in frames:
            enc.add_image(f)
        data = enc.finish()
        d = Decoder()
        d.parse(data)
        img2 = d.nth_image(2)
        np.testing.assert_array_equal(img2.yuv_planes[0], frames[2].yuv_planes[0])
        img0 = d.nth_image(0)
        np.testing.assert_array_equal(img0.yuv_planes[0], frames[0].yuv_planes[0])

    def test_geometry_change_rejected(self):
        enc = Encoder()
        enc.add_image(make_image(48, 32))
        with pytest.raises(AvifError) as e:
            enc.add_image(make_image(64, 32))
        assert e.value.result == Result.INCOMPATIBLE_IMAGE


class TestDecoderRobustness:
    def test_empty_and_garbage(self):
        for blob in (b"", b"\x00" * 64, b"not an avif file at all"):
            with pytest.raises(AvifError):
                decode(blob)

    def test_truncation_sweep(self):
        """Truncate at every 17th byte (aviftest.c byte-range sweep analogue)."""
        img = make_image(48, 32)
        data = encode(img, quality=90)
        for cut in range(0, len(data), 17):
            try:
                decode(data[:cut])
            except AvifError:
                pass

    def test_size_limit(self):
        img = make_image(48, 32)
        data = encode(img, quality=90)
        d = Decoder()
        d.image_size_limit = 100
        with pytest.raises(AvifError):
            d.read(data)


class TestEncodeBatch:
    def test_batch_matches_single(self):
        from libavif_tpu.api import encode_batch

        imgs = [make_image(48, 32, seed=i) for i in range(3)]
        batch = encode_batch(imgs, quality=80)
        singles = [encode(im, quality=80) for im in imgs]
        assert batch == singles  # deterministic: byte-identical outputs

    def test_batch_with_alpha(self):
        from libavif_tpu.api import encode_batch

        imgs = [make_image(48, 32, seed=7, alpha=True)]
        data = encode_batch(imgs, quality=100)[0]
        d = Decoder()
        out = d.read(data)
        assert d.alpha_present
        np.testing.assert_array_equal(out.alpha_plane, imgs[0].alpha_plane)


class TestReadAll:
    def test_read_all_matches_sequential(self):
        frames = [make_image(48, 32, seed=i) for i in range(4)]
        enc = Encoder()
        enc.quality = 100
        for f in frames:
            enc.add_image(f)
        data = enc.finish()
        d = Decoder()
        d.parse(data)
        got = d.read_all()
        assert len(got) == 4
        for f, g in zip(frames, got):
            np.testing.assert_array_equal(g.yuv_planes[0], f.yuv_planes[0])


class TestCodecChoice:
    def test_spec_lossy_decodes_in_pillow(self):
        """codec_choice='spec' lossy files are real AV1 (avifEncoder
        codecChoice analogue, avif.h:1545)."""
        import io

        from PIL import Image as PILImage

        img = make_image(96, 64, seed=31)
        enc = Encoder()
        enc.quality = 80
        enc.codec_choice = "spec"
        data = enc.write(img)
        pim = PILImage.open(io.BytesIO(data))
        pim.load()
        assert pim.size == (96, 64)
        # our decode agrees with the source within lossy tolerance
        out = decode(data)
        err = np.abs(out.yuv_planes[0].astype(int) - img.yuv_planes[0].astype(int))
        assert err.mean() < 12

    def test_spec_lossy_alpha(self):
        import io

        from PIL import Image as PILImage

        img = make_image(64, 64, seed=32, alpha=True)
        enc = Encoder()
        enc.quality = 85
        enc.codec_choice = "spec"
        data = enc.write(img)
        pim = PILImage.open(io.BytesIO(data))
        pim.load()
        assert pim.mode == "RGBA"

    def test_native_choice_keeps_own_codec(self):
        img = make_image(48, 32, seed=33)
        enc = Encoder()
        enc.quality = 80
        enc.codec_choice = "native"
        data = enc.write(img)
        out = decode(data)  # own decoder handles it
        assert (out.width, out.height) == (48, 32)


class TestCodecOptions:
    """set_codec_specific_option key surface (avifEncoderSetCodecSpecificOption,
    avif.h:1694; aom key names per codec_aom.c:312-580)."""

    def test_cq_level_overrides_quality(self):
        img = make_image(96, 64, seed=41)
        enc = Encoder()
        enc.quality = 90  # would be a low qindex...
        enc.set_codec_specific_option("cq-level", "55")  # ...forced coarse
        coarse = enc.write(img)
        enc2 = Encoder()
        enc2.quality = 90
        fine = enc2.write(img)
        assert len(coarse) < len(fine)  # qindex 220 must beat quality-90 rate

    def test_mode_and_tx_breadth_shrink_search(self):
        img = make_image(96, 64, seed=42)
        enc = Encoder()
        enc.quality = 70
        enc.set_codec_specific_option("mode-breadth", "1")
        enc.set_codec_specific_option("tx-breadth", "1")
        narrow = enc.write(img)
        enc2 = Encoder()
        enc2.quality = 70
        full = enc2.write(img)
        # narrower search can only do worse-or-equal RD: never smaller
        # at identical quantizer unless the searches coincide
        assert len(narrow) >= len(full)
        # both decode
        d = Decoder(); d.parse(narrow); d.next_image()
        assert d.image.width == 96

    def test_enable_cdef_off_spec_lossy(self):
        img = make_image(96, 64, seed=43)
        enc = Encoder()
        enc.quality = 60
        enc.codec_choice = "spec"
        enc.set_codec_specific_option("enable-cdef", "0")
        off = enc.write(img)
        d = Decoder(); d.parse(off); d.next_image()  # decodes cleanly

    def test_invalid_values_raise(self):
        enc = Encoder()
        with pytest.raises(AvifError):
            enc.set_codec_specific_option("cq-level", "64")
        with pytest.raises(AvifError):
            enc.set_codec_specific_option("mode-breadth", "0")
        with pytest.raises(AvifError):
            enc.set_codec_specific_option("tx-breadth", "9")
        # unknown keys are stored, not rejected (reference behavior)
        enc.set_codec_specific_option("some-unknown-key", "7")

    def test_alpha_scope_does_not_touch_color(self):
        enc = Encoder()
        enc.set_codec_specific_option("alpha:cq-level", "20")
        assert enc.cq_level is None
