"""Device results against JAX's CPU backend, on a GPU.

Every test here needs a card and skips without one. On the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

(chip_smoke.py runs them too, in its own process.)
"""

import jax
import numpy as np
import pytest

import chip_smoke as C

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_rd_tables_match_cpu(gpu, cpu):
    from libavif_tpu.codec.av1 import rdsearch_device as RDD

    y = np.asarray(C.make_image(768, 512, 5).yuv_planes[0], np.int32)
    fn, meta, args, _ = RDD.cost_program(y, 100, 6, 8)
    with jax.default_device(gpu):
        dev = np.asarray(fn(*args))
    with jax.default_device(cpu):
        ref = np.asarray(fn(*args))
    t = C.compare_cost_tables(dev, ref, meta)
    assert not [what for ok, what in C.tables_agree(t) if not ok], str(t)


def test_own_format_bytes_match_cpu(gpu, cpu):
    img = C.make_image(384, 256, 6)
    with jax.default_device(gpu):
        data, planes = C._native_roundtrip(img)
    with jax.default_device(cpu):
        ref_data, ref_planes = C._native_roundtrip(img)
    assert data == ref_data
    for a, b in zip(planes, ref_planes):
        np.testing.assert_array_equal(a, b)


def test_rgb_matches_cpu(gpu, cpu):
    from libavif_tpu.constants import PixelFormat, Range
    from libavif_tpu.pixels.reformat import yuv_to_rgb_arrays

    img = C.make_image(384, 256, 7)
    kw = dict(depth=8, rgb_depth=8, yuv_format=PixelFormat.YUV420,
              yuv_range=Range.LIMITED, matrix_coefficients=1)
    with jax.default_device(gpu):
        out = yuv_to_rgb_arrays(*img.yuv_planes, **kw)
    with jax.default_device(cpu):
        ref = yuv_to_rgb_arrays(*img.yuv_planes, **kw)
    # equal, except one code value where the GPU contracts a multiply-add
    assert np.abs(out.astype(np.int16) - ref.astype(np.int16)).max() <= 1
