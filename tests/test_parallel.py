"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The reference has no multi-node tests (nothing distributed, SURVEY.md §4);
these are this engine's own: sharded-vs-single bit-exactness and halo
exchange correctness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libavif_tpu.codec import recon
from libavif_tpu.parallel import (
    decode_cells_sharded,
    encode_cells_sharded,
    exchange_cell_boundaries,
    make_codec_mesh,
)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def mesh():
    return make_codec_mesh(8)


@pytest.fixture(scope="module")
def cells():
    rng = np.random.default_rng(0)
    # mesh is (frames=2, cells=4); 2 cells per shard on the cells axis
    return jnp.asarray(rng.integers(0, 256, (2, 8, 32, 32)), dtype=jnp.int32)


class TestShardedCodec:
    def test_sharded_encode_matches_single_device(self, mesh, cells):
        modes_s, levels_s, rec_s, tx_s = encode_cells_sharded(
            cells, 8, 11, n=16, depth=8, lossless=False, mesh=mesh
        )
        # Reference: per-cell single-device encode
        for f in range(cells.shape[0]):
            for k in range(cells.shape[1]):
                m, l, r, t = recon.encode_plane(
                    cells[f, k], jnp.int32(8), jnp.int32(11),
                    n=16, depth=8, lossless=False,
                )
                np.testing.assert_array_equal(np.asarray(modes_s[f, k]), np.asarray(m))
                np.testing.assert_array_equal(np.asarray(levels_s[f, k]), np.asarray(l))
                np.testing.assert_array_equal(np.asarray(rec_s[f, k]), np.asarray(r))
                np.testing.assert_array_equal(np.asarray(tx_s[f, k]), np.asarray(t))

    def test_sharded_decode_roundtrip_bit_exact(self, mesh, cells):
        modes, levels, rec, txs = encode_cells_sharded(
            cells, 8, 11, n=16, depth=8, lossless=False, mesh=mesh
        )
        rec2 = decode_cells_sharded(
            levels, modes, 8, 11, n=16, depth=8, lossless=False, mesh=mesh,
            tx_types=txs,
        )
        np.testing.assert_array_equal(np.asarray(rec), np.asarray(rec2))

    def test_lossless_sharded(self, mesh, cells):
        modes, levels, rec, _ = encode_cells_sharded(
            cells, 1, 1, n=16, depth=8, lossless=True, mesh=mesh
        )
        np.testing.assert_array_equal(np.asarray(rec), np.asarray(cells))


class TestHaloExchange:
    def test_boundary_rows_travel_right(self, mesh, cells):
        halo = np.asarray(exchange_cell_boundaries(cells, mesh))
        # shard s (cells axis, 4 shards x 2 cells each) receives the bottom
        # 8 rows of the LAST cell of shard s-1; shard 0 receives zeros.
        k_shards = mesh.devices.shape[1]
        per = cells.shape[1] // k_shards
        src = np.asarray(cells)
        for f in range(cells.shape[0]):
            for s in range(k_shards):
                got = halo[f, s]
                if s == 0:
                    assert (got == 0).all()
                else:
                    prev_last_cell = (s - 1) * per + (per - 1)
                    np.testing.assert_array_equal(
                        got, src[f, prev_last_cell, -8:, :]
                    )


class TestMesh:
    def test_mesh_factorization(self):
        m = make_codec_mesh(8)
        assert m.devices.shape == (2, 4)
        m1 = make_codec_mesh(1)
        assert m1.devices.shape == (1, 1)
        with pytest.raises(ValueError):
            make_codec_mesh(6, frames=4)


class TestProductWiring:
    """encode/decode_frames_pipelined route uniform batches through the
    sharded packed entries when a multi-device mesh exists (VERDICT item:
    mesh wired into Encoder/Decoder/encode_batch/write_grid)."""

    def test_default_mesh_exists_on_virtual_devices(self):
        from libavif_tpu.parallel.shard import default_codec_mesh

        mesh = default_codec_mesh()
        assert mesh is not None and mesh.devices.size == 8

    def test_grid_bitstreams_identical_sharded_vs_single(self):
        import numpy as np

        from libavif_tpu.api import Encoder
        from libavif_tpu.constants import PixelFormat
        from libavif_tpu.image import Image
        from libavif_tpu.parallel import shard

        def make_cells(seed0):
            cells = []
            for i in range(4):
                rng = np.random.default_rng(seed0 + i)
                img = Image(64, 64, 8, PixelFormat.YUV420)
                img.allocate_planes("yuv")
                for p in img.yuv_planes:
                    p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
                cells.append(img)
            return cells

        def encode():
            enc = Encoder()
            enc.quality = 70
            return enc.write_grid(make_cells(77), columns=2, rows=2)

        sharded = encode()
        saved = dict(shard._DEFAULT_MESH)
        try:
            shard.set_default_codec_mesh(None)
            single = encode()
        finally:
            shard._DEFAULT_MESH.update(saved)
        assert sharded == single  # backend/mesh-deterministic bitstreams

    def test_grid_decode_uses_sharded_path(self, monkeypatch):
        import numpy as np

        import libavif_tpu.parallel.shard as shard
        from libavif_tpu.api import Decoder, Encoder
        from libavif_tpu.constants import PixelFormat
        from libavif_tpu.image import Image

        cells = []
        for i in range(4):
            rng = np.random.default_rng(100 + i)
            img = Image(64, 64, 8, PixelFormat.YUV420)
            img.allocate_planes("yuv")
            for p in img.yuv_planes:
                p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
            cells.append(img)
        # the mesh-sharded batch paths are the NATIVE codec's product
        # wiring (spec-AV1, the interop default, encodes host-side)
        enc = Encoder()
        enc.quality = 80
        enc.codec_choice = "native"
        data = enc.write_grid(cells, columns=2, rows=2)

        enc_calls, dec_calls = [], []
        orig_enc = shard.encode_packed_frames_sharded
        orig_dec = shard.decode_packed_frames_sharded
        monkeypatch.setattr(
            shard, "encode_packed_frames_sharded",
            lambda *a, **k: (enc_calls.append(1), orig_enc(*a, **k))[1],
        )
        monkeypatch.setattr(
            shard, "decode_packed_frames_sharded",
            lambda *a, **k: (dec_calls.append(1), orig_dec(*a, **k))[1],
        )
        enc2 = Encoder()
        enc2.quality = 80
        enc2.codec_choice = "native"
        enc2.write_grid(cells, columns=2, rows=2)
        assert enc_calls  # encode batch went through the mesh entry

        out = Decoder().read(data)
        assert dec_calls  # grid reassembly decoded through the mesh entry
        assert (out.width, out.height) == (128, 128)
