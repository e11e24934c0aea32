"""Mesh construction and sharded grid-cell codec entry points.

Grid cells are *independent* AV1 streams (the reference exploits this to
skip cross-tile filtering entirely — read.c grid model, SURVEY.md §5
"long-context analogue"), so cell-parallel encode/decode needs no
communication; XLA partitions the vmapped program across the mesh with
zero collectives. `exchange_cell_boundaries` is the halo primitive for
future cross-cell filters (CDEF/LR at cell seams), built on shard_map +
ppermute (a device-to-device copy between neighbouring shards).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codec import recon

CODEC_MESH_AXES = ("frames", "cells")


def make_codec_mesh(
    n_devices: Optional[int] = None, frames: Optional[int] = None
) -> Mesh:
    """2-D codec mesh: frames (DP analogue) × cells (spatial analogue).

    With no hints, puts at most 2 ways on frames and the rest on cells.
    """
    devices = np.asarray(jax.devices())
    n = n_devices or devices.size
    devices = devices[:n]
    if frames is None:
        frames = 2 if n % 2 == 0 and n > 1 else 1
    cells = n // frames
    if frames * cells != n:
        raise ValueError(f"cannot factor {n} devices into {frames}×cells")
    return Mesh(devices.reshape(frames, cells), CODEC_MESH_AXES)


def _cells_sharding(mesh: Mesh) -> NamedSharding:
    # Leading two axes: (frames, cells); planes replicated beyond that.
    return NamedSharding(mesh, P("frames", "cells"))


# --------------------------------------------------------- product wiring
# encode/decode_frames_pipelined (codec/frame.py) consult the default mesh
# and route uniform-geometry frame batches (grid cells, animation frames,
# encode_batch) through the packed-batch entries below: one compiled
# program, frame axis sharded over every local device. The reference's
# analogue is grid cells as the unit of parallel decode (read.c:1696).

_DEFAULT_MESH = {"checked": False, "mesh": None}


def default_codec_mesh() -> Optional[Mesh]:
    """Process-wide codec mesh over all local devices; None single-device.
    Computed once; override with set_default_codec_mesh (tests, or to pin
    a device subset)."""
    if not _DEFAULT_MESH["checked"]:
        _DEFAULT_MESH["checked"] = True
        n = jax.device_count()
        _DEFAULT_MESH["mesh"] = make_codec_mesh(n) if n > 1 else None
    return _DEFAULT_MESH["mesh"]


def set_default_codec_mesh(mesh: Optional[Mesh]) -> None:
    _DEFAULT_MESH["checked"] = True
    _DEFAULT_MESH["mesh"] = mesh


@functools.partial(
    jax.jit,
    static_argnames=("geoms", "n", "depth", "lossless", "speed", "mesh", "search"),
)
def _encode_packed_batch(packed, dc, ac, *, geoms, n, depth, lossless, speed, mesh,
                         search=(None, None)):
    spec = NamedSharding(mesh, P(CODEC_MESH_AXES))  # frame axis over all devices
    packed = jax.lax.with_sharding_constraint(packed, spec)
    fn = lambda p: recon.encode_frame_device(  # noqa: E731
        p, dc, ac, geoms=geoms, n=n, depth=depth, lossless=lossless, speed=speed,
        search=search,
    )
    return jax.lax.with_sharding_constraint(jax.vmap(fn)(packed), spec)


def encode_packed_frames_sharded(
    packed_batch, dc, ac, *, geoms, n, depth, lossless, speed, mesh,
    search=(None, None),
):
    """(F, L) packed plane batch -> (F, out_L) packed results, frame axis
    sharded over the whole mesh. Frames are independent bitstreams: zero
    collectives; XLA partitions the vmapped wavefront program."""
    import jax.numpy as _jnp

    return _encode_packed_batch(
        packed_batch, _jnp.int32(dc), _jnp.int32(ac),
        geoms=geoms, n=n, depth=depth, lossless=lossless, speed=speed, mesh=mesh,
        search=search,
    )


@functools.partial(
    jax.jit,
    static_argnames=("geoms", "n", "depth", "lossless", "deblock", "cdef", "mesh"),
)
def _decode_packed_batch(
    packed, dc, ac, thresh, cthresh, *, geoms, n, depth, lossless, deblock, cdef, mesh
):
    spec = NamedSharding(mesh, P(CODEC_MESH_AXES))
    packed = jax.lax.with_sharding_constraint(packed, spec)
    fn = lambda p: recon.decode_frame_device(  # noqa: E731
        p, dc, ac, thresh, cthresh,
        geoms=geoms, n=n, depth=depth, lossless=lossless,
        deblock=deblock, cdef=cdef,
    )
    return jax.lax.with_sharding_constraint(jax.vmap(fn)(packed), spec)


def decode_packed_frames_sharded(
    packed_batch, dc, ac, thresh, cthresh, *,
    geoms, n, depth, lossless, deblock, cdef, mesh,
):
    """Decode-side mirror of encode_packed_frames_sharded."""
    import jax.numpy as _jnp

    return _decode_packed_batch(
        packed_batch, _jnp.int32(dc), _jnp.int32(ac), _jnp.int32(thresh),
        _jnp.int32(cthresh),
        geoms=geoms, n=n, depth=depth, lossless=lossless,
        deblock=deblock, cdef=cdef, mesh=mesh,
    )


@functools.partial(jax.jit, static_argnames=("n", "depth", "lossless", "mesh"))
def _encode_batch(cells, dc_step, ac_step, *, n, depth, lossless, mesh):
    fn = functools.partial(recon.encode_plane, n=n, depth=depth, lossless=lossless)
    batched = jax.vmap(jax.vmap(lambda p: fn(p, dc_step, ac_step)))
    if mesh is not None:
        cells = jax.lax.with_sharding_constraint(cells, _cells_sharding(mesh))
    return batched(cells)


def encode_cells_sharded(cells, dc_step, ac_step, *, n, depth, lossless, mesh=None):
    """Encode a (F, K, Hp, Wp) batch of padded cell planes, F×K sharded over
    the (frames, cells) mesh. Returns (modes, levels, recon) with the same
    leading axes. Cells are entropy-independent: no collectives are needed,
    XLA partitions the program (scaling target: BASELINE.md grid config)."""
    return _encode_batch(
        cells, jnp.int32(dc_step), jnp.int32(ac_step),
        n=n, depth=depth, lossless=lossless, mesh=mesh,
    )


@functools.partial(jax.jit, static_argnames=("n", "depth", "lossless", "mesh"))
def _decode_batch(levels, modes, tx_types, dc_step, ac_step, *, n, depth, lossless, mesh):
    fn = functools.partial(recon.decode_plane, n=n, depth=depth, lossless=lossless)
    batched = jax.vmap(jax.vmap(lambda lv, md, tx: fn(lv, md, dc_step, ac_step, tx)))
    if mesh is not None:
        spec = NamedSharding(mesh, P("frames", "cells"))
        levels = jax.lax.with_sharding_constraint(levels, spec)
        modes = jax.lax.with_sharding_constraint(modes, spec)
        tx_types = jax.lax.with_sharding_constraint(tx_types, spec)
    return batched(levels, modes, tx_types)


def decode_cells_sharded(levels, modes, dc_step, ac_step, *, n, depth, lossless, mesh=None, tx_types=None):
    """Decode (F, K, Rb, Cb, n, n) levels + (F, K, Rb, Cb) modes, sharded as
    in encode_cells_sharded. Returns (F, K, Hp, Wp) reconstructions."""
    if tx_types is None:
        tx_types = jnp.zeros(modes.shape, dtype=jnp.int32)
    return _decode_batch(
        levels, modes, tx_types, jnp.int32(dc_step), jnp.int32(ac_step),
        n=n, depth=depth, lossless=lossless, mesh=mesh,
    )


def exchange_cell_boundaries(cells, mesh: Mesh):
    """Halo primitive: every cell shard receives the bottom rows of its
    upward neighbor along the "cells" axis (ppermute).

    Returns (F, K, rows, Wp) halo rows; shard 0 receives zeros. This is
    the building block for cross-cell CDEF/loop-restoration at grid seams
    (the reference never filters across cells; we keep that at cell
    granularity but the halo path is required for in-cell filters whose
    support crosses *device* boundaries when one cell spans devices).
    """

    def body(local):
        # local: (F_local, K_local, Hp, Wp) block on this shard
        bottom = local[:, -1:, -8:, :]  # last cell's bottom 8 rows
        axis = "cells"
        k = jax.lax.axis_size(axis)
        perm = [(i, (i + 1) % k) for i in range(k)]
        halo = jax.lax.ppermute(bottom, axis, perm)
        idx = jax.lax.axis_index(axis)
        return jnp.where(idx == 0, jnp.zeros_like(halo), halo)

    spec = P("frames", "cells")
    return shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec)(cells)
