"""Frame-level codec seam: Image planes ⇄ OBU stream.

This is the native codec behind the reference's vtable seam
(include/avif/internal.h:605-623): ``encode_frame`` plays the role of
``codec->encodeImage`` (codec_aom.c:656) and ``decode_frame`` the role of
``codec->getNextImage`` (codec_dav1d.c:58).

OBU stream layout: a standard AV1 sequence-header OBU (spec §5.5 syntax —
it carries profile/depth/format/CICP so container-level av1C harvesting
works exactly like the reference's obu.c:712), followed by one OBU_FRAME
whose payload is this codec's own frame format:

  u8  magic (0x54, bumped on format changes)
  u8  qindex
  u8  log2 transform size
  u8  flags (bit0: lossless, bit1: in-loop deblock, bit2: cdef stage)
  per coded plane (Y, then U, V unless monochrome):
    leb128 plane-payload size + plane payload (entropy.py column tiles:
    leb128 tile count, per-tile sizes, msac tile payloads)

Profile selection mirrors codec_aom.c:834-869 semantics: 12-bit → profile
2, 4:4:4 → 1, 4:2:2 → 2, 4:2:0/4:0:0 → 0.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..constants import (
    AvifError,
    ChromaSamplePosition,
    PixelFormat,
    Range,
    Result,
    pixel_format_info,
)
from ..containers.items import CodecConfiguration
from ..containers.obu import (
    OBU_FRAME,
    OBU_SEQUENCE_HEADER,
    Obu,
    SequenceHeader,
    parse_sequence_header,
    read_leb128,
    split_obus,
    write_leb128,
    write_obu,
    write_sequence_header,
)
from ..image import Image
from ..ops.filters import cdef_threshold, deblock_threshold
from ..ops.quant import quality_to_qindex, step_sizes
from ..utils.streams import ROStream, RWStream
from . import entropy, recon

FRAME_MAGIC = 0x5A  # bumped: spec msac termination (trailing-one code)
DEFAULT_TX_SIZE = 16


@dataclasses.dataclass
class FrameParams:
    """Codec-facing settings (the avifEncoder quality/speed subset,
    avif.h:1511-1625)."""

    quality: int = 60
    speed: int = 6
    tx_size: int = DEFAULT_TX_SIZE
    deblock: bool | None = None  # None: auto (on at quality <= 50)
    cdef: bool | None = None  # None: auto (on for lossy; free ~+0.3 dB)
    # "auto"/"spec": spec-conformant AV1 for both lossless and lossy
    # (decodes in dav1d/libaom/every AVIF viewer; native-accelerated
    # host RD loop). "native": the device-pipelined own format — the
    # opt-in fast path for device-throughput serving (bench.py).
    # LIBAVIF_TPU_SPEC_AV1=0 reverts "auto" to the native codec.
    codec: str = "auto"
    # AV1 tile grid for the spec codec (avifEncoder tileRowsLog2/
    # tileColsLog2/autoTiling, avif.h:1568-1576)
    tile_rows_log2: int = 0
    tile_cols_log2: int = 0
    auto_tiling: bool = False
    max_threads: int = 8  # avifEncoder maxThreads (write.c:1844 uses 8)
    # codec key-value knobs (set_codec_specific_option): search breadth
    # overrides for the native codec (mode-breadth 1-13, tx-breadth 1-5)
    # and a direct quantizer override (aom cq-level, 0-63)
    mode_breadth: int | None = None
    tx_breadth: int | None = None
    cq_level: int | None = None

    @property
    def qindex(self) -> int:
        if self.cq_level is not None:
            return max(0, min(255, int(self.cq_level) * 4))
        return quality_to_qindex(self.quality)

    @property
    def lossless(self) -> bool:
        return self.qindex == 0

    @property
    def deblock_enabled(self) -> bool:
        if self.lossless:
            return False
        if self.deblock is not None:
            return self.deblock
        return self.quality <= 50

    @property
    def cdef_enabled(self) -> bool:
        if self.lossless:
            return False
        if self.cdef is not None:
            return self.cdef
        return True


def _profile_for(depth: int, fmt: PixelFormat) -> int:
    if depth == 12:
        return 2
    if fmt == PixelFormat.YUV444:
        return 1
    if fmt == PixelFormat.YUV422:
        return 2
    return 0


def _sequence_header_for(image: Image) -> SequenceHeader:
    info = pixel_format_info(image.yuv_format)
    h = SequenceHeader()
    h.seq_profile = _profile_for(image.depth, image.yuv_format)
    h.still_picture = True
    h.reduced_still_picture_header = True
    h.max_frame_width = image.width
    h.max_frame_height = image.height
    h.frame_width_bits = max(1, (image.width - 1).bit_length() or 1)
    h.frame_height_bits = max(1, (image.height - 1).bit_length() or 1)
    h.high_bitdepth = image.depth > 8
    h.twelve_bit = image.depth == 12
    h.monochrome = info.monochrome
    h.color_description_present = True
    h.color_primaries = int(image.color_primaries)
    h.transfer_characteristics = int(image.transfer_characteristics)
    h.matrix_coefficients = int(image.matrix_coefficients)
    h.color_range = 1 if image.yuv_range == Range.FULL else 0
    h.subsampling_x = info.chroma_shift_x
    h.subsampling_y = info.chroma_shift_y
    h.chroma_sample_position = int(image.chroma_sample_position)
    return h


def config_from_sequence_header(h: SequenceHeader, config_obus: bytes = b"") -> CodecConfiguration:
    """av1C harvest (reference: avifEncoderFinish → avifSequenceHeaderParse,
    write.c:3152 region / obu.c:712)."""
    return CodecConfiguration(
        seq_profile=h.seq_profile,
        seq_level_idx_0=h.operating_points[0].seq_level_idx,
        seq_tier_0=h.operating_points[0].seq_tier,
        high_bitdepth=int(h.high_bitdepth),
        twelve_bit=int(h.twelve_bit),
        monochrome=int(h.monochrome),
        chroma_subsampling_x=h.subsampling_x,
        chroma_subsampling_y=h.subsampling_y,
        chroma_sample_position=h.chroma_sample_position,
        config_obus=config_obus,
    )


def _coded_planes(image_or_hdr) -> int:
    return 1 if image_or_hdr.monochrome else 3


def _submit_plane_encode(pool, levels, modes, txs, n: int):
    """Per-entropy-tile futures for one plane (column tiles code
    concurrently; entropy.tile_col_ranges)."""
    spans = entropy.tile_col_ranges(modes.shape[1])
    return [
        pool.submit(
            entropy.encode_tile,
            levels[:, c0:c1], modes[:, c0:c1], n,
            None if txs is None else txs[:, c0:c1],
        )
        for c0, c1 in spans
    ]


def _assemble_plane_payload(futs) -> bytes:
    payloads = [f.result() for f in futs]
    s = RWStream()
    write_leb128(s, len(payloads))
    for p in payloads:
        write_leb128(s, len(p))
    for p in payloads:
        s.write(p)
    return s.data()


def _submit_plane_decode(pool, payload: bytes, rb: int, cb: int, n: int, with_tx: bool):
    s = ROStream(payload)
    t = read_leb128(s)
    spans = entropy.tile_col_ranges(cb)
    if t != len(spans):
        raise ValueError(f"tile count {t} != expected {len(spans)}")
    sizes = [read_leb128(s) for _ in range(t)]
    blobs = [s.read(sz) for sz in sizes]
    return [
        pool.submit(entropy.decode_tile, blob, rb, c1 - c0, n, with_tx)
        for blob, (c0, c1) in zip(blobs, spans)
    ]


def _assemble_plane_decode(futs, with_tx: bool):
    parts = [f.result() for f in futs]
    levels = np.concatenate([p[0] for p in parts], axis=1)
    modes = np.concatenate([p[1] for p in parts], axis=1)
    if with_tx:
        return levels, modes, np.concatenate([p[2] for p in parts], axis=1)
    return levels, modes, np.zeros(modes.shape, np.int32)


def encode_frames_pipelined(
    images: list[Image], params: FrameParams
) -> list[tuple[bytes, SequenceHeader]]:
    """Batch still encode with device/host pipelining: ALL frames' device
    programs are dispatched up front (JAX async dispatch queues them on
    the chip), then host entropy coding drains results in order — device
    compute for frame k+1 overlaps entropy for frame k.

    This is the production serving path; per-frame latency is unchanged
    but sustained MP/s is bounded by max(device, host) instead of sum.
    """
    spec_on = params.codec == "spec" or (
        params.codec == "auto" and _spec_av1_enabled()
    )
    if spec_on and not params.lossless:
        # spec-conformant AV1 is the default lossy output (matching the
        # reference, whose only encoder is libaom: write.c:2104-2114);
        # codec="native" opts into the device-pipelined own format below.
        # Dispatch every frame's device RD program up front (XLA async
        # dispatch queues them) so device compute for frame k+1 overlaps
        # host entropy for frame k — same pipelining as the native path.
        handles = [None] * len(images)
        if len(images) > 1 and params.speed is not None and params.speed <= 6:
            from .av1.rdsearch_device import dispatch_plan_costs

            qindex = _spec_qindex(params)
            handles = [
                dispatch_plan_costs(
                    np.asarray(im.yuv_planes[0], dtype=np.int32),
                    qindex, params.speed, im.depth,
                )
                for im in images
            ]
        return [
            _encode_frame_spec_lossy(im, params, dev_handle=h)
            for im, h in zip(images, handles)
        ]
    if params.lossless and images and spec_on:
        return [_encode_frame_spec_lossless(im, params) for im in images]
    staged = []
    n = params.tx_size
    lossless = params.lossless
    for image in images:
        if image.depth not in (8, 10, 12):
            raise AvifError(Result.UNSUPPORTED_DEPTH, f"depth {image.depth}")
        hdr = _sequence_header_for(image)
        planes = []
        for c in range(_coded_planes(image)):
            plane = image.yuv_planes[c]
            if plane is None:
                raise AvifError(Result.NO_CONTENT, f"missing plane {c}")
            planes.append(plane)
        in_dtype = np.uint8 if image.depth == 8 else np.uint16
        padded = [recon.pad_to_blocks(p, n).astype(in_dtype) for p in planes]
        geoms = tuple((p.shape[0] // n, p.shape[1] // n) for p in padded)
        packed = np.concatenate([p.reshape(-1) for p in padded])
        staged.append((hdr, geoms, image.depth, packed))

    # Multi-device: uniform-geometry batches (grid cells, animation frames,
    # encode_batch) run as ONE program with the frame axis sharded over the
    # codec mesh (parallel/shard.py; grid cells are independent bitstreams
    # so this needs zero collectives).
    mesh = None
    if len(staged) > 1:
        from ..parallel.shard import default_codec_mesh

        mesh = default_codec_mesh()
    if (
        mesh is not None
        and len({(g, d, p.shape) for _, g, d, p in staged}) == 1
    ):
        from ..parallel.shard import encode_packed_frames_sharded

        _, geoms0, depth0, _ = staged[0]
        dc, ac = (1, 1) if lossless else step_sizes(params.qindex, depth0)
        batch = np.stack([p for _, _, _, p in staged])
        out = encode_packed_frames_sharded(
            batch, dc, ac, geoms=geoms0, n=n, depth=depth0,
            lossless=lossless, speed=params.speed, mesh=mesh,
            search=(params.mode_breadth, params.tx_breadth),
        )
        host = np.asarray(out)  # one packed fetch for the whole batch
        results = [host[i] for i in range(len(staged))]
    else:
        results = []
        for hdr, geoms, depth, packed in staged:
            dc, ac = (1, 1) if lossless else step_sizes(params.qindex, depth)
            results.append(
                recon.encode_frame_device(  # async dispatch, not fetched yet
                    packed, np.int32(dc), np.int32(ac),
                    geoms=geoms, n=n, depth=depth, lossless=lossless,
                    speed=params.speed,
                    search=(params.mode_breadth, params.tx_breadth),
                )
            )
        for result in results:
            # Overlap D2H transfers with each other and with host entropy.
            if hasattr(result, "copy_to_host_async"):
                result.copy_to_host_async()

    # Drain: fetch each frame's packed result in completion order and feed
    # every tile straight into a shared host pool — entropy for ALL tiles
    # of ALL frames runs concurrently (the native coder releases the GIL),
    # overlapping the remaining device work and fetches.
    import os

    workers = max(2, min(16, (os.cpu_count() or 4)))
    with ThreadPoolExecutor(workers) as pool:
        futures = []  # per frame: list of tile futures
        for (hdr, geoms, _, _), result in zip(staged, results):
            result = np.asarray(result)
            off = 0
            frame_futs = []
            for rb, cb in geoms:
                nb = rb * cb
                modes = result[off : off + nb].astype(np.int32).reshape(rb, cb)
                off += nb
                txs = result[off : off + nb].astype(np.int32).reshape(rb, cb)
                off += nb
                levels = (
                    result[off : off + nb * n * n].astype(np.int32).reshape(rb, cb, n, n)
                )
                off += nb * n * n
                frame_futs.append(
                    _submit_plane_encode(
                        pool, levels, modes, None if lossless else txs, n
                    )
                )
            futures.append(frame_futs)

        out = []
        for (hdr, _, _, _), frame_futs in zip(staged, futures):
            body = RWStream()
            body.write_u8(FRAME_MAGIC)
            body.write_u8(params.qindex)
            body.write_u8(params.tx_size.bit_length() - 1)
            body.write_u8(
                (1 if params.lossless else 0)
                | (2 if params.deblock_enabled else 0)
                | (4 if params.cdef_enabled else 0)
            )
            for plane_futs in frame_futs:
                payload = _assemble_plane_payload(plane_futs)
                write_leb128(body, len(payload))
                body.write(payload)
            s = RWStream()
            write_obu(s, OBU_SEQUENCE_HEADER, write_sequence_header(hdr))
            write_obu(s, OBU_FRAME, body.data())
            out.append((s.data(), hdr))
    return out


def _spec_av1_enabled() -> bool:
    import os

    return os.environ.get("LIBAVIF_TPU_SPEC_AV1", "1") != "0"


def _tile_config(params: FrameParams, width: int, height: int) -> tuple[int, int]:
    """Resolve the AV1 tile grid: explicit log2s, or the reference's
    auto-tiling heuristic (write.c:89-119 avifSetTileConfiguration:
    >=512x512 px per tile, <=32 tiles, <= threads, near-square tiles with
    more columns than rows for landscape images)."""
    if not params.auto_tiling:
        return params.tile_cols_log2, params.tile_rows_log2
    threads = max(1, params.max_threads)
    if threads <= 1:
        return 0, 0
    tiles = min((width * height + 512 * 512 - 1) // (512 * 512), 32, threads)
    tiles_log2 = max(tiles, 1).bit_length() - 1
    dim1, dim2 = (width, height) if width >= height else (height, width)
    diff_log2 = max(dim1 // dim2, 1).bit_length() - 1
    sub = max(tiles_log2 - diff_log2, 0)
    d2 = sub // 2
    d1 = tiles_log2 - d2
    return (d1, d2) if width >= height else (d2, d1)


def _encode_frame_spec_lossless(image: Image, params: FrameParams | None = None) -> tuple[bytes, SequenceHeader]:
    """Spec-conformant AV1 lossless payload (decodable by dav1d/libaom);
    see codec/av1/encode.py."""
    from .av1.encode import encode_lossless_still

    info = pixel_format_info(image.yuv_format)
    tcl, trl = _tile_config(params, image.width, image.height) if params else (0, 0)
    planes = [image.yuv_planes[c] for c in range(_coded_planes(image))]
    payload = encode_lossless_still(
        planes,
        tile_cols_log2=tcl,
        tile_rows_log2=trl,
        monochrome=info.monochrome,
        subsampling_x=info.chroma_shift_x,
        subsampling_y=info.chroma_shift_y,
        bit_depth=image.depth,
        color_primaries=int(image.color_primaries),
        transfer_characteristics=int(image.transfer_characteristics),
        matrix_coefficients=int(image.matrix_coefficients),
        color_range=1 if image.yuv_range == Range.FULL else 0,
    )
    from ..containers.obu import find_sequence_header

    return payload, find_sequence_header(payload)


def _decode_frame_spec(
    data: bytes, width: int = 0, height: int = 0, stream=None
) -> Image:
    """Decode a real AV1 payload (foreign AVIF files; also our own
    spec-conformant output). codec_dav1d.c:58 role. With `stream`, state
    persists so the payload may reference previously decoded frames."""
    from .av1.still import decode_still

    if stream is not None:
        shown = stream.decode_obus(data)
        if not shown:
            raise AvifError(Result.BMFF_PARSE_FAILED, "sample produced no frame")
        planes, seq, hdr = shown[-1]
    else:
        planes, seq, hdr = decode_still(data)
    if seq.monochrome:
        fmt = PixelFormat.YUV400
    elif seq.subsampling_x and seq.subsampling_y:
        fmt = PixelFormat.YUV420
    elif seq.subsampling_x:
        fmt = PixelFormat.YUV422
    else:
        fmt = PixelFormat.YUV444
    w = width or hdr.width
    h = height or hdr.height
    out = Image(w, h, seq.bit_depth, fmt)
    out.yuv_range = Range.FULL if seq.color_range else Range.LIMITED
    if seq.color_description_present:
        out.color_primaries = seq.color_primaries
        out.transfer_characteristics = seq.transfer_characteristics
        out.matrix_coefficients = seq.matrix_coefficients
    out.chroma_sample_position = ChromaSamplePosition(seq.chroma_sample_position)
    out.allocate_planes("yuv")
    for c, plane in enumerate(planes):
        ph, pw = out.yuv_planes[c].shape
        out.yuv_planes[c][:, :] = plane[:ph, :pw].astype(out.dtype)
    return out


def _spec_qindex(params: FrameParams) -> int:
    """quality -> base_q_idx with the reference's quality->quantizer rule
    (avif.h AVIF_QUANTIZER scale, write.c quality mapping)."""
    quantizer = ((100 - params.quality) * 63 + 50) // 100
    qindex = max(1, min(255, quantizer * 4))
    if params.cq_level is not None:  # codec option "cq-level" (aom scale)
        qindex = max(1, min(255, int(params.cq_level) * 4))
    return qindex


def _looks_like_screen_content(y: np.ndarray) -> bool:
    """Screen-content detector (role of aom's is_screen_content behind
    av1_set_screen_content_options): sample 16x16 blocks; when at least
    half have <= 8 distinct values, enable screen tools so the planner
    can code palette blocks (codec/av1/encode.py _palette_try)."""
    h, w = y.shape
    if h < 32 or w < 32:
        return False
    ys = (h - 16) // 16 * 16
    xs = (w - 16) // 16 * 16
    b = np.asarray(y[:ys + 16, :xs + 16])
    t = b[: ys + 16 - (ys + 16) % 16, : xs + 16 - (xs + 16) % 16]
    bh, bw = t.shape[0] // 16, t.shape[1] // 16
    blocks = t.reshape(bh, 16, bw, 16).transpose(0, 2, 1, 3).reshape(-1, 256)
    s = np.sort(blocks, axis=1)
    ncolors = 1 + (s[:, 1:] != s[:, :-1]).sum(axis=1)
    return float((ncolors <= 8).mean()) >= 0.5


def _encode_frame_spec_lossy(
    image: Image, params: FrameParams, dev_handle=None
) -> tuple[bytes, SequenceHeader]:
    """Spec-conformant lossy AV1 payload (codec/av1/encode.py RD search)."""
    from .av1.encode import encode_lossy_still

    info = pixel_format_info(image.yuv_format)
    planes = [image.yuv_planes[c] for c in range(_coded_planes(image))]
    qindex = _spec_qindex(params)
    tcl, trl = _tile_config(params, image.width, image.height)
    # encoder-side CDEF (role of libaom's always-on pickcdef behind
    # codec_aom.c): post-encode strength search, skipped only at the
    # realtime speeds where the reference also trades quality for speed
    cdef_on = params.cdef is not False and params.speed <= 8
    scc = params.speed <= 8 and _looks_like_screen_content(planes[0])
    payload = encode_lossy_still(
        planes, qindex, speed=params.speed,
        enable_cdef=cdef_on, cdef_search=cdef_on,
        enable_deblock=params.deblock is not False,
        allow_scc=scc,
        # block-copy dedup; like aom's screen path this trades the
        # in-loop filters (§5.9.2 disables them under intrabc) for
        # exact-copy coding of repeated content
        allow_intrabc=scc,
        tile_cols_log2=tcl,
        tile_rows_log2=trl,
        monochrome=info.monochrome,
        subsampling_x=info.chroma_shift_x,
        subsampling_y=info.chroma_shift_y,
        bit_depth=image.depth,
        color_primaries=int(image.color_primaries),
        transfer_characteristics=int(image.transfer_characteristics),
        matrix_coefficients=int(image.matrix_coefficients),
        color_range=1 if image.yuv_range == Range.FULL else 0,
        dev_handle=dev_handle,
    )
    from ..containers.obu import find_sequence_header

    return payload, find_sequence_header(payload)


def encode_sequence_frames(
    images: list[Image], params: FrameParams
) -> list[tuple[bytes, SequenceHeader]]:
    """Encode one GOP: frame 0 as a KEY frame, the rest INTER-coded
    against the previous reconstruction (reference: libaom sequence
    encode behind codec_aom.c:656-1351 + write.c:2104-2114). Falls back
    to per-frame stills when inter coding does not apply (own-format
    codec, lossless, or a single frame)."""
    spec_on = params.codec == "spec" or (
        params.codec == "auto" and _spec_av1_enabled()
    )
    if not spec_on or params.lossless or len(images) < 2:
        return encode_frames_pipelined(images, params)
    from .av1.interenc import encode_inter_sequence

    im0 = images[0]
    if im0.depth not in (8, 10, 12):
        raise AvifError(Result.UNSUPPORTED_DEPTH, f"depth {im0.depth}")
    info = pixel_format_info(im0.yuv_format)
    quantizer = ((100 - params.quality) * 63 + 50) // 100
    qindex = max(1, min(255, quantizer * 4))
    if params.cq_level is not None:
        qindex = max(1, min(255, int(params.cq_level) * 4))
    cdef_on = params.cdef is not False and params.speed <= 8
    frames = [
        [im.yuv_planes[c] for c in range(_coded_planes(im))] for im in images
    ]
    payloads = encode_inter_sequence(
        frames, qindex, speed=params.speed,
        monochrome=info.monochrome,
        subsampling_x=info.chroma_shift_x,
        subsampling_y=info.chroma_shift_y,
        bit_depth=im0.depth,
        color_primaries=int(im0.color_primaries),
        transfer_characteristics=int(im0.transfer_characteristics),
        matrix_coefficients=int(im0.matrix_coefficients),
        color_range=1 if im0.yuv_range == Range.FULL else 0,
        enable_deblock=params.deblock is not False,
        enable_cdef=cdef_on, cdef_search=cdef_on,
    )
    from ..containers.obu import find_sequence_header

    hdr = find_sequence_header(payloads[0])
    return [(p, hdr) for p in payloads]


def encode_frame(image: Image, params: FrameParams) -> tuple[bytes, SequenceHeader]:
    """Encode one still frame. Returns (obu_bytes, sequence_header)."""
    if image.depth not in (8, 10, 12):
        raise AvifError(Result.UNSUPPORTED_DEPTH, f"depth {image.depth}")
    spec_on = params.codec == "spec" or (
        params.codec == "auto" and _spec_av1_enabled()
    )
    if spec_on and not params.lossless:
        # default lossy output is spec-conformant AV1 (the reference's
        # only encoder is libaom, write.c:2104-2114); codec="native"
        # opts into the device-pipelined own format
        return _encode_frame_spec_lossy(image, params)
    if params.lossless and spec_on:
        # lossless rides the spec-conformant AV1 path at every depth so
        # the files interoperate with every AVIF decoder
        return _encode_frame_spec_lossless(image, params)
    # single frame = one-element pipelined batch (byte-identity is tested)
    return encode_frames_pipelined([image], params)[0]


def decode_frames_pipelined(streams: list[bytes]) -> list[Image]:
    """Batch decode of independent OBU streams (animation samples, grid
    cells): host entropy for ALL tiles runs on a shared pool, every
    frame's device program is dispatched before any fetch, and D2H copies
    overlap (the decode-side mirror of encode_frames_pipelined)."""
    import os

    # spec-AV1 payloads (foreign or our lossless output) take the
    # sequential path; only the own-format streams pipeline on device
    if any(
        not any(
            o.obu_type == OBU_FRAME and o.payload and o.payload[0] == FRAME_MAGIC
            for o in split_obus(d)
        )
        for d in streams
    ):
        return [decode_frame(d) for d in streams]
    metas = []
    for data in streams:
        seq = None
        frame = None
        for obu in split_obus(data):
            if obu.obu_type == OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(obu.payload)
            elif obu.obu_type == OBU_FRAME:
                frame = obu
        if seq is None or frame is None:
            raise AvifError(Result.BMFF_PARSE_FAILED, "missing seq header or frame")
        s = ROStream(frame.payload)
        if s.read_u8() != FRAME_MAGIC:
            raise AvifError(Result.BMFF_PARSE_FAILED, "bad frame magic")
        qindex = s.read_u8()
        n = 1 << s.read_u8()
        flags = s.read_u8()
        lossless = bool(flags & 1)
        deblock = bool(flags & 2) and not lossless
        cdef = bool(flags & 4) and not lossless
        if n not in (4, 8, 16, 32):
            raise AvifError(Result.BMFF_PARSE_FAILED, f"bad tx size {n}")
        w, h = seq.max_frame_width, seq.max_frame_height
        planes = []
        for c in range(_coded_planes(seq)):
            size = read_leb128(s)
            payload = s.read(size)
            pw, ph = _plane_dims(seq, c, w, h)
            planes.append((payload, -(-ph // n), -(-pw // n), pw, ph))
        metas.append((seq, qindex, n, lossless, deblock, planes, cdef))

    workers = max(2, min(16, (os.cpu_count() or 4)))
    with ThreadPoolExecutor(workers) as pool:
        ent_futs = [
            [
                _submit_plane_decode(pool, payload, rb, cb, meta[2], not meta[3])
                for payload, rb, cb, _, _ in meta[5]
            ]
            for meta in metas
        ]
        keyed = []  # (config key, packed parts) per frame
        for meta, futs in zip(metas, ent_futs):
            seq, qindex, n, lossless, deblock, planes, cdef = meta
            depth = seq.bit_depth
            dc, ac = (1, 1) if lossless else step_sizes(qindex, depth)
            pack = np.int32 if lossless else np.int16
            parts = []
            for plane_futs in futs:
                levels, modes, txs = _assemble_plane_decode(plane_futs, not lossless)
                if pack == np.int16:
                    levels = np.clip(levels, -32768, 32767)
                parts.append(modes.reshape(-1).astype(pack))
                parts.append(txs.reshape(-1).astype(pack))
                parts.append(levels.reshape(-1).astype(pack))
            geoms = tuple((rb, cb) for _, rb, cb, _, _ in planes)
            thresh = deblock_threshold(ac, depth) if deblock else 0
            cthresh = cdef_threshold(ac, depth) if cdef else 0
            key = (geoms, n, depth, lossless, dc, ac, thresh, cthresh,
                   deblock and thresh > 0, cdef and cthresh > 0)
            keyed.append((key, np.concatenate(parts)))

        # Uniform batches (grid cells, animation frames) decode as one
        # program, frame axis sharded over the codec mesh (shard.py).
        mesh = None
        if len(keyed) > 1:
            from ..parallel.shard import default_codec_mesh

            mesh = default_codec_mesh()
        if (
            mesh is not None
            and len({(k, p.shape) for k, p in keyed}) == 1
        ):
            from ..parallel.shard import decode_packed_frames_sharded

            geoms, n, depth, lossless, dc, ac, thresh, cthresh, dbl, cdf = keyed[0][0]
            batch = np.stack([p for _, p in keyed])
            res = decode_packed_frames_sharded(
                batch, dc, ac, thresh, cthresh,
                geoms=geoms, n=n, depth=depth, lossless=lossless,
                deblock=dbl, cdef=cdf, mesh=mesh,
            )
            host = np.asarray(res)  # one packed fetch
            staged = [host[i] for i in range(len(keyed))]
        else:
            staged = []
            for key, packed in keyed:
                geoms, n, depth, lossless, dc, ac, thresh, cthresh, dbl, cdf = key
                staged.append(
                    recon.decode_frame_device(
                        packed, np.int32(dc), np.int32(ac), np.int32(thresh),
                        np.int32(cthresh),
                        geoms=geoms, n=n, depth=depth, lossless=lossless,
                        deblock=dbl, cdef=cdf,
                    )
                )
            for r in staged:
                if hasattr(r, "copy_to_host_async"):
                    r.copy_to_host_async()

    out = []
    for meta, result in zip(metas, staged):
        seq, qindex, n, lossless, deblock, planes, cdef = meta
        result = np.asarray(result)
        img = _image_for_header(seq, seq.max_frame_width, seq.max_frame_height)
        off = 0
        for c, (_, rb, cb, pw, ph) in enumerate(planes):
            hp, wp = rb * n, cb * n
            plane = result[off : off + hp * wp].reshape(hp, wp)
            off += hp * wp
            img.yuv_planes[c][:, :] = plane[:ph, :pw].astype(img.dtype)
        out.append(img)
    return out


def _image_for_header(seq: SequenceHeader, w: int, h: int) -> Image:
    if seq.monochrome:
        fmt = PixelFormat.YUV400
    elif seq.subsampling_x and seq.subsampling_y:
        fmt = PixelFormat.YUV420
    elif seq.subsampling_x:
        fmt = PixelFormat.YUV422
    else:
        fmt = PixelFormat.YUV444
    out = Image(w, h, seq.bit_depth, fmt)
    out.yuv_range = Range.FULL if seq.color_range else Range.LIMITED
    out.color_primaries = seq.color_primaries
    out.transfer_characteristics = seq.transfer_characteristics
    out.matrix_coefficients = seq.matrix_coefficients
    out.chroma_sample_position = ChromaSamplePosition(seq.chroma_sample_position)
    out.allocate_planes("yuv")
    return out


def _plane_dims(hdr: SequenceHeader, c: int, width: int, height: int) -> tuple[int, int]:
    if c == 0:
        return width, height
    return (
        (width + hdr.subsampling_x) >> hdr.subsampling_x,
        (height + hdr.subsampling_y) >> hdr.subsampling_y,
    )


def decode_frame(
    data: bytes, width: int = 0, height: int = 0, stream=None
) -> Image:
    """Decode an OBU stream into an Image (planes + format + CICP).

    width/height override the sequence-header size when the container's
    ispe disagrees (the container wins, read.c:5316-5349 semantics).
    `stream` (an av1.stream.StreamDecoder) carries reference-frame state
    across calls so animation samples may be inter frames — the role of
    the persistent dav1d context behind codec_dav1d.c:100-156.
    """
    # Keep the LAST (seq, frame) pair: progressive layers are concatenated
    # self-contained streams, and a cumulative byte prefix through layer k
    # must decode to layer k (read.c:690-730 sample semantics).
    seq: SequenceHeader | None = None
    frame: Obu | None = None
    foreign = False
    for obu in split_obus(data):
        if obu.obu_type == OBU_SEQUENCE_HEADER:
            seq = parse_sequence_header(obu.payload)
        elif obu.obu_type == OBU_FRAME:
            frame = obu
        elif obu.obu_type in (3, 4):  # FRAME_HEADER / TILE_GROUP split
            foreign = True
    if foreign or (frame is not None and (not frame.payload or frame.payload[0] != FRAME_MAGIC)):
        # real AV1 payload (foreign file or our spec-conformant output)
        obus = split_obus(data)
        if any(
            o.obu_type == OBU_FRAME and o.payload and o.payload[0] == FRAME_MAGIC
            for o in obus
        ):
            # layered stream (write_progressive): native layers followed by
            # one spec temporal unit — decode the final (best) layer only;
            # the spec parser must not see the native frame payloads
            from ..containers.obu import OBU_TEMPORAL_DELIMITER

            td = max(
                i for i, o in enumerate(obus)
                if o.obu_type == OBU_TEMPORAL_DELIMITER
            )
            s = RWStream()
            for o in obus[td:]:
                write_obu(s, o.obu_type, o.payload)
            data = s.data()
        return _decode_frame_spec(data, width, height, stream)
    if seq is None or frame is None:
        raise AvifError(Result.BMFF_PARSE_FAILED, "missing sequence header or frame OBU")

    w = width or seq.max_frame_width
    h = height or seq.max_frame_height
    depth = seq.bit_depth

    s = ROStream(frame.payload)
    if s.read_u8() != FRAME_MAGIC:
        raise AvifError(Result.BMFF_PARSE_FAILED, "bad frame magic")
    qindex = s.read_u8()
    n = 1 << s.read_u8()
    flags = s.read_u8()
    lossless = bool(flags & 1)
    deblock = bool(flags & 2) and not lossless
    cdef = bool(flags & 4) and not lossless
    if n not in (4, 8, 16, 32):
        raise AvifError(Result.BMFF_PARSE_FAILED, f"bad tx size {n}")
    dc, ac = (1, 1) if lossless else step_sizes(qindex, depth)

    if seq.monochrome:
        fmt = PixelFormat.YUV400
    elif seq.subsampling_x and seq.subsampling_y:
        fmt = PixelFormat.YUV420
    elif seq.subsampling_x:
        fmt = PixelFormat.YUV422
    else:
        fmt = PixelFormat.YUV444

    out = Image(w, h, depth, fmt)
    out.yuv_range = Range.FULL if seq.color_range else Range.LIMITED
    out.color_primaries = seq.color_primaries
    out.transfer_characteristics = seq.transfer_characteristics
    out.matrix_coefficients = seq.matrix_coefficients
    out.chroma_sample_position = ChromaSamplePosition(seq.chroma_sample_position)
    out.allocate_planes("yuv")

    # Pipeline: host entropy for all planes (threaded; native releases the
    # GIL), then ONE packed device upload/program/fetch for all planes.
    plane_meta = []
    for c in range(_coded_planes(seq)):
        size = read_leb128(s)
        payload = s.read(size)
        pw, ph = _plane_dims(seq, c, w, h)
        rb, cb = -(-ph // n), -(-pw // n)
        plane_meta.append((payload, rb, cb, pw, ph))

    import os

    try:
        with ThreadPoolExecutor(max(2, min(16, os.cpu_count() or 4))) as pool:
            plane_futs = [
                _submit_plane_decode(pool, payload, rb, cb, n, not lossless)
                for payload, rb, cb, _, _ in plane_meta
            ]
            decoded = [_assemble_plane_decode(f, not lossless) for f in plane_futs]
    except ValueError as e:
        raise AvifError(Result.BMFF_PARSE_FAILED, f"tile entropy error: {e}") from e

    pack_dtype = np.int32 if lossless else np.int16
    parts = []
    for levels, modes, txs in decoded:
        # Lossy levels are re-bounded into int16 range; hostile streams may
        # carry larger values, which the decoder clamp handles either way.
        if pack_dtype == np.int16:
            levels = np.clip(levels, -32768, 32767)
        parts.append(modes.reshape(-1).astype(pack_dtype))
        parts.append(txs.reshape(-1).astype(pack_dtype))
        parts.append(levels.reshape(-1).astype(pack_dtype))
    packed = np.concatenate(parts)
    geoms = tuple((rb, cb) for _, rb, cb, _, _ in plane_meta)
    thresh = deblock_threshold(ac, depth) if deblock else 0
    cthresh = cdef_threshold(ac, depth) if cdef else 0
    result = np.asarray(
        recon.decode_frame_device(
            packed, np.int32(dc), np.int32(ac), np.int32(thresh), np.int32(cthresh),
            geoms=geoms, n=n, depth=depth, lossless=lossless,
            deblock=deblock and thresh > 0, cdef=cdef and cthresh > 0,
        )
    )
    off = 0
    for c, (_, rb, cb, pw, ph) in enumerate(plane_meta):
        hp, wp = rb * n, cb * n
        plane = result[off : off + hp * wp].reshape(hp, wp)
        off += hp * wp
        out.yuv_planes[c][:, :] = plane[:ph, :pw].astype(out.dtype)
    return out
