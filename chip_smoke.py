"""Smoke run of the engine's device paths on one GPU, at deployment size.

Drives the main path once through the entry points a user calls
(`Encoder`, `Decoder`, `encode_batch`, the pixel pipeline) on a
camera-sized 4032x3024 8-bit 4:2:0 photo encoded at avifenc's defaults
(quality 75, speed 6), decodes it back to RGB, runs the own-format codec
and a 4096x4096 grid of 16 cells, and compares every device result with
the same program on JAX's CPU backend in this process, or with the
encoder's mirror reconstruction. Content is generated from --seed.

Phases, one JSON line each: env, spec_encode, batch, rgb, native, grid,
gpu_tests. A phase that fails makes the script exit 1; the last line,
printed only when every phase passed, is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

    python chip_smoke.py              # one GPU
    python chip_smoke.py --chips 4    # only the 4-GPU codec mesh vs card 0

Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

QUALITY = 75
SPEED = 6
PHOTO = (4032, 3024)    # 12 MP camera still (width, height)
HD = (1920, 1080)
GRID = (1024, 4)        # cell size, cells per side: 4096x4096 (BASELINE config 4)


def card_info() -> list[str]:
    """`nvidia-smi` name and power limit of every card, read in a child
    process that does not touch JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return [line.strip() for line in out.splitlines() if line.strip()]


@dataclasses.dataclass
class Smoke:
    """One smoke run: sizes, seed, the reference (CPU) device, and what
    earlier phases hand to later ones."""

    ref: object                       # CPU device the results are compared with
    card: str = ""
    seed: int = 0
    photo: tuple = PHOTO
    hd: tuple = HD
    grid: tuple = GRID
    spec_data: bytes | None = None
    spec_image: object = None
    spec_decoded: object = None


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def make_image(width: int, height: int, seed: int):
    """Natural-looking 8-bit 4:2:0 content: box-smoothed noise at two
    scales plus flat-shaded rectangles and half-planes for hard edges."""
    from libavif_tpu.constants import PixelFormat
    from libavif_tpu.image import Image

    rng = np.random.default_rng(seed)

    def smooth(h, w, k):
        base = rng.integers(0, 256, (h + k, w + k)).astype(np.float64)
        c = np.pad(np.cumsum(np.cumsum(base, 0), 1), ((1, 0), (1, 0)))
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])[:h, :w] / (k * k)

    def plane(h, w, edges):
        p = 0.5 * smooth(h, w, 5) + 0.5 * smooth(h, w, 31)
        p = (p - p.mean()) * 2.5 + 128
        yy, xx = np.ogrid[:h, :w]
        for _ in range(edges):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            y1 = min(h, y0 + rng.integers(h // 16 + 1, h // 3 + 2))
            x1 = min(w, x0 + rng.integers(w // 16 + 1, w // 3 + 2))
            p[y0:y1, x0:x1] += rng.uniform(-50, 50)
        for _ in range(edges // 4):
            a, b = rng.uniform(-1, 1, 2)
            p[(a * (yy - h / 2) + b * (xx - w / 2)) > 0] += rng.uniform(-25, 25)
        return np.clip(np.rint(p), 0, 255).astype(np.uint8)

    img = Image(width, height, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    for c, p in enumerate(img.yuv_planes):
        p[:] = plane(*p.shape, 24 if c == 0 else 8)
    return img


def _planes(img):
    return [np.asarray(p) for p in img.yuv_planes if p is not None]


def _same_planes(a, b) -> bool:
    return all(np.array_equal(x, y[: x.shape[0], : x.shape[1]])
               for x, y in zip(_planes(a), b))


def _ypsnr(decoded, source) -> float:
    a = np.asarray(decoded.yuv_planes[0], np.float64)
    b = np.asarray(source.yuv_planes[0], np.float64)
    return float(10 * np.log10(255.0 ** 2 / np.mean((a - b) ** 2)))


def compare_cost_tables(dev_flat, ref_flat, meta) -> dict:
    """satd/delta must be equal. dist/rate are compared by relative
    difference |a-b| / max(|a|, |b|, 1); a rate entry beyond
    DIST_RATE_RTOL counts as a flip, measured in coefficient bit costs
    (see rdsearch_device.DIST_RATE_RTOL)."""
    from libavif_tpu.codec.av1 import rdsearch as R
    from libavif_tpu.codec.av1.rdsearch_device import (DIST_RATE_RTOL,
                                                       RATE_FLIP_SHARE)

    coef = R._COEF_NZ_X16 + R._COEF_MAG_X16
    out = {"satd_mismatches": 0, "delta_mismatches": 0, "dist_max_rel": 0.0,
           "dist_over_rtol": 0, "rate_max_rel_unflipped": 0.0, "rate_flips": 0,
           "rate_entries": 0, "rate_max_flip_coefs": 0.0, "rate_max_rel": 0.0,
           "rtol": DIST_RATE_RTOL, "rate_flip_share_max": RATE_FLIP_SHARE}
    for kind, _key, _shape, lo, hi in meta["layout"]:
        a = np.asarray(dev_flat[lo:hi], np.float64)
        b = np.asarray(ref_flat[lo:hi], np.float64)
        if kind in ("satd", "delta"):
            out[f"{kind}_mismatches"] += int((a != b).sum())
            continue
        rel = np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
        over = rel > DIST_RATE_RTOL
        if kind == "dist":
            out["dist_max_rel"] = max(out["dist_max_rel"], float(rel.max()))
            out["dist_over_rtol"] += int(over.sum())
        else:
            out["rate_entries"] += rel.size
            out["rate_flips"] += int(over.sum())
            out["rate_max_rel"] = max(out["rate_max_rel"], float(rel.max()))
            if (~over).any():
                out["rate_max_rel_unflipped"] = max(
                    out["rate_max_rel_unflipped"], float(rel[~over].max()))
            if over.any():
                out["rate_max_flip_coefs"] = max(
                    out["rate_max_flip_coefs"], float(np.abs(a - b)[over].max() / coef))
    out["rate_flip_share"] = out["rate_flips"] / max(out["rate_entries"], 1)
    return out


def tables_agree(t: dict) -> list:
    """The tolerance checks on compare_cost_tables' result."""
    return [
        (t["satd_mismatches"] == 0, "satd tables differ from the CPU backend"),
        (t["delta_mismatches"] == 0, "delta tables differ from the CPU backend"),
        (t["dist_over_rtol"] == 0, "dist tables outside DIST_RATE_RTOL"),
        (t["rate_flip_share"] <= t["rate_flip_share_max"], "too many rate flips"),
    ]


def verdict(res: dict, checks) -> dict:
    """Record which (passed, what) checks failed; the phase fails if any did."""
    res["failed"] = [what for passed, what in checks if not passed]
    return res


def _memory(compiled) -> dict:
    stats = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(stats, k, None) for k in keys} if stats is not None else {}


class _Recorder:
    """Wraps a module function and records what each call returned."""

    def __init__(self, module, name, keep=lambda r: r):
        self.module, self.name, self.keep = module, name, keep
        self.orig = getattr(module, name)
        self.seen = []

    def __enter__(self):
        def wrapper(*a, **k):
            r = self.orig(*a, **k)
            self.seen.append(self.keep(r))
            return r

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class _MirrorRecorder:
    """Collects the spec encoder's mirror reconstruction of every still
    it encodes (encode._encode_still leaves it in `.last_recon`)."""

    def __enter__(self):
        from libavif_tpu.codec.av1 import encode as E

        self.E, self.orig, self.recons = E, E._encode_still, []

        def wrapper(*a, **k):
            r = self.orig(*a, **k)
            self.recons.append([np.asarray(p) for p in E._encode_still.last_recon])
            return r

        E._encode_still = wrapper
        return self

    def __exit__(self, *exc):
        self.E._encode_still = self.orig


def _encoder(codec: str = "auto"):
    from libavif_tpu.api import Encoder

    enc = Encoder()
    enc.quality, enc.speed, enc.codec_choice = QUALITY, SPEED, codec
    return enc


# ------------------------------------------------------------------ phases


def phase_spec_encode(s: Smoke) -> dict:
    """Default spec encoder at camera size: the device RD program against
    the CPU backend, the stream against the mirror, and the numpy
    planner's size and Y-PSNR."""
    import jax

    from libavif_tpu.api import Decoder
    from libavif_tpu.codec.av1 import rdsearch_device as RDD
    from libavif_tpu.codec.frame import FrameParams, _spec_qindex

    img = make_image(*s.photo, s.seed)
    y = np.asarray(img.yuv_planes[0], np.int32)
    fn, meta, args, _ = RDD.cost_program(
        y, _spec_qindex(FrameParams(quality=QUALITY)), SPEED, 8)
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    dev_flat = np.asarray(compiled(*args))
    t0 = time.perf_counter()
    dev_flat = np.asarray(compiled(*args))
    warm_s = time.perf_counter() - t0
    with jax.default_device(s.ref):
        ref_flat = np.asarray(fn(*args))
    tables = compare_cost_tables(dev_flat, ref_flat, meta)

    with _Recorder(RDD, "plan_costs_device", lambda r: r is not None) as rd, \
            _MirrorRecorder() as mirror:
        t0 = time.perf_counter()
        data = _encoder().write(img)
        encode_s = time.perf_counter() - t0
    decoded = Decoder().read(data)
    os.environ["LIBAVIF_TPU_DEVICE_RD"] = "0"
    try:
        t0 = time.perf_counter()
        data_np = _encoder().write(img)
        numpy_encode_s = time.perf_counter() - t0
    finally:
        del os.environ["LIBAVIF_TPU_DEVICE_RD"]
    psnr, psnr_np = _ypsnr(decoded, img), _ypsnr(Decoder().read(data_np), img)
    s.spec_data, s.spec_image, s.spec_decoded = data, img, decoded
    res = dict(
        compile_s=compile_s, warm_s=warm_s, encode_s=encode_s,
        numpy_encode_s=numpy_encode_s, memory=_memory(compiled), tables=tables,
        device_rd_calls=rd.seen, bytes=len(data), numpy_bytes=len(data_np),
        y_psnr=psnr, numpy_y_psnr=psnr_np,
        decoded_equals_mirror=_same_planes(decoded, mirror.recons[-1]),
    )
    return verdict(res, [
        (rd.seen == [True], "device RD program did not run"),
        *tables_agree(tables),
        (res["decoded_equals_mirror"], "decoded stream differs from the mirror"),
        (abs(len(data) - len(data_np)) < 0.1 * len(data_np),
         "device and numpy planners differ by more than 10% in size"),
        (abs(psnr - psnr_np) < 0.3, "device and numpy planners differ by >= 0.3 dB"),
    ])


def phase_batch(s: Smoke) -> dict:
    """encode_batch on four stills (every frame's RD program dispatched
    ahead of the host walks) equals the single-image encodes."""
    from libavif_tpu.api import encode_batch
    from libavif_tpu.codec.av1 import rdsearch_device as RDD

    check(s.spec_data is not None, "needs spec_encode")
    imgs = [s.spec_image] + [make_image(*s.photo, s.seed + i) for i in (1, 2, 3)]
    with _Recorder(RDD, "dispatch_plan_costs", lambda r: r is not None) as rd:
        t0 = time.perf_counter()
        batch = encode_batch(imgs, quality=QUALITY, speed=SPEED)
        batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    singles = [s.spec_data] + [_encoder().write(im) for im in imgs[1:]]
    singles_s = time.perf_counter() - t0
    res = dict(warm_s=batch_s, singles_s=singles_s, dispatched=rd.seen,
               equal=[a == b for a, b in zip(batch, singles)])
    return verdict(res, [
        (rd.seen == [True] * 4, "batch did not dispatch four device RD programs"),
        (all(res["equal"]), "batch encode differs from single encodes"),
    ])


def phase_rgb(s: Smoke) -> dict:
    """Decode-to-RGB of the phase-1 file against the CPU backend: equal,
    or off by one code value where the GPU contracts a multiply-add."""
    import jax

    from libavif_tpu.constants import RGBFormat
    from libavif_tpu.image import RGBImage
    from libavif_tpu.pixels.reformat import image_yuv_to_rgb

    check(s.spec_decoded is not None, "needs spec_encode")
    img = s.spec_decoded

    def convert():
        rgb = RGBImage(img.width, img.height, 8, RGBFormat.RGB)
        image_yuv_to_rgb(img, rgb)
        return rgb.pixels

    t0 = time.perf_counter()
    px = convert()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    px = convert()
    warm_s = time.perf_counter() - t0
    with jax.default_device(s.ref):
        ref = convert()
    diff = np.abs(px.astype(np.int16) - ref.astype(np.int16))
    res = dict(compile_s=cold_s - warm_s, warm_s=warm_s, shape=list(px.shape),
               n_diff=int((diff > 0).sum()), max_diff=int(diff.max()))
    return verdict(res, [
        (px.shape == ref.shape, "RGB shape differs"),
        (res["max_diff"] <= 1, "RGB differs from the CPU backend by more than 1"),
    ])


def _native_roundtrip(img):
    from libavif_tpu.api import Decoder, encode_batch

    data = encode_batch([img], quality=QUALITY, speed=SPEED, codec="native")[0]
    return data, _planes(Decoder().read(data))


def transform_stage_time(width: int, height: int, reps: int = 20) -> dict:
    """One wavefront step's forward + inverse transform batch (every lane
    of the luma diagonal x 13 modes, 16x16 int32 einsums) and the
    number of scan steps a frame of this size takes."""
    import jax

    from libavif_tpu.ops import transforms as T

    rb, cb = -(-height // 16), -(-width // 16)
    x = np.random.default_rng(0).integers(-255, 256, (rb * 13, 16, 16)).astype(np.int32)
    step = jax.jit(lambda r: T.inverse_transform(
        T.forward_transform(r, T.DCT_DCT, 16), T.DCT_DCT, 16))
    xd = jax.device_put(x)
    t0 = time.perf_counter()
    step(xd).block_until_ready()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(xd)
    out.block_until_ready()
    return dict(blocks=int(x.shape[0]), compile_s=compile_s,
                per_step_s=(time.perf_counter() - t0) / reps,
                luma_scan_steps=rb + cb - 1)


def phase_native(s: Smoke) -> dict:
    """Own-format codec through encode_batch/Decoder at 1920x1080 and at
    camera size; the 1080p bytes and planes equal the CPU backend's."""
    import jax

    res = {}
    for name, size in (("hd", s.hd), ("photo", s.photo)):
        img = make_image(*size, s.seed + 20)
        t0 = time.perf_counter()
        data, planes = _native_roundtrip(img)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data, planes = _native_roundtrip(img)
        warm_s = time.perf_counter() - t0
        r = dict(compile_s=cold_s - warm_s, warm_s=warm_s, bytes=len(data),
                 y_psnr=float(10 * np.log10(255.0 ** 2 / np.mean(
                     (planes[0].astype(np.float64) - img.yuv_planes[0]) ** 2))))
        if name == "hd":
            with jax.default_device(s.ref):
                ref_data, ref_planes = _native_roundtrip(img)
            r["bytes_equal_cpu"] = data == ref_data
            r["planes_equal_cpu"] = all(
                np.array_equal(a, b) for a, b in zip(planes, ref_planes))
        res[name] = r
    res["transform_stage"] = transform_stage_time(*s.photo)
    return verdict(res, [
        (res["hd"]["bytes_equal_cpu"], "own-format bytes differ from the CPU backend"),
        (res["hd"]["planes_equal_cpu"], "own-format planes differ from the CPU backend"),
    ])


def _grid_cells(s: Smoke):
    from libavif_tpu.constants import PixelFormat
    from libavif_tpu.image import Image

    cell, k = s.grid
    big = make_image(cell * k, cell * k, s.seed + 30)
    cells = []
    for r in range(k):
        for c in range(k):
            im = Image(cell, cell, 8, PixelFormat.YUV420)
            im.allocate_planes("yuv")
            for p, src in zip(im.yuv_planes, big.yuv_planes):
                h, w = p.shape
                p[:] = src[r * h:(r + 1) * h, c * w:(c + 1) * w]
            cells.append(im)
    return cells


def native_mirror(img, enc) -> list:
    """The own-format encoder's reconstruction of `img`, with the decoder's
    output filters applied: what a conformant decode must return."""
    from libavif_tpu.codec import recon
    from libavif_tpu.ops.filters import (cdef_plane, cdef_threshold,
                                         deblock_plane, deblock_threshold)
    from libavif_tpu.ops.quant import step_sizes

    params = enc._params(enc.quality)
    n = params.tx_size
    dc, ac = step_sizes(params.qindex, img.depth)
    out = []
    for p in _planes(img):
        padded = recon.pad_to_blocks(p, n).astype(np.int32)
        rec = recon.encode_plane(padded, np.int32(dc), np.int32(ac), n=n,
                                 depth=img.depth, lossless=False, speed=params.speed)[2]
        thresh = deblock_threshold(ac, img.depth)
        if params.deblock_enabled and thresh > 0:
            rec = deblock_plane(rec, np.int32(thresh), n=n)
        cthresh = cdef_threshold(ac, img.depth)
        if params.cdef_enabled and cthresh > 0:
            rec = cdef_plane(rec, np.int32(cthresh))
        out.append(np.asarray(rec)[: p.shape[0], : p.shape[1]])
    return out


def _grid_roundtrip(s: Smoke, cells, codec: str):
    from libavif_tpu.api import Decoder

    cell, k = s.grid
    with _MirrorRecorder() as mirror:
        t0 = time.perf_counter()
        blob = _encoder(codec).write_grid(cells, columns=k, rows=k)
        encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = Decoder().read(blob)
    decode_s = time.perf_counter() - t0
    return blob, out, mirror.recons, encode_s, decode_s


def _cell_of(out, idx: int, k: int) -> list:
    r, c = divmod(idx, k)
    res = []
    for p in _planes(out):
        h, w = p.shape[0] // k, p.shape[1] // k
        res.append(p[r * h:(r + 1) * h, c * w:(c + 1) * w])
    return res


def phase_grid(s: Smoke) -> dict:
    """4096x4096 grid of 16 cells through Encoder.write_grid and Decoder,
    with both codecs; every decoded cell equals its mirror."""
    cell, k = s.grid
    cells = _grid_cells(s)
    res, checks = {}, []
    for codec in ("auto", "native"):
        blob, out, recons, encode_s, decode_s = _grid_roundtrip(s, cells, codec)
        if codec == "native":
            recons = [native_mirror(im, _encoder("native")) for im in cells]
        check(len(recons) == len(cells), f"{codec}: one mirror per cell")
        equal = [all(np.array_equal(a, b[: a.shape[0], : a.shape[1]])
                     for a, b in zip(_cell_of(out, i, k), recons[i]))
                 for i in range(len(cells))]
        res[codec] = dict(encode_s=encode_s, decode_s=decode_s, bytes=len(blob),
                          size=[out.width, out.height], cells_equal_mirror=sum(equal))
        checks += [((out.width, out.height) == (cell * k, cell * k), f"{codec}: grid size"),
                   (all(equal), f"{codec}: decoded grid differs from the mirror")]
    return verdict(res, checks)


class _Outcomes:
    """pytest plugin that counts test outcomes."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_gpu_tests(s: Smoke) -> dict:
    """The tests marked `gpu`, in this process (one process per card)."""
    import pytest

    root = os.path.dirname(os.path.abspath(__file__))
    plugin = _Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests")], plugins=[plugin])
    res = dict(rc=int(rc), outcomes=plugin.counts, warm_s=time.perf_counter() - t0)
    return verdict(res, [
        (rc == 0, "gpu-marked tests failed"),
        (plugin.counts.get("passed", 0) > 0 and set(plugin.counts) == {"passed"},
         "gpu-marked tests did not all run and pass"),
    ])


def phase_mesh(s: Smoke, mesh) -> dict:
    """Own-format codec (phases native + grid) with the frames x cells
    codec mesh over every device, then with no mesh on device 0: bytes
    and reconstructions identical, and the sharded batches spread over
    all devices of the mesh."""
    import jax

    from libavif_tpu.api import Decoder, encode_batch
    from libavif_tpu.parallel import shard

    n_dev = mesh.devices.size
    batches = {name: [make_image(*size, s.seed + 40 + i) for i in range(n_dev)]
               for name, size in (("hd", s.hd), ("photo", s.photo))}
    cells = _grid_cells(s)
    cell, k = s.grid

    def run():
        out = {}
        for name, imgs in batches.items():
            t0 = time.perf_counter()
            data = encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native")
            out[name] = (data, [_planes(Decoder().read(d)) for d in data],
                         time.perf_counter() - t0)
        t0 = time.perf_counter()
        blob = _encoder("native").write_grid(cells, columns=k, rows=k)
        out["grid"] = (blob, _planes(Decoder().read(blob)), time.perf_counter() - t0)
        return out

    def spread(r):
        return len(r.sharding.device_set)

    shard.set_default_codec_mesh(mesh)
    try:
        with _Recorder(shard, "encode_packed_frames_sharded", spread) as enc_rec, \
                _Recorder(shard, "decode_packed_frames_sharded", spread) as dec_rec:
            run()                       # compile
            sharded = run()
        shard.set_default_codec_mesh(None)
        with jax.default_device(jax.devices()[0]):
            run()
            single = run()
    finally:
        shard.set_default_codec_mesh(None)

    def same(a, b):
        pa, pb = _flat(a[1]), _flat(b[1])
        return a[0] == b[0] and len(pa) == len(pb) and all(
            np.array_equal(x, y) for x, y in zip(pa, pb))

    res = {name: dict(sharded_s=sharded[name][2], single_s=single[name][2],
                      identical=same(sharded[name], single[name]))
           for name in sharded}
    res["devices"] = n_dev
    res["encode_spread"] = enc_rec.seen
    res["decode_spread"] = dec_rec.seen
    return verdict(res, [
        (all(res[k]["identical"] for k in sharded), "sharded and single-device results differ"),
        (bool(enc_rec.seen) and all(n == n_dev for n in enc_rec.seen),
         "sharded encode did not land on every device"),
        (bool(dec_rec.seen) and all(n == n_dev for n in dec_rec.seen),
         "sharded decode did not land on every device"),
    ])


def _flat(x):
    if isinstance(x, np.ndarray):
        return [x]
    return [y for item in x for y in _flat(item)]


# -------------------------------------------------------------------- main


def _emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def _run_phase(name, fn, s: Smoke, *args) -> bool:
    try:
        res = fn(s, *args)
        ok = not res["failed"]
    except Exception as e:  # report the failing phase, then fail the run
        res = {"error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        ok = False
    _emit({"phase": name, "ok": ok, "card": s.card, **res})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    # The comparisons need JAX's CPU backend beside the GPU.
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    from libavif_tpu import native
    from libavif_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    devices = jax.devices()
    if len(devices) < args.chips:
        print(f"--chips {args.chips} needs {args.chips} GPUs; JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 1
    cards = card_info()
    for line in cards:
        print(line, flush=True)
    s = Smoke(ref=jax.devices("cpu")[0], card=cards[0], seed=args.seed)

    t0 = time.perf_counter()
    lib = native.load()
    env = dict(jax=jax.__version__, devices=[str(d) for d in devices],
               device_kind=devices[0].device_kind, compile_cache=cache,
               native_lib=lib is not None, native_load_s=time.perf_counter() - t0)
    if lib is None:
        env["native_error"] = native.load_error()
    _emit({"phase": "env", "ok": lib is not None, "card": s.card, **env})
    ok = lib is not None
    if args.chips == 4:
        from libavif_tpu.parallel.shard import default_codec_mesh

        ok &= _run_phase("mesh", phase_mesh, s, default_codec_mesh())
    else:
        for name, fn in (("spec_encode", phase_spec_encode), ("batch", phase_batch),
                         ("rgb", phase_rgb), ("native", phase_native),
                         ("grid", phase_grid), ("gpu_tests", phase_gpu_tests)):
            ok &= _run_phase(name, fn, s)
    if not ok:
        return 1
    _emit({"ok": True, "device": {"platform": devices[0].platform,
                                  "kind": devices[0].device_kind,
                                  "count": len(devices)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
