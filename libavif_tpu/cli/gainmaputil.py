"""avifgainmaputil-equivalent CLI (reference: apps/avifgainmaputil/,
1992 LoC C++ — SURVEY.md §2.3).

Subcommands: combine, tonemap, extractgainmap, printmetadata, swapbase.
Run `python -m libavif_tpu.cli.gainmaputil <cmd> -h`.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def _read_avif(path):
    from ..api.decoder import Decoder

    d = Decoder()
    img = d.read(pathlib.Path(path).read_bytes())
    return d, img


def cmd_printmetadata(args) -> int:
    """reference: printmetadata_command.cc."""
    d, img = _read_avif(args.input)
    if img.gain_map is None:
        print("No gain map found", file=sys.stderr)
        return 1
    m = img.gain_map.metadata
    for c in range(3):
        print(
            f"channel {c}: min {float(m.gain_map_min[c]):.6f} "
            f"max {float(m.gain_map_max[c]):.6f} "
            f"gamma {float(m.gain_map_gamma[c]):.6f} "
            f"baseOffset {float(m.base_offset[c]):.6f} "
            f"alternateOffset {float(m.alternate_offset[c]):.6f}"
        )
    print(f"baseHdrHeadroom {float(m.base_hdr_headroom):.6f}")
    print(f"alternateHdrHeadroom {float(m.alternate_hdr_headroom):.6f}")
    print(f"useBaseColorSpace {int(m.use_base_color_space)}")
    return 0


def cmd_extractgainmap(args) -> int:
    """reference: extractgainmap_command.cc."""
    from ..io_formats.png_jpeg import write_png
    from ..io_formats.y4m import write_y4m

    _, img = _read_avif(args.input)
    if img.gain_map is None or img.gain_map.image is None:
        print("No gain map found", file=sys.stderr)
        return 1
    out = pathlib.Path(args.output)
    if out.suffix.lower() == ".y4m":
        write_y4m(out, img.gain_map.image)
    else:
        write_png(out, img.gain_map.image)
    print(f"Wrote {out}", file=sys.stderr)
    return 0


def cmd_combine(args) -> int:
    """SDR base + HDR alternate -> AVIF with gain map
    (reference: combine_command.cc)."""
    from ..api.encoder import Encoder
    from ..hdr.gainmap import compute_gain_map
    from ..io_formats import read_image
    from ..constants import PixelFormat

    base = read_image(args.base)
    alt = read_image(args.alternate)
    fmt = {
        "420": PixelFormat.YUV420,
        "444": PixelFormat.YUV444,
        "400": PixelFormat.YUV400,
    }[args.gain_map_format]
    base.gain_map = compute_gain_map(
        base, alt, gain_map_format=fmt, downscale=args.downscale
    )
    enc = Encoder()
    enc.quality = args.qcolor
    enc.quality_gain_map = args.qgain_map
    data = enc.write(base)
    pathlib.Path(args.output).write_bytes(data)
    print(f"Wrote {args.output}: {len(data)} bytes", file=sys.stderr)
    return 0


def cmd_tonemap(args) -> int:
    """Tone-map to a given headroom (reference: tonemap_command.cc)."""
    from ..hdr.gainmap import apply_gain_map
    from ..image import ContentLightLevelInformationBox

    _, img = _read_avif(args.input)
    if img.gain_map is None:
        print("No gain map found", file=sys.stderr)
        return 1
    clli = ContentLightLevelInformationBox()
    rgb = apply_gain_map(img, img.gain_map, hdr_headroom=args.headroom, clli_out=clli)
    px = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
    try:
        from PIL import Image as PILImage
    except ImportError:
        print("Pillow unavailable", file=sys.stderr)
        return 1
    PILImage.fromarray(px, "RGB").save(args.output)
    print(
        f"Wrote {args.output} (clli {clli.max_cll}/{clli.max_pall})", file=sys.stderr
    )
    return 0


def cmd_swapbase(args) -> int:
    """Swap base and alternate renditions (reference: swapbase_command.cc):
    tone-map fully toward the alternate, recompute the reverse gain map."""
    from ..api.encoder import Encoder
    from ..constants import MatrixCoefficients, PixelFormat, Range
    from ..hdr.gainmap import apply_gain_map, compute_gain_map
    from ..image import Image
    from ..pixels.reformat import rgb_to_yuv_arrays

    _, img = _read_avif(args.input)
    gm = img.gain_map
    if gm is None:
        print("No gain map found", file=sys.stderr)
        return 1
    headroom = float(gm.metadata.alternate_hdr_headroom)
    alt_tc = gm.alt_transfer_characteristics or img.transfer_characteristics
    alt_cp = gm.alt_color_primaries or img.color_primaries
    rgb = apply_gain_map(
        img, gm, hdr_headroom=headroom,
        output_color_primaries=alt_cp,
        output_transfer_characteristics=alt_tc,
    )
    depth = gm.alt_depth or 10
    new_base = Image(img.width, img.height, depth, PixelFormat.YUV444)
    new_base.yuv_range = Range.FULL
    new_base.color_primaries = alt_cp
    new_base.transfer_characteristics = alt_tc
    new_base.matrix_coefficients = MatrixCoefficients.BT601
    maxv = (1 << depth) - 1
    q = np.clip(np.round(rgb * maxv), 0, maxv).astype(new_base.dtype)
    y, u, v = rgb_to_yuv_arrays(
        q, depth=depth, rgb_depth=depth,
        yuv_format=PixelFormat.YUV444, yuv_range=Range.FULL,
        matrix_coefficients=new_base.matrix_coefficients,
        color_primaries=alt_cp,
    )
    new_base.yuv_planes = [y, u, v]
    new_base.gain_map = compute_gain_map(new_base, img)
    enc = Encoder()
    enc.quality = args.qcolor
    data = enc.write(new_base)
    pathlib.Path(args.output).write_bytes(data)
    print(f"Wrote {args.output}: {len(data)} bytes", file=sys.stderr)
    return 0


def cmd_convert(args) -> int:
    """JPEG with embedded gain map -> AVIF (reference: convert_command.cc,
    avifjpeg.c MPF/XMP extraction)."""
    from ..api.encoder import Encoder
    from ..io_formats.jpeg_gainmap import read_jpeg_with_gain_map

    img = read_jpeg_with_gain_map(args.input)
    if img.gain_map is None:
        print("No gain map found in JPEG", file=sys.stderr)
        return 1
    enc = Encoder()
    enc.quality = args.qcolor
    enc.quality_gain_map = args.qgain_map
    data = enc.write(img)
    pathlib.Path(args.output).write_bytes(data)
    print(f"Wrote {args.output}: {len(data)} bytes", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="avifgainmaputil")
    sub = p.add_subparsers(dest="cmd", required=True)

    cv = sub.add_parser("convert", help="JPEG with gain map -> AVIF")
    cv.add_argument("input")
    cv.add_argument("output")
    cv.add_argument("-q", "--qcolor", type=int, default=60)
    cv.add_argument("--qgain-map", type=int, default=60)
    cv.set_defaults(fn=cmd_convert)

    pm = sub.add_parser("printmetadata", help="print gain map metadata")
    pm.add_argument("input")
    pm.set_defaults(fn=cmd_printmetadata)

    ex = sub.add_parser("extractgainmap", help="save the gain map image")
    ex.add_argument("input")
    ex.add_argument("output")
    ex.set_defaults(fn=cmd_extractgainmap)

    co = sub.add_parser("combine", help="combine SDR+HDR into gain-map AVIF")
    co.add_argument("base")
    co.add_argument("alternate")
    co.add_argument("output")
    co.add_argument("-q", "--qcolor", type=int, default=60)
    co.add_argument("--qgain-map", type=int, default=60)
    co.add_argument("--gain-map-format", choices=("420", "444", "400"), default="420")
    co.add_argument("--downscale", type=int, default=1)
    co.set_defaults(fn=cmd_combine)

    tm = sub.add_parser("tonemap", help="tone-map to a target HDR headroom")
    tm.add_argument("input")
    tm.add_argument("output")
    tm.add_argument("--headroom", type=float, default=0.0)
    tm.set_defaults(fn=cmd_tonemap)

    sb = sub.add_parser("swapbase", help="make the alternate rendition the base")
    sb.add_argument("input")
    sb.add_argument("output")
    sb.add_argument("-q", "--qcolor", type=int, default=60)
    sb.set_defaults(fn=cmd_swapbase)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
