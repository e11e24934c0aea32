"""avifdec-equivalent CLI (reference: apps/avifdec.c, 504 LoC).

Decode AVIF to PNG/JPEG/y4m; `--info` dumps the container structure
(reference: avifContainerDump, apps/shared/avifutil.c:202).
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def build_parser() -> argparse.ArgumentParser:
    from ..constants import VERSION

    p = argparse.ArgumentParser(
        prog="avifdec", description="Decode AVIF files (JAX-native codec)"
    )
    p.add_argument("-V", "--version", action="version", version=f"avifdec (libavif_tpu) {VERSION}")
    p.add_argument("input", help="input.avif")
    p.add_argument("output", nargs="?", help="output: png/jpg/y4m (omit with --info)")
    p.add_argument("--index", default="0", help="frame index, or 'all'")
    p.add_argument("-q", "--quality", type=int, default=90, help="JPEG quality")
    p.add_argument("--png-depth", type=int, choices=(8, 16), help="PNG bit depth")
    p.add_argument("--no-strict", action="store_true", help="disable strict checks")
    p.add_argument("-i", "--info", action="store_true", help="print file info and exit")
    p.add_argument(
        "--size-limit", type=int, default=None, help="max pixel count to allow"
    )
    return p


def _print_info(d, data, out=None):
    from ..constants import PixelFormat

    out = out or sys.stdout

    print(f" * File size     : {len(data)} bytes", file=out)
    print(f" * Image count   : {d.image_count}", file=out)
    img = d.image
    print(f" * Resolution    : {img.width}x{img.height}", file=out)
    print(f" * Bit depth     : {img.depth}", file=out)
    print(f" * Format        : {PixelFormat(img.yuv_format).name}", file=out)
    print(f" * Alpha         : {'present' if d.alpha_present else 'absent'}", file=out)
    print(f" * Range         : {img.yuv_range.name}", file=out)
    print(
        f" * CICP          : {int(img.color_primaries)}/"
        f"{int(img.transfer_characteristics)}/{int(img.matrix_coefficients)}",
        file=out,
    )
    if d.image_count > 1:
        print(f" * Timescale     : {d.timescale}", file=out)
        print(f" * Duration      : {d.duration_in_timescales}", file=out)
    if img.icc:
        print(f" * ICC           : {len(img.icc)} bytes", file=out)
    if img.exif:
        print(f" * Exif          : {len(img.exif)} bytes", file=out)
    if img.xmp:
        print(f" * XMP           : {len(img.xmp)} bytes", file=out)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..api.decoder import Decoder
    from ..constants import StrictFlags
    from ..io_formats.png_jpeg import write_jpeg, write_png
    from ..io_formats.y4m import write_y4m

    data = pathlib.Path(args.input).read_bytes()
    d = Decoder()
    if args.no_strict:
        d.strict_flags = StrictFlags.DISABLED
    if args.size_limit is not None:
        d.image_size_limit = args.size_limit
    d.parse(data)

    if args.info:
        if not d.next_image():
            print("no images", file=sys.stderr)
            return 1
        _print_info(d, data)
        return 0

    if not args.output:
        print("output path required (or use --info)", file=sys.stderr)
        return 1
    suffix = pathlib.Path(args.output).suffix.lower()

    if args.index == "all" or suffix == ".y4m":
        frames = []
        if args.index == "all":
            while d.next_image():
                frames.append(d.image.copy())
        else:
            frames.append(d.nth_image(int(args.index)))
        if suffix != ".y4m":
            print("--index all requires a .y4m output", file=sys.stderr)
            return 1
        fps = (d.timescale, 1) if d.image_count > 1 else (30, 1)
        write_y4m(args.output, frames, fps=fps)
    else:
        img = d.nth_image(int(args.index))
        if suffix in (".jpg", ".jpeg"):
            write_jpeg(args.output, img, quality=args.quality)
        elif suffix == ".png":
            write_png(args.output, img, depth=args.png_depth)
        else:
            print(f"unsupported output type {suffix}", file=sys.stderr)
            return 1
    print(f"Wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
