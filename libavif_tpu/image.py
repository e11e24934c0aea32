"""Image model: the ``avifImage`` / ``avifRGBImage`` equivalents.

Host-side representation uses NumPy arrays (one per plane). Device compute
(pixel pipeline, codec) converts to/from ``jax.Array`` at well-defined
boundaries so host<->device transfers stay explicit and minimal.

Reference semantics:
  - avifImage struct            include/avif/avif.h:777-851
  - avifRGBImage struct         include/avif/avif.h:996-1016
  - plane allocation            src/avif.c:431-491 (chroma ceil-shift math)
  - zero-copy crop views        src/avif.c:325-423 (avifImageSetViewRect)
  - CLAP <-> crop rect          src/avif.c:783-1019
  - grid dimension rules        src/avif.c:1034-1080 (MIAF 7.3.11.4.2)
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional

import numpy as np

from .constants import (
    AvifError,
    ChromaSamplePosition,
    ColorPrimaries,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
    RGBFormat,
    ChromaUpsampling,
    ChromaDownsampling,
    TransferCharacteristics,
    TransformFlags,
    pixel_format_info,
    rgb_format_channel_count,
    rgb_format_has_alpha,
)


def _ceil_shift(value: int, shift: int) -> int:
    """Ceil-division by 2**shift (reference: avif.c:459-477 shift math)."""
    return (value + (1 << shift) - 1) >> shift


@dataclasses.dataclass
class PixelAspectRatioBox:
    """'pasp' property (reference: avif.h:445-452)."""

    h_spacing: int = 1
    v_spacing: int = 1


@dataclasses.dataclass
class CleanApertureBox:
    """'clap' property, stored as unsigned fractions (reference: avif.h:455-474)."""

    width_n: int = 0
    width_d: int = 1
    height_n: int = 0
    height_d: int = 1
    horiz_off_n: int = 0
    horiz_off_d: int = 1
    vert_off_n: int = 0
    vert_off_d: int = 1


@dataclasses.dataclass
class ImageRotation:
    """'irot' property: angle * 90 degrees anti-clockwise (reference: avif.h:477-484)."""

    angle: int = 0  # 0-3


@dataclasses.dataclass
class ImageMirror:
    """'imir' property: axis=0 top-to-bottom, 1 left-to-right (reference: avif.h:487-515)."""

    axis: int = 0


@dataclasses.dataclass
class ContentLightLevelInformationBox:
    """'clli' property (reference: avif.h:529-535)."""

    max_cll: int = 0
    max_pall: int = 0


@dataclasses.dataclass
class CropRect:
    """Pixel-space crop rectangle (reference: avif.h:741-747)."""

    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0


@dataclasses.dataclass
class GainMapMetadata:
    """ISO 21496-1 gain map metadata, stored as fractions.

    Reference: avifGainMap struct (avif.h:630-712).
    """

    gain_map_min: list = dataclasses.field(default_factory=lambda: [Fraction(0)] * 3)
    gain_map_max: list = dataclasses.field(default_factory=lambda: [Fraction(0)] * 3)
    gain_map_gamma: list = dataclasses.field(default_factory=lambda: [Fraction(1)] * 3)
    base_offset: list = dataclasses.field(default_factory=lambda: [Fraction(1, 64)] * 3)
    alternate_offset: list = dataclasses.field(
        default_factory=lambda: [Fraction(1, 64)] * 3
    )
    base_hdr_headroom: Fraction = Fraction(0)
    alternate_hdr_headroom: Fraction = Fraction(1)
    use_base_color_space: bool = True


class GainMap:
    """A gain map: an image plus its tone-mapping metadata (avif.h:630-712)."""

    def __init__(self):
        self.image: Optional[Image] = None
        self.metadata = GainMapMetadata()
        # CICP of the alternate (fully tone-mapped) rendition.
        self.alt_icc: bytes = b""
        self.alt_color_primaries = ColorPrimaries.UNSPECIFIED
        self.alt_transfer_characteristics = TransferCharacteristics.UNSPECIFIED
        self.alt_matrix_coefficients = MatrixCoefficients.UNSPECIFIED
        self.alt_yuv_range = Range.FULL
        self.alt_depth = 0
        self.alt_plane_count = 0
        self.alt_clli = ContentLightLevelInformationBox()


class Image:
    """YUV(A) image with metadata — the ``avifImage`` equivalent (avif.h:777-851)."""

    def __init__(
        self,
        width: int = 0,
        height: int = 0,
        depth: int = 8,
        yuv_format: PixelFormat = PixelFormat.NONE,
    ):
        self.width = width
        self.height = height
        self.depth = depth  # 8, 10, 12 (16 via sample transform)
        self.yuv_format = PixelFormat(yuv_format)
        self.yuv_range = Range.FULL
        self.chroma_sample_position = ChromaSamplePosition.UNKNOWN

        # Planes: numpy arrays of shape (h, w), dtype uint8 (depth 8) or
        # uint16 (depth > 8). None when absent. May be views (crops).
        self.yuv_planes: list[Optional[np.ndarray]] = [None, None, None]
        self.alpha_plane: Optional[np.ndarray] = None
        self.alpha_premultiplied = False
        # True when planes are views into another image's buffers.
        self.image_owns_yuv_planes = True
        self.image_owns_alpha_plane = True

        # CICP
        self.color_primaries = ColorPrimaries.UNSPECIFIED
        self.transfer_characteristics = TransferCharacteristics.UNSPECIFIED
        self.matrix_coefficients = MatrixCoefficients.UNSPECIFIED
        self.icc: bytes = b""

        self.clli = ContentLightLevelInformationBox()
        self.transform_flags = TransformFlags.NONE
        self.pasp = PixelAspectRatioBox()
        self.clap = CleanApertureBox()
        self.irot = ImageRotation()
        self.imir = ImageMirror()

        self.exif: bytes = b""
        self.xmp: bytes = b""
        self.gain_map: Optional[GainMap] = None
        # Opaque/unrecognized item properties to carry through (avif.h:846-851).
        self.properties: list = []

    # ---------------------------------------------------------------- dtype

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(np.uint8 if self.depth == 8 else np.uint16)

    @property
    def max_value(self) -> int:
        return (1 << self.depth) - 1

    @property
    def monochrome(self) -> bool:
        return self.yuv_format == PixelFormat.YUV400

    @property
    def has_alpha(self) -> bool:
        return self.alpha_plane is not None

    # ------------------------------------------------------------ geometry

    def plane_dims(self, channel: int) -> tuple[int, int]:
        """(width, height) of plane ``channel`` (0=Y/alpha, 1=U, 2=V).

        Chroma dims use ceil-shift (reference: avif.c:459-477).
        """
        if channel == 0:
            return self.width, self.height
        info = pixel_format_info(self.yuv_format)
        if info.monochrome:
            return 0, 0
        return (
            _ceil_shift(self.width, info.chroma_shift_x),
            _ceil_shift(self.height, info.chroma_shift_y),
        )

    # ---------------------------------------------------------- allocation

    def allocate_planes(self, planes: str = "yuv") -> None:
        """Allocate pixel planes (reference: avifImageAllocatePlanes, avif.c:431).

        ``planes``: "yuv", "a", or "all".
        """
        if self.width <= 0 or self.height <= 0:
            raise AvifError(Result.INVALID_ARGUMENT, "zero-size image")
        if planes in ("yuv", "all"):
            if self.yuv_format == PixelFormat.NONE:
                raise AvifError(Result.INVALID_ARGUMENT, "no YUV format selected")
            n_planes = 1 if self.monochrome else 3
            for c in range(n_planes):
                w, h = self.plane_dims(c)
                if self.yuv_planes[c] is None:
                    self.yuv_planes[c] = np.zeros((h, w), dtype=self.dtype)
            self.image_owns_yuv_planes = True
        if planes in ("a", "all"):
            if self.alpha_plane is None:
                self.alpha_plane = np.zeros((self.height, self.width), dtype=self.dtype)
            self.image_owns_alpha_plane = True

    def free_planes(self, planes: str = "all") -> None:
        if planes in ("yuv", "all"):
            self.yuv_planes = [None, None, None]
        if planes in ("a", "all"):
            self.alpha_plane = None

    # ----------------------------------------------------------- copy/view

    def copy(self, planes: str = "all") -> "Image":
        """Deep copy (reference: avifImageCopy, avif.c:251)."""
        out = Image(self.width, self.height, self.depth, self.yuv_format)
        out.copy_no_pixels(self)
        if planes in ("yuv", "all"):
            out.yuv_planes = [
                None if p is None else np.array(p, copy=True) for p in self.yuv_planes
            ]
        if planes in ("a", "all"):
            out.alpha_plane = (
                None if self.alpha_plane is None else np.array(self.alpha_plane, copy=True)
            )
        return out

    def copy_no_pixels(self, src: "Image") -> None:
        """Copy metadata only (reference: avifImageCopyNoPixels semantics)."""
        self.width = src.width
        self.height = src.height
        self.depth = src.depth
        self.yuv_format = src.yuv_format
        self.yuv_range = src.yuv_range
        self.chroma_sample_position = src.chroma_sample_position
        self.alpha_premultiplied = src.alpha_premultiplied
        self.color_primaries = src.color_primaries
        self.transfer_characteristics = src.transfer_characteristics
        self.matrix_coefficients = src.matrix_coefficients
        self.icc = src.icc
        self.clli = dataclasses.replace(src.clli)
        self.transform_flags = src.transform_flags
        self.pasp = dataclasses.replace(src.pasp)
        self.clap = dataclasses.replace(src.clap)
        self.irot = dataclasses.replace(src.irot)
        self.imir = dataclasses.replace(src.imir)
        self.exif = src.exif
        self.xmp = src.xmp
        self.properties = list(src.properties)
        self.gain_map = src.gain_map

    def view_rect(self, rect: CropRect) -> "Image":
        """Zero-copy crop view (reference: avifImageSetViewRect, avif.c:325).

        The rect origin must be even-aligned w.r.t. chroma subsampling.
        """
        info = pixel_format_info(self.yuv_format)
        if (
            rect.width > self.width
            or rect.height > self.height
            or rect.x > self.width - rect.width
            or rect.y > self.height - rect.height
            or (rect.x & ((1 << info.chroma_shift_x) - 1))
            or (rect.y & ((1 << info.chroma_shift_y) - 1))
        ):
            raise AvifError(Result.INVALID_ARGUMENT, "bad view rect")
        view = Image(rect.width, rect.height, self.depth, self.yuv_format)
        view.copy_no_pixels(self)
        view.width = rect.width
        view.height = rect.height
        for c in range(3):
            p = self.yuv_planes[c]
            if p is None:
                continue
            if c == 0:
                view.yuv_planes[c] = p[rect.y : rect.y + rect.height, rect.x : rect.x + rect.width]
            else:
                cx = rect.x >> info.chroma_shift_x
                cy = rect.y >> info.chroma_shift_y
                cw = _ceil_shift(rect.width, info.chroma_shift_x)
                ch = _ceil_shift(rect.height, info.chroma_shift_y)
                view.yuv_planes[c] = p[cy : cy + ch, cx : cx + cw]
        if self.alpha_plane is not None:
            view.alpha_plane = self.alpha_plane[
                rect.y : rect.y + rect.height, rect.x : rect.x + rect.width
            ]
        view.image_owns_yuv_planes = False
        view.image_owns_alpha_plane = False
        return view

    def steal_planes(self, src: "Image", planes: str = "all") -> None:
        """Move plane ownership from src (reference: avifImageStealPlanes, avif.c:518)."""
        if planes in ("yuv", "all"):
            self.yuv_planes = src.yuv_planes
            src.yuv_planes = [None, None, None]
            self.yuv_format = src.yuv_format
            self.yuv_range = src.yuv_range
        if planes in ("a", "all"):
            self.alpha_plane = src.alpha_plane
            src.alpha_plane = None
        self.width = src.width
        self.height = src.height
        self.depth = src.depth

    def is_opaque(self) -> bool:
        """Reference: avifImageIsOpaque (avif.c:558)."""
        if self.alpha_plane is None:
            return True
        return bool(np.all(self.alpha_plane == self.max_value))


class RGBImage:
    """Interleaved RGB image — ``avifRGBImage`` equivalent (avif.h:996-1016)."""

    def __init__(
        self,
        width: int = 0,
        height: int = 0,
        depth: int = 8,
        fmt: RGBFormat = RGBFormat.RGBA,
    ):
        self.width = width
        self.height = height
        self.depth = depth
        self.format = RGBFormat(fmt)
        self.chroma_upsampling = ChromaUpsampling.AUTOMATIC
        self.chroma_downsampling = ChromaDownsampling.AUTOMATIC
        self.avoid_libyuv = False  # kept for API parity; no-op here
        self.ignore_alpha = False
        self.alpha_premultiplied = False
        self.is_float = False  # depth must be 16 when set (half floats)
        self.max_threads = 1  # API parity; device handles parallelism
        self.pixels: Optional[np.ndarray] = None  # (h, w, channels)

    @classmethod
    def from_image(cls, image: Image, depth: Optional[int] = None) -> "RGBImage":
        """Reference: avifRGBImageSetDefaults (avif.h:1020)."""
        rgb = cls(image.width, image.height, depth or image.depth, RGBFormat.RGBA)
        return rgb

    @property
    def channel_count(self) -> int:
        return rgb_format_channel_count(self.format)

    @property
    def has_alpha(self) -> bool:
        return rgb_format_has_alpha(self.format)

    @property
    def dtype(self) -> np.dtype:
        if self.is_float:
            return np.dtype(np.float16)
        return np.dtype(np.uint8 if self.depth == 8 else np.uint16)

    @property
    def max_value(self) -> int:
        return (1 << self.depth) - 1

    def allocate_pixels(self) -> None:
        self.pixels = np.zeros((self.height, self.width, self.channel_count), dtype=self.dtype)


# --------------------------------------------------------------------- CLAP

def _fraction_is_valid(n: int, d: int) -> bool:
    return d != 0


def crop_rect_from_clap(
    clap: CleanApertureBox, image_w: int, image_h: int, yuv_format: PixelFormat
) -> CropRect:
    """Convert 'clap' to a pixel crop rect, validating per spec.

    Reference: avifCropRectFromCleanApertureBox (avif.c:847-930).
    CLAP fractions are stored unsigned but offsets are signed.
    """

    def _signed(v: int) -> int:
        return v - (1 << 32) if v >= (1 << 31) else v

    if clap.width_d == 0 or clap.height_d == 0 or clap.horiz_off_d == 0 or clap.vert_off_d == 0:
        raise AvifError(Result.INVALID_ARGUMENT, "clap zero denominator")
    cw = Fraction(clap.width_n, clap.width_d)
    ch = Fraction(clap.height_n, clap.height_d)
    ho = Fraction(_signed(clap.horiz_off_n), clap.horiz_off_d)
    vo = Fraction(_signed(clap.vert_off_n), clap.vert_off_d)
    if cw <= 0 or ch <= 0:
        raise AvifError(Result.INVALID_ARGUMENT, "clap non-positive size")
    if cw.denominator != 1 or ch.denominator != 1:
        raise AvifError(Result.INVALID_ARGUMENT, "clap non-integer size")
    # cropX = horizOff + (W - clapW)/2 ; cropY = vertOff + (H - clapH)/2
    crop_x = ho + Fraction(image_w - int(cw), 2)
    crop_y = vo + Fraction(image_h - int(ch), 2)
    if crop_x.denominator != 1 or crop_y.denominator != 1:
        raise AvifError(Result.INVALID_ARGUMENT, "clap non-integer origin")
    rect = CropRect(int(crop_x), int(crop_y), int(cw), int(ch))
    if (
        rect.x < 0
        or rect.y < 0
        or rect.x + rect.width > image_w
        or rect.y + rect.height > image_h
    ):
        raise AvifError(Result.INVALID_ARGUMENT, "clap rect out of bounds")
    _require_even_alignment(rect, yuv_format)
    return rect


def clap_from_crop_rect(
    rect: CropRect, image_w: int, image_h: int, yuv_format: PixelFormat
) -> CleanApertureBox:
    """Reference: avifCleanApertureBoxFromCropRect (avif.c:932-1019)."""
    if (
        rect.width <= 0
        or rect.height <= 0
        or rect.x < 0
        or rect.y < 0
        or rect.x + rect.width > image_w
        or rect.y + rect.height > image_h
    ):
        raise AvifError(Result.INVALID_ARGUMENT, "bad crop rect")
    _require_even_alignment(rect, yuv_format)
    # horizOff = cropX - (W - clapW)/2, as a fraction over 2.
    ho = Fraction(2 * rect.x - (image_w - rect.width), 2)
    vo = Fraction(2 * rect.y - (image_h - rect.height), 2)

    def _unsigned(v: int) -> int:
        return v + (1 << 32) if v < 0 else v

    return CleanApertureBox(
        width_n=rect.width,
        width_d=1,
        height_n=rect.height,
        height_d=1,
        horiz_off_n=_unsigned(ho.numerator),
        horiz_off_d=ho.denominator,
        vert_off_n=_unsigned(vo.numerator),
        vert_off_d=vo.denominator,
    )


def _require_even_alignment(rect: CropRect, yuv_format: PixelFormat) -> None:
    """4:2:0/4:2:2 require even origin/dims on subsampled axes (avif.c:783-845)."""
    info = pixel_format_info(yuv_format)
    if info.chroma_shift_x and ((rect.x & 1) or (rect.width & 1)):
        raise AvifError(Result.INVALID_ARGUMENT, "clap x/width must be even")
    if info.chroma_shift_y and ((rect.y & 1) or (rect.height & 1)):
        raise AvifError(Result.INVALID_ARGUMENT, "clap y/height must be even")


# --------------------------------------------------------------------- grid

def are_grid_dimensions_valid(
    yuv_format: PixelFormat,
    image_w: int,
    image_h: int,
    tile_w: int,
    tile_h: int,
) -> bool:
    """MIAF grid rules (reference: avifAreGridDimensionsValid, avif.c:1034-1080).

    - Tiles must all be the same size (implied by single tile_w/tile_h here).
    - The tiled area covers the image; rightmost/bottom cells are cropped.
    - MIAF: each cell >= 64x64; cropped dims follow chroma evenness rules.
    """
    if tile_w < 64 or tile_h < 64:
        return False
    info = pixel_format_info(yuv_format)
    if info.chroma_shift_x and ((image_w & 1) or (tile_w & 1)):
        return False
    if info.chroma_shift_y and ((image_h & 1) or (tile_h & 1)):
        return False
    return True
