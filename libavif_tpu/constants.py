"""Core enums and constants for the JAX-native AVIF engine.

Mirrors the semantic surface of the reference public header
(``include/avif/avif.h``): result codes (avif.h:164-204), pixel formats
(avif.h:279-289), CICP enums (avif.h:335-414), range flags, chroma sample
position, transform flags, and default safety limits (avif.h:95-101).

The *semantics* follow the reference; the implementation is original and
host-side Python (these are plain data definitions, no compute).
"""

from __future__ import annotations

import enum

VERSION_MAJOR = 0
VERSION_MINOR = 1
VERSION_PATCH = 0
VERSION = f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_PATCH}"

# Safety limits (reference: avif.h:95-101)
DEFAULT_IMAGE_SIZE_LIMIT = 16384 * 16384
DEFAULT_IMAGE_DIMENSION_LIMIT = 32768
DEFAULT_IMAGE_COUNT_LIMIT = 12 * 3600 * 60  # 2,592,000 frames

MAX_AV1_LAYER_COUNT = 4

# Encoder knobs (reference: avif.h:108-116, 1549-1562)
QUALITY_DEFAULT = -1
QUALITY_LOSSLESS = 100
QUALITY_WORST = 0
QUALITY_BEST = 100
QUANTIZER_LOSSLESS = 0
QUANTIZER_BEST_QUALITY = 0
QUANTIZER_WORST_QUALITY = 63
SPEED_DEFAULT = -1
SPEED_SLOWEST = 0
SPEED_FASTEST = 10

REPETITION_COUNT_INFINITE = -1
REPETITION_COUNT_UNKNOWN = -2


class Result(enum.IntEnum):
    """Result codes (reference: avif.h:164-204, 35 codes)."""

    OK = 0
    UNKNOWN_ERROR = 1
    INVALID_FTYP = 2
    NO_CONTENT = 3
    NO_YUV_FORMAT_SELECTED = 4
    REFORMAT_FAILED = 5
    UNSUPPORTED_DEPTH = 6
    ENCODE_COLOR_FAILED = 7
    ENCODE_ALPHA_FAILED = 8
    BMFF_PARSE_FAILED = 9
    MISSING_IMAGE_ITEM = 10
    DECODE_COLOR_FAILED = 11
    DECODE_ALPHA_FAILED = 12
    COLOR_ALPHA_SIZE_MISMATCH = 13
    ISPE_SIZE_MISMATCH = 14
    NO_CODEC_AVAILABLE = 15
    NO_IMAGES_REMAINING = 16
    INVALID_EXIF_PAYLOAD = 17
    INVALID_IMAGE_GRID = 18
    INVALID_CODEC_SPECIFIC_OPTION = 19
    TRUNCATED_DATA = 20
    IO_NOT_SET = 21
    IO_ERROR = 22
    WAITING_ON_IO = 23
    INVALID_ARGUMENT = 24
    NOT_IMPLEMENTED = 25
    OUT_OF_MEMORY = 26
    CANNOT_CHANGE_SETTING = 27
    INCOMPATIBLE_IMAGE = 28
    ENCODE_GAIN_MAP_FAILED = 29
    DECODE_GAIN_MAP_FAILED = 30
    INVALID_TONE_MAPPED_IMAGE = 31
    INVALID_SAMPLE_TRANSFORM = 32
    NO_IMAGE_AVAILABLE = 33
    MISSING_DATA = 34


_RESULT_STRINGS = {
    Result.OK: "OK",
    Result.UNKNOWN_ERROR: "Unknown Error",
    Result.INVALID_FTYP: "Invalid ftyp",
    Result.NO_CONTENT: "No content",
    Result.NO_YUV_FORMAT_SELECTED: "No YUV format selected",
    Result.REFORMAT_FAILED: "Reformat failed",
    Result.UNSUPPORTED_DEPTH: "Unsupported depth",
    Result.ENCODE_COLOR_FAILED: "Encoding of color planes failed",
    Result.ENCODE_ALPHA_FAILED: "Encoding of alpha plane failed",
    Result.BMFF_PARSE_FAILED: "BMFF parsing failed",
    Result.MISSING_IMAGE_ITEM: "Missing or empty image item",
    Result.DECODE_COLOR_FAILED: "Decoding of color planes failed",
    Result.DECODE_ALPHA_FAILED: "Decoding of alpha plane failed",
    Result.COLOR_ALPHA_SIZE_MISMATCH: "Color and alpha planes size mismatch",
    Result.ISPE_SIZE_MISMATCH: "Plane sizes don't match ispe values",
    Result.NO_CODEC_AVAILABLE: "No codec available",
    Result.NO_IMAGES_REMAINING: "No images remaining",
    Result.INVALID_EXIF_PAYLOAD: "Invalid Exif payload",
    Result.INVALID_IMAGE_GRID: "Invalid image grid",
    Result.INVALID_CODEC_SPECIFIC_OPTION: "Invalid codec-specific option",
    Result.TRUNCATED_DATA: "Truncated data",
    Result.IO_NOT_SET: "IO not set",
    Result.IO_ERROR: "IO Error",
    Result.WAITING_ON_IO: "Waiting on IO",
    Result.INVALID_ARGUMENT: "Invalid argument",
    Result.NOT_IMPLEMENTED: "Not implemented",
    Result.OUT_OF_MEMORY: "Out of memory",
    Result.CANNOT_CHANGE_SETTING: "Cannot change some setting during encoding",
    Result.INCOMPATIBLE_IMAGE: "The image is incompatible with already encoded images",
    Result.ENCODE_GAIN_MAP_FAILED: "Encoding of gain map planes failed",
    Result.DECODE_GAIN_MAP_FAILED: "Decoding of gain map planes failed",
    Result.INVALID_TONE_MAPPED_IMAGE: "Invalid tone mapped image item",
    Result.INVALID_SAMPLE_TRANSFORM: "Invalid sample transform",
    Result.NO_IMAGE_AVAILABLE: "No image available",
    Result.MISSING_DATA: "Missing data",
}


def result_to_string(result: Result) -> str:
    """Reference: avifResultToString (src/avif.c:74)."""
    return _RESULT_STRINGS.get(Result(result), "Unknown Error")


class AvifError(Exception):
    """Raised by APIs that prefer exceptions over Result codes."""

    def __init__(self, result: Result, detail: str = ""):
        self.result = Result(result)
        self.detail = detail
        msg = result_to_string(self.result)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


class PixelFormat(enum.IntEnum):
    """YUV pixel formats (reference: avif.h:279-289)."""

    NONE = 0
    YUV444 = 1
    YUV422 = 2
    YUV420 = 3
    YUV400 = 4
    COUNT = 5


class PixelFormatInfo:
    """Chroma subsampling geometry (reference: avifGetPixelFormatInfo, src/avif.c:39)."""

    __slots__ = ("monochrome", "chroma_shift_x", "chroma_shift_y")

    def __init__(self, monochrome: bool, sx: int, sy: int):
        self.monochrome = monochrome
        self.chroma_shift_x = sx
        self.chroma_shift_y = sy


_FORMAT_INFO = {
    PixelFormat.YUV444: PixelFormatInfo(False, 0, 0),
    PixelFormat.YUV422: PixelFormatInfo(False, 1, 0),
    PixelFormat.YUV420: PixelFormatInfo(False, 1, 1),
    PixelFormat.YUV400: PixelFormatInfo(True, 1, 1),
    PixelFormat.NONE: PixelFormatInfo(False, 0, 0),
}


def pixel_format_info(fmt: PixelFormat) -> PixelFormatInfo:
    return _FORMAT_INFO[PixelFormat(fmt)]


def pixel_format_to_string(fmt: PixelFormat) -> str:
    return {
        PixelFormat.NONE: "Unknown",
        PixelFormat.YUV444: "YUV444",
        PixelFormat.YUV422: "YUV422",
        PixelFormat.YUV420: "YUV420",
        PixelFormat.YUV400: "YUV400",
    }.get(PixelFormat(fmt), "Unknown")


class ChromaSamplePosition(enum.IntEnum):
    """Reference: avif.h:292-300 (maps to AV1 chroma_sample_position)."""

    UNKNOWN = 0
    VERTICAL = 1
    COLOCATED = 2
    RESERVED = 3


class ChromaUpsampling(enum.IntEnum):
    """Reference: avif.h:948-956."""

    AUTOMATIC = 0
    FASTEST = 1
    BEST_QUALITY = 2
    NEAREST = 3
    BILINEAR = 4


class ChromaDownsampling(enum.IntEnum):
    """Reference: avif.h:958-966."""

    AUTOMATIC = 0
    FASTEST = 1
    BEST_QUALITY = 2
    AVERAGE = 3
    SHARP_YUV = 4


class Range(enum.IntEnum):
    """Limited (studio) vs full range (reference: avif.h:303-312)."""

    LIMITED = 0
    FULL = 1


class ColorPrimaries(enum.IntEnum):
    """CICP CP values (reference: avif.h:335-355; ISO/IEC 23091-2)."""

    UNKNOWN = 0
    BT709 = 1
    SRGB = 1
    UNSPECIFIED = 2
    BT470M = 4
    BT470BG = 5
    BT601 = 6
    SMPTE240 = 7
    GENERIC_FILM = 8
    BT2020 = 9
    BT2100 = 9
    XYZ = 10
    SMPTE431 = 11
    SMPTE432 = 12  # DCI P3
    EBU3213 = 22


class TransferCharacteristics(enum.IntEnum):
    """CICP TC values (reference: avif.h:361-383)."""

    UNKNOWN = 0
    BT709 = 1
    UNSPECIFIED = 2
    BT470M = 4  # 2.2 gamma
    BT470BG = 5  # 2.8 gamma
    BT601 = 6
    SMPTE240 = 7
    LINEAR = 8
    LOG100 = 9
    LOG100_SQRT10 = 10
    IEC61966 = 11
    BT1361 = 12
    SRGB = 13
    BT2020_10BIT = 14
    BT2020_12BIT = 15
    PQ = 16  # SMPTE 2084
    SMPTE2084 = 16
    SMPTE428 = 17
    HLG = 18


class MatrixCoefficients(enum.IntEnum):
    """CICP MC values (reference: avif.h:389-407)."""

    IDENTITY = 0
    BT709 = 1
    UNSPECIFIED = 2
    FCC = 4
    BT470BG = 5
    BT601 = 6
    SMPTE240 = 7
    YCGCO = 8
    BT2020_NCL = 9
    BT2020_CL = 10
    SMPTE2085 = 11
    CHROMA_DERIVED_NCL = 12
    CHROMA_DERIVED_CL = 13
    ICTCP = 14
    YCGCO_RE = 16
    YCGCO_RO = 17
    LAST = 18


class TransformFlags(enum.IntFlag):
    """Which transformative properties are present (reference: avif.h:518-526)."""

    NONE = 0
    PASP = 1 << 0
    CLAP = 1 << 1
    IROT = 1 << 2
    IMIR = 1 << 3


class RGBFormat(enum.IntEnum):
    """Interleaved RGB layouts (reference: avif.h:864-882)."""

    RGB = 0
    RGBA = 1
    ARGB = 2
    BGR = 3
    BGRA = 4
    ABGR = 5
    RGB_565 = 6
    GRAY = 7
    GRAYA = 8
    AGRAY = 9


def rgb_format_channel_count(fmt: RGBFormat) -> int:
    fmt = RGBFormat(fmt)
    if fmt in (RGBFormat.RGB, RGBFormat.BGR, RGBFormat.RGB_565):
        return 3
    if fmt == RGBFormat.GRAY:
        return 1
    if fmt in (RGBFormat.GRAYA, RGBFormat.AGRAY):
        return 2
    return 4


def rgb_format_has_alpha(fmt: RGBFormat) -> bool:
    return RGBFormat(fmt) in (
        RGBFormat.RGBA,
        RGBFormat.ARGB,
        RGBFormat.BGRA,
        RGBFormat.ABGR,
        RGBFormat.GRAYA,
        RGBFormat.AGRAY,
    )


class AlphaPremultiplied(enum.IntEnum):
    NO = 0
    YES = 1


class StrictFlags(enum.IntFlag):
    """Decoder strictness (reference: avif.h:1139-1166)."""

    DISABLED = 0
    PIXI_REQUIRED = 1 << 0
    CLAP_VALID = 1 << 1
    ALPHA_ISPE_REQUIRED = 1 << 2
    ALL = PIXI_REQUIRED | CLAP_VALID | ALPHA_ISPE_REQUIRED


class DecoderSource(enum.IntEnum):
    """Reference: avifDecoderSource (avif.h:1210-1229)."""

    AUTO = 0
    PRIMARY_ITEM = 1
    TRACKS = 2


class ProgressiveState(enum.IntEnum):
    """Reference: avif.h:1231-1247."""

    UNAVAILABLE = 0
    AVAILABLE = 1
    ACTIVE = 2


class ItemCategory(enum.IntEnum):
    """Decode categories (reference: internal.h:413-425)."""

    COLOR = 0
    ALPHA = 1
    GAIN_MAP = 2


class HeaderFormat(enum.IntEnum):
    """Full ISOBMFF vs the condensed 'mini' box (reference: avif.h:1389-1401)."""

    FULL = 0
    MINI = 1


class SampleTransformRecipe(enum.IntEnum):
    """Bit-depth extension recipes (reference: avif.h:1404-1433)."""

    NONE = 0
    BIT_DEPTH_EXTENSION_8B_8B = 1
    BIT_DEPTH_EXTENSION_12B_4B = 2
    BIT_DEPTH_EXTENSION_12B_8B = 3


ADD_IMAGE_FLAG_NONE = 0
ADD_IMAGE_FLAG_FORCE_KEYFRAME = 1 << 0
ADD_IMAGE_FLAG_SINGLE = 1 << 1
