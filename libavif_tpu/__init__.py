"""libavif_tpu — a JAX-native AVIF engine (JAX/XLA + C++ host walks).

A from-scratch reimplementation of the capabilities of AOMediaCodec/libavif:

  - ISOBMFF/HEIF/MIAF container read/write on the host (pure Python + C++).
  - A spec-conformant AV1 codec whose encoder runs its RD pre-pass as one
    batched device program per frame shape, and an own-format intra codec
    (integer DCT/ADST transforms, quantization, wavefront reconstruction)
    that runs entirely as batched JAX programs on the device.
  - The full YUV<->RGB/alpha/gain-map pixel pipeline vectorized on device.
  - Grid cells and animation frames sharded over a `jax.sharding.Mesh`.

Public API mirrors the reference's surface: Image/RGBImage, Decoder/Encoder,
result codes, and the pixel-conversion entry points.
"""

from .constants import (
    VERSION,
    AvifError,
    ChromaSamplePosition,
    ChromaDownsampling,
    ChromaUpsampling,
    ColorPrimaries,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
    RGBFormat,
    StrictFlags,
    TransferCharacteristics,
    TransformFlags,
    result_to_string,
)
from .image import (
    CleanApertureBox,
    CropRect,
    GainMap,
    GainMapMetadata,
    Image,
    ImageMirror,
    ImageRotation,
    PixelAspectRatioBox,
    RGBImage,
    clap_from_crop_rect,
    crop_rect_from_clap,
)

__version__ = VERSION

__all__ = [
    "VERSION",
    "AvifError",
    "ChromaSamplePosition",
    "ChromaDownsampling",
    "ChromaUpsampling",
    "ColorPrimaries",
    "MatrixCoefficients",
    "PixelFormat",
    "Range",
    "Result",
    "RGBFormat",
    "StrictFlags",
    "TransferCharacteristics",
    "TransformFlags",
    "result_to_string",
    "CleanApertureBox",
    "CropRect",
    "GainMap",
    "GainMapMetadata",
    "Image",
    "ImageMirror",
    "ImageRotation",
    "PixelAspectRatioBox",
    "RGBImage",
    "clap_from_crop_rect",
    "crop_rect_from_clap",
]
