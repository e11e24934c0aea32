"""Encoder aggregate — the ``avifEncoder`` equivalent (avif.h:1511-1625).

Builds the item graph (color + alpha aux + Exif/XMP), drives the native
codec per item, and serializes the container. Reference call stack:
avifEncoderAddImage (write.c:2141) → avifEncoderAddImageInternal
(write.c:1702) → per-item codec encode (write.c:2035-2132) →
avifEncoderFinish (write.c:3152).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..codec import FrameParams, encode_frame
from ..codec.frame import config_from_sequence_header
from ..constants import (
    AvifError,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
    TransformFlags,
)
from ..containers.items import (
    ColorInformation,
    ImageSpatialExtents,
    PixelInformation,
    Property,
)
from ..containers.write import OutputItem, write_sequence, write_still
from ..image import Image

ALPHA_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"

# avifAddImageFlags (avif.h:1630-1640)
ADD_IMAGE_FLAG_NONE = 0
ADD_IMAGE_FLAG_FORCE_KEYFRAME = 1 << 0
ADD_IMAGE_FLAG_SINGLE = 1 << 1


@dataclasses.dataclass
class _PendingFrame:
    image: Image  # deep copy; encoded in one pipelined batch at finish()
    duration: int
    keyframe: bool
    obus: Optional[bytes] = None
    alpha_obus: Optional[bytes] = None
    # settings snapshot taken at add_image time (reference semantics:
    # avifEncoderAddImage reads the encoder's CURRENT settings, so
    # callers may retune quality etc. between frames — avifenc `:u`)
    params: object = None
    params_alpha: object = None


class Encoder:
    """Still & animated AVIF encoder.

    Settings subset of avifEncoder: quality, quality_alpha, speed,
    timescale, repetition_count, keyframe_interval.
    """

    def __init__(self):
        self.quality = 60
        self.quality_alpha = -1  # -1: follow quality
        self.quality_gain_map = -1  # -1: follow quality
        self.speed = 6
        # "auto" | "spec" | "native" (reference: avifEncoder codecChoice,
        # avif.h:1545). "auto"/"spec" emit spec-conformant AV1 for both
        # lossless and lossy — files decode in dav1d/libaom everywhere;
        # "native" opts into the device-pipelined own format (fast path).
        self.codec_choice = "auto"
        self.timescale = 1
        self.repetition_count = 0  # 0 = infinite (reference: avif.h repetition)
        self.keyframe_interval = 0
        self.tx_size = 16
        # AV1 tile grid for the spec codec (avifEncoder tileRowsLog2/
        # tileColsLog2/autoTiling, avif.h:1568-1576; auto heuristic
        # write.c:89-119)
        self.tile_rows_log2 = 0
        self.tile_cols_log2 = 0
        self.auto_tiling = False
        self.max_threads = 8
        # codec key-value knobs (set_codec_specific_option); None = auto
        self.cdef: Optional[bool] = None
        self.deblock: Optional[bool] = None
        self.mode_breadth: Optional[int] = None
        self.tx_breadth: Optional[int] = None
        self.cq_level: Optional[int] = None
        # 16-bit bit-depth extension (avifEncoder::sampleTransformRecipe)
        from ..hdr.sampletransform import Recipe

        self.sample_transform_recipe = Recipe.NONE

        self._frames: list[_PendingFrame] = []
        self._first_image: Optional[Image] = None
        self._first_hdr = None
        self._first_alpha_hdr = None
        self._single = False
        self._codec_options: dict[str, str] = {}

    def set_codec_specific_option(self, key: str, value: str) -> None:
        """Codec key/value passthrough (reference:
        avifEncoderSetCodecSpecificOption, avif.h:1694; storage
        internal.h:517-528). Known keys for the native codec:

          tx-size          transform size (4|8|16|32)
          tile-rows / tile-columns        log2 tile counts for the spec
                                          codec (aom key names,
                                          codec_aom.c:465-470)
          enable-cdef / enable-deblocking 0|1 loop-filter forcing (aom
                                          key names)
          cq-level         direct quantizer 0-63 (aom scale; overrides
                                          the quality->qindex mapping)
          mode-breadth     native codec intra-mode search breadth 1-13
          tx-breadth       native codec transform search breadth 1-5
          color:/alpha: prefixes         scoped variants (codec_aom.c:312
                                          scoping convention)

        Unknown keys are stored and ignored, like the reference's behavior
        for options the codec doesn't understand."""
        self._codec_options[key] = value
        scoped = key.split(":", 1)[-1]
        if scoped == "tx-size":
            v = int(value)
            if v not in (4, 8, 16, 32):
                raise AvifError(Result.INVALID_ARGUMENT, f"tx-size {value}")
            if not key.startswith("alpha:"):
                self.tx_size = v
        elif scoped in ("tile-rows", "tile-columns"):
            v = int(value)
            if not 0 <= v <= 6:
                raise AvifError(Result.INVALID_ARGUMENT, f"{scoped} {value}")
            if not key.startswith("alpha:"):
                if scoped == "tile-rows":
                    self.tile_rows_log2 = v
                else:
                    self.tile_cols_log2 = v
        elif scoped == "enable-cdef":
            # aom key (codec_aom.c passthrough): 0 disables the CDEF
            # search/signaling, 1 forces it on
            if not key.startswith("alpha:"):
                self.cdef = bool(int(value))
        elif scoped == "enable-deblocking":
            if not key.startswith("alpha:"):
                self.deblock = bool(int(value))
        elif scoped == "cq-level":
            # aom quantizer scale 0-63 -> direct qindex override
            v = int(value)
            if not 0 <= v <= 63:
                raise AvifError(Result.INVALID_ARGUMENT, f"cq-level {value}")
            if not key.startswith("alpha:"):
                self.cq_level = v
        elif scoped == "mode-breadth":
            # native codec: intra-mode search breadth (1-13 modes)
            v = int(value)
            if not 1 <= v <= 13:
                raise AvifError(Result.INVALID_ARGUMENT, f"mode-breadth {value}")
            if not key.startswith("alpha:"):
                self.mode_breadth = v
        elif scoped == "tx-breadth":
            # native codec: transform search breadth (1-5 transforms)
            v = int(value)
            if not 1 <= v <= 5:
                raise AvifError(Result.INVALID_ARGUMENT, f"tx-breadth {value}")
            if not key.startswith("alpha:"):
                self.tx_breadth = v

    # ------------------------------------------------------------- internals

    def _params(self, quality: int) -> FrameParams:
        return FrameParams(
            quality=quality, speed=self.speed, tx_size=self.tx_size,
            codec=self.codec_choice,
            tile_rows_log2=self.tile_rows_log2,
            tile_cols_log2=self.tile_cols_log2,
            auto_tiling=self.auto_tiling,
            max_threads=self.max_threads,
            cdef=self.cdef, deblock=self.deblock,
            mode_breadth=self.mode_breadth, tx_breadth=self.tx_breadth,
            cq_level=self.cq_level,
        )

    def _alpha_image(self, image: Image) -> Image:
        """Monochrome wrapper for the alpha plane (the reference's
        monochrome-alpha convention, codec_aom.c:942-944)."""
        a = Image(image.width, image.height, image.depth, PixelFormat.YUV400)
        a.yuv_range = Range.FULL  # alpha is always full range (read.c:6770-6780)
        a.matrix_coefficients = MatrixCoefficients.IDENTITY
        a.yuv_planes[0] = image.alpha_plane
        a.image_owns_yuv_planes = False
        return a

    def _encode_pair(self, image: Image) -> tuple[bytes, Optional[bytes]]:
        if image.width <= 0 or image.height <= 0:
            raise AvifError(Result.NO_CONTENT, "empty image")
        if image.yuv_planes[0] is None:
            raise AvifError(Result.NO_CONTENT, "no YUV planes")
        obus, hdr = encode_frame(image, self._params(self.quality))
        if self._first_hdr is None:
            self._first_hdr = hdr
        alpha_obus = None
        # Opaque-alpha elision (write.c:1884-1902): skip the aux item when
        # every alpha sample is at max.
        if image.alpha_plane is not None and not image.is_opaque():
            qa = self.quality if self.quality_alpha < 0 else self.quality_alpha
            alpha_obus, ahdr = encode_frame(self._alpha_image(image), self._params(qa))
            if self._first_alpha_hdr is None:
                self._first_alpha_hdr = ahdr
        return obus, alpha_obus

    def _base_properties(self, image: Image, hdr, item_is_alpha: bool) -> list[Property]:
        props: list[Property] = [
            Property("ispe", ImageSpatialExtents(image.width, image.height)),
            Property(
                "pixi",
                PixelInformation(
                    plane_depths=[image.depth] * (1 if item_is_alpha or image.monochrome else 3)
                ),
            ),
            Property("av1C", config_from_sequence_header(hdr)),
        ]
        if item_is_alpha:
            from ..containers.items import AuxiliaryType

            props.append(Property("auxC", AuxiliaryType(aux_type=ALPHA_URN)))
            return props
        # colr: icc wins, else nclx when any CICP set (write.c colr logic)
        if image.icc:
            props.append(Property("colr", ColorInformation(icc=image.icc)))
        props.append(
            Property(
                "colr",
                ColorInformation(
                    has_nclx=True,
                    color_primaries=image.color_primaries,
                    transfer_characteristics=image.transfer_characteristics,
                    matrix_coefficients=image.matrix_coefficients,
                    yuv_range=image.yuv_range,
                ),
            )
        )
        t = image.transform_flags
        if t & TransformFlags.PASP:
            props.append(Property("pasp", image.pasp))
        if t & TransformFlags.CLAP:
            props.append(Property("clap", image.clap))
        if t & TransformFlags.IROT:
            props.append(Property("irot", image.irot))
        if t & TransformFlags.IMIR:
            props.append(Property("imir", image.imir))
        if image.clli.max_cll or image.clli.max_pall:
            props.append(Property("clli", image.clli))
        props.extend(image.properties)
        return props

    def _gain_map_items(self, image: Image, next_id: int, color_item_id: int):
        """tmap + gain-map-image items (reference: write.c:1919-1961).

        Returns (items, groups, next_id). The 'tmap' derived item carries
        the ISO 21496-1 metadata and dimg-references [color, gainmap];
        an altr group prefers the tone-mapped rendition."""
        from ..containers.write import OutputGroup
        from ..hdr.gainmap import write_tmap

        gm = image.gain_map
        if gm is None or gm.image is None:
            return [], [], next_id
        qgm = self.quality if self.quality_gain_map < 0 else self.quality_gain_map
        gm_obus, gm_hdr = encode_frame(gm.image, self._params(qgm))
        gm_item_id = next_id
        gm_props = [
            Property("ispe", ImageSpatialExtents(gm.image.width, gm.image.height)),
            Property(
                "pixi",
                PixelInformation(
                    plane_depths=[gm.image.depth] * (1 if gm.image.monochrome else 3)
                ),
            ),
            Property("av1C", config_from_sequence_header(gm_hdr)),
            Property(
                "colr",
                ColorInformation(
                    has_nclx=True,
                    color_primaries=gm.image.color_primaries,
                    transfer_characteristics=gm.image.transfer_characteristics,
                    matrix_coefficients=gm.image.matrix_coefficients,
                    yuv_range=gm.image.yuv_range,
                ),
            ),
        ]
        items = [
            OutputItem(
                id=gm_item_id, item_type="av01", payload=gm_obus,
                properties=gm_props, hidden=True, infe_name="GMap",
            )
        ]
        tmap_id = gm_item_id + 1
        tmap_props = [
            Property("ispe", ImageSpatialExtents(image.width, image.height)),
        ]
        if gm.alt_color_primaries or gm.alt_transfer_characteristics or gm.alt_matrix_coefficients:
            tmap_props.append(
                Property(
                    "colr",
                    ColorInformation(
                        has_nclx=True,
                        color_primaries=gm.alt_color_primaries,
                        transfer_characteristics=gm.alt_transfer_characteristics,
                        matrix_coefficients=gm.alt_matrix_coefficients,
                        yuv_range=gm.alt_yuv_range,
                    ),
                )
            )
        if gm.alt_clli.max_cll or gm.alt_clli.max_pall:
            tmap_props.append(Property("clli", gm.alt_clli))
        items.append(
            OutputItem(
                id=tmap_id, item_type="tmap", payload=write_tmap(gm.metadata),
                properties=tmap_props,
                refs={"dimg": [color_item_id, gm_item_id]},
                infe_name="GMap",
            )
        )
        groups = [
            OutputGroup(grouping_type="altr", group_id=200, entity_ids=[tmap_id, color_item_id])
        ]
        return items, groups, tmap_id + 1

    def _build_items(self, image: Image, obus: bytes, alpha_obus: Optional[bytes]):
        items: list[OutputItem] = [
            OutputItem(
                id=1,
                item_type="av01",
                payload=obus,
                properties=self._base_properties(image, self._first_hdr, False),
                infe_name="Color",
            )
        ]
        next_id = 2
        if alpha_obus is not None:
            items.append(
                OutputItem(
                    id=next_id,
                    item_type="av01",
                    payload=alpha_obus,
                    properties=self._base_properties(image, self._first_alpha_hdr, True),
                    refs={"auxl": [1], **({"prem": [1]} if image.alpha_premultiplied else {})},
                    infe_name="Alpha",
                )
            )
            next_id += 1
        if image.exif:
            # Exif item payload: u32 offset to TIFF header + raw Exif
            # (reference: exif.c / write.c Exif item)
            payload = (0).to_bytes(4, "big") + image.exif
            items.append(
                OutputItem(
                    id=next_id, item_type="Exif", payload=payload,
                    refs={"cdsc": [1]}, infe_name="Exif",
                )
            )
            next_id += 1
        if image.xmp:
            items.append(
                OutputItem(
                    id=next_id, item_type="mime", payload=image.xmp,
                    refs={"cdsc": [1]}, content_type="application/rdf+xml",
                    infe_name="XMP",
                )
            )
            next_id += 1
        return items

    # ---------------------------------------------------------------- public

    def add_image(self, image: Image, duration: int = 1, flags: int = 0) -> None:
        """Queue one frame (reference: avifEncoderAddImage, write.c:2141)."""
        if self._single:
            raise AvifError(Result.ENCODE_COLOR_FAILED, "single-image encoder reused")
        if self._first_image is not None:
            f = self._first_image
            if (image.width, image.height, image.depth, image.yuv_format) != (
                f.width, f.height, f.depth, f.yuv_format
            ):
                raise AvifError(Result.INCOMPATIBLE_IMAGE, "frame geometry changed")
        keyframe = bool(flags & ADD_IMAGE_FLAG_FORCE_KEYFRAME) or not self._frames
        if self.keyframe_interval > 0 and len(self._frames) % self.keyframe_interval == 0:
            keyframe = True
        if image.width <= 0 or image.height <= 0:
            raise AvifError(Result.NO_CONTENT, "empty image")
        if image.yuv_planes[0] is None:
            raise AvifError(Result.NO_CONTENT, "no YUV planes")
        # Intra-only codec: every frame is independently decodable, but the
        # sync-sample table still records requested keyframes for containers.
        # Frames are queued and encoded in ONE pipelined batch at finish().
        if self._first_image is None:
            self._first_image = image.copy("none")
        qa = self.quality if self.quality_alpha < 0 else self.quality_alpha
        self._frames.append(_PendingFrame(
            image.copy("all"), duration, keyframe,
            params=self._params(self.quality), params_alpha=self._params(qa),
        ))
        if flags & ADD_IMAGE_FLAG_SINGLE:
            self._single = True

    def _encode_pending(self) -> None:
        """Batch-encode all queued frames: color samples inter-code in
        GOPs split at sync samples (codec.frame.encode_sequence_frames;
        reference: libaom sequence encode, codec_aom.c:1312), alpha stays
        all-intra (device/host pipelined)."""
        from ..codec.frame import encode_frames_pipelined, encode_sequence_frames

        todo = [f for f in self._frames if f.obus is None]
        if not todo:
            return
        # batch consecutive frames with identical settings snapshots
        # (frames keep their add-time settings — avifenc `:u` semantics)
        groups: list[list[_PendingFrame]] = []
        for f in todo:
            if f.params is None:
                f.params = self._params(self.quality)
            if groups and groups[-1][0].params == f.params:
                groups[-1].append(f)
            else:
                groups.append([f])
        for grp in groups:
            # GOP split at requested keyframes: inter prediction never
            # crosses a sync sample (random access relies on this)
            gops: list[list[_PendingFrame]] = []
            for f in grp:
                if gops and not f.keyframe:
                    gops[-1].append(f)
                else:
                    gops.append([f])
            for gop in gops:
                # a settings change mid-animation starts a fresh GOP:
                # its leader codes (and is marked) as a sync sample
                gop[0].keyframe = True
                color = encode_sequence_frames(
                    [f.image for f in gop], gop[0].params
                )
                if self._first_hdr is None:
                    self._first_hdr = color[0][1]
                for f, (obus, _) in zip(gop, color):
                    f.obus = obus
        qa = self.quality if self.quality_alpha < 0 else self.quality_alpha
        alpha_groups: list[list[_PendingFrame]] = []
        for f in todo:
            if f.image.alpha_plane is None or f.image.is_opaque():
                continue
            if f.params_alpha is None:
                f.params_alpha = self._params(qa)
            if alpha_groups and alpha_groups[-1][0].params_alpha == f.params_alpha:
                alpha_groups[-1].append(f)
            else:
                alpha_groups.append([f])
        for grp in alpha_groups:
            alpha = encode_frames_pipelined(
                [self._alpha_image(f.image) for f in grp], grp[0].params_alpha
            )
            if self._first_alpha_hdr is None:
                self._first_alpha_hdr = alpha[0][1]
            for f, (aobus, _) in zip(grp, alpha):
                f.alpha_obus = aobus

    def finish(self) -> bytes:
        """Serialize (reference: avifEncoderFinish, write.c:3152)."""
        if not self._frames:
            raise AvifError(Result.NO_CONTENT, "no frames added")
        self._encode_pending()
        image = self._first_image
        image.alpha_plane = self._frames[0].image.alpha_plane
        image.gain_map = self._frames[0].image.gain_map
        first = self._frames[0]
        items = self._build_items(image, first.obus, first.alpha_obus)
        if len(self._frames) == 1:
            gm_items, gm_groups, _ = self._gain_map_items(
                image, max(i.id for i in items) + 1, color_item_id=1
            )
            items.extend(gm_items)
            extra = ["tmap"] if gm_items else None
            return write_still(
                items, primary_item_id=1, groups=gm_groups or None,
                extra_brands=extra,
            )
        av1c = config_from_sequence_header(self._first_hdr)
        alpha_av1c = (
            config_from_sequence_header(self._first_alpha_hdr)
            if self._first_alpha_hdr is not None
            else None
        )
        samples = [(f.obus, f.duration, f.keyframe) for f in self._frames]
        alpha_samples = None
        if any(f.alpha_obus for f in self._frames):
            if not all(f.alpha_obus for f in self._frames):
                raise AvifError(
                    Result.ENCODE_ALPHA_FAILED, "alpha present in only some frames"
                )
            alpha_samples = [(f.alpha_obus, f.duration, f.keyframe) for f in self._frames]
        return write_sequence(
            items,
            primary_item_id=1,
            samples=samples,
            alpha_samples=alpha_samples,
            timescale=self.timescale,
            width=image.width,
            height=image.height,
            av1c=av1c,
            repetition_count=self.repetition_count,
            alpha_av1c=alpha_av1c,
        )

    def write(self, image: Image) -> bytes:
        """Single-shot still encode (reference: avifEncoderWrite, write.c:3861)."""
        if image.depth == 16:
            return self._write_sato_still(image)
        self.add_image(image, flags=ADD_IMAGE_FLAG_SINGLE)
        return self.finish()

    # --------------------------------------------- 16-bit (sample transform)

    def _write_sato_still(self, image: Image) -> bytes:
        """16-bit still via 'sato' bit-depth extension (reference:
        avifEncoderCreateBitDepthExtensionItems write.c:1293, base/hidden
        derivation avifEncoderCreateSatoImage write.c:1443-1530).

        Layout (backward-compatible variant): primary = base color item;
        hidden extension item; 'sato' derived item with dimg [base, hidden];
        altr group {sato, base}.
        """
        from ..hdr import sampletransform as st

        recipe = self.sample_transform_recipe
        if recipe == st.Recipe.NONE:
            recipe = st.Recipe.BIT_DEPTH_EXTENSION_12B_4B
        base_depth, hidden_depth = st.recipe_depths(recipe)
        lossless = self.quality >= 100

        def split(plane16: np.ndarray):
            p = plane16.astype(np.int64)
            if recipe == st.Recipe.BIT_DEPTH_EXTENSION_8B_8B:
                return (p >> 8).astype(np.uint8), (p & 255).astype(np.uint8)
            if recipe == st.Recipe.BIT_DEPTH_EXTENSION_12B_4B:
                base = (p >> 4).astype(np.uint16)
                hidden = ((p & 15) << 4).astype(np.uint8)
                if not lossless:
                    hidden = (hidden.astype(np.int64) + 7).clip(0, 255).astype(np.uint8)
                return base, hidden
            # OVERLAP_4B: hidden corrects the *decoded* base, derived below.
            return (p >> 4).astype(np.uint16), None

        base_img = Image(image.width, image.height, base_depth, image.yuv_format)
        base_img.copy_no_pixels(image)
        base_img.depth = base_depth
        hidden_img = Image(image.width, image.height, hidden_depth, image.yuv_format)
        hidden_img.copy_no_pixels(image)
        hidden_img.depth = hidden_depth
        n_planes = 1 if image.monochrome else 3
        for c in range(n_planes):
            b, hd = split(image.yuv_planes[c])
            base_img.yuv_planes[c] = b.astype(base_img.dtype)
            if hd is not None:
                hidden_img.yuv_planes[c] = hd.astype(hidden_img.dtype)

        base_obus, base_hdr = encode_frame(base_img, self._params(self.quality))
        self._first_hdr = base_hdr

        if recipe == st.Recipe.BIT_DEPTH_EXTENSION_12B_8B_OVERLAP_4B:
            # hidden = clamp8(original - decoded_base*16 + 128) (write.c:1502)
            from ..codec import decode_frame as _dec

            decoded_base = _dec(base_obus)
            for c in range(n_planes):
                orig = image.yuv_planes[c].astype(np.int64)
                dec = decoded_base.yuv_planes[c].astype(np.int64)
                hidden_img.yuv_planes[c] = np.clip(
                    orig - dec * 16 + 128, 0, 255
                ).astype(np.uint8)

        hidden_obus, hidden_hdr = encode_frame(hidden_img, self._params(self.quality))

        items = self._build_items(base_img, base_obus, None)
        base_item = items[0]
        next_id = max(i.id for i in items) + 1
        hidden_id = next_id
        items.append(
            OutputItem(
                id=hidden_id,
                item_type="av01",
                payload=hidden_obus,
                properties=[
                    Property("ispe", ImageSpatialExtents(image.width, image.height)),
                    Property(
                        "pixi",
                        PixelInformation(plane_depths=[hidden_depth] * n_planes),
                    ),
                    Property("av1C", config_from_sequence_header(hidden_hdr)),
                ],
                hidden=True,
                infe_name="Extension",
            )
        )
        sato_id = hidden_id + 1
        items.append(
            OutputItem(
                id=sato_id,
                item_type="sato",
                payload=st.write_sato(st.recipe_to_expression(recipe)),
                properties=[
                    Property("ispe", ImageSpatialExtents(image.width, image.height)),
                    Property(
                        "pixi", PixelInformation(plane_depths=[16] * n_planes)
                    ),
                ],
                refs={"dimg": [base_item.id, hidden_id]},
                hidden=True,
                infe_name="SampleTransform",
            )
        )
        from ..containers.write import OutputGroup

        groups = [
            OutputGroup(grouping_type="altr", group_id=100, entity_ids=[sato_id, base_item.id])
        ]
        return write_still(items, primary_item_id=base_item.id, groups=groups)

    # ------------------------------------------------------------------ mini

    def write_mini(self, image: Image) -> bytes:
        """Still encode into a MinimizedImageBox file (reference:
        avifEncoderWriteMiniBox, write.c:2509; 'mif3' brand)."""
        from ..containers.mini import write_mini
        from ..utils.exif import irot_imir_to_orientation

        obus, alpha_obus = self._encode_pair(image)
        gm_kwargs = {}
        gm = image.gain_map
        if gm is not None and gm.image is not None:
            from ..hdr.gainmap import write_tmap

            qgm = self.quality if self.quality_gain_map < 0 else self.quality_gain_map
            gm_obus, gm_hdr = encode_frame(gm.image, self._params(qgm))
            tmap_cicp = None
            if gm.alt_color_primaries or gm.alt_transfer_characteristics or gm.alt_matrix_coefficients:
                tmap_cicp = (
                    int(gm.alt_color_primaries),
                    int(gm.alt_transfer_characteristics),
                    int(gm.alt_matrix_coefficients),
                    1 if gm.alt_yuv_range == Range.FULL else 0,
                )
            gm_kwargs = dict(
                gainmap_cfg=config_from_sequence_header(gm_hdr),
                gainmap_data=gm_obus,
                gainmap_width=gm.image.width,
                gainmap_height=gm.image.height,
                gainmap_depth=gm.image.depth,
                gainmap_format=gm.image.yuv_format,
                gainmap_full_range=gm.image.yuv_range == Range.FULL,
                gainmap_mc=int(gm.image.matrix_coefficients),
                tmap_payload=write_tmap(gm.metadata),
                tmap_cicp=tmap_cicp,
                tmap_icc=gm.alt_icc,
                tmap_clli=gm.alt_clli,
            )
        return write_mini(
            width=image.width,
            height=image.height,
            bit_depth=image.depth,
            yuv_format=image.yuv_format,
            full_range=image.yuv_range == Range.FULL,
            cp=int(image.color_primaries),
            tc=int(image.transfer_characteristics),
            mc=int(image.matrix_coefficients),
            orientation=irot_imir_to_orientation(image),
            main_cfg=config_from_sequence_header(self._first_hdr),
            main_data=obus,
            alpha_cfg=(
                config_from_sequence_header(self._first_alpha_hdr)
                if alpha_obus is not None
                else None
            ),
            alpha_data=alpha_obus or b"",
            alpha_premultiplied=image.alpha_premultiplied,
            icc=image.icc,
            exif=image.exif,
            xmp=image.xmp,
            clli=image.clli,
            **gm_kwargs,
        )

    # ----------------------------------------------------------- progressive

    def write_progressive(self, image: Image, layer_qualities: list[int]) -> bytes:
        """Progressive still: up to 4 refinement layers in one item with an
        'a1lx' layered-image index (reference: avifenc --progressive /
        --layered; sample construction read.c:690-730).

        Each layer is a self-contained stream at increasing quality; byte
        prefixes through layer k decode to layer k.
        """
        if not 1 <= len(layer_qualities) <= 4:
            raise AvifError(Result.INVALID_ARGUMENT, "1..4 layers required")
        if any(
            layer_qualities[i] > layer_qualities[i + 1]
            for i in range(len(layer_qualities) - 1)
        ):
            raise AvifError(Result.INVALID_ARGUMENT, "layer quality must not decrease")
        from ..containers.items import AV1LayeredImageIndexing

        streams = []
        for q in layer_qualities:
            obus, hdr = encode_frame(image, self._params(q))
            if self._first_hdr is None:
                self._first_hdr = hdr
            streams.append(obus)
        payload = b"".join(streams)
        sizes = [len(s) for s in streams[:-1]]
        a1lx = AV1LayeredImageIndexing(layer_size=(sizes + [0, 0, 0])[:3])

        alpha_obus = None
        if image.alpha_plane is not None and not image.is_opaque():
            qa = (
                layer_qualities[-1]
                if self.quality_alpha < 0
                else self.quality_alpha
            )
            alpha_obus, ahdr = encode_frame(self._alpha_image(image), self._params(qa))
            self._first_alpha_hdr = ahdr

        items = self._build_items(image, payload, alpha_obus)
        items[0].properties.append(Property("a1lx", a1lx))
        return write_still(items, primary_item_id=1, extra_brands=["avio"])

    # ------------------------------------------------------------------ grid

    def write_grid(self, cells: list[Image], columns: int, rows: int) -> bytes:
        """Multi-cell grid still (reference: avifEncoderAddImageGrid,
        write.c:2147 + grid validation write.c:1608 + cell padding
        write.c:1151).

        Cells are row-major; the last row/column may be smaller and is
        edge-padded to the tile size before encoding.
        """
        from ..image import are_grid_dimensions_valid

        if len(cells) != columns * rows or not cells:
            raise AvifError(Result.INVALID_IMAGE_GRID, "cell count mismatch")
        cw, ch = cells[0].width, cells[0].height
        last_w = cells[columns - 1].width
        last_h = cells[(rows - 1) * columns].height
        out_w = (columns - 1) * cw + last_w
        out_h = (rows - 1) * ch + last_h
        first = cells[0]
        if len(cells) > 1 and not are_grid_dimensions_valid(
            first.yuv_format, out_w, out_h, cw, ch
        ):
            raise AvifError(Result.INVALID_IMAGE_GRID, "MIAF grid rules violated")
        for idx, cell in enumerate(cells):
            r, col = divmod(idx, columns)
            want_w = last_w if col == columns - 1 else cw
            want_h = last_h if r == rows - 1 else ch
            if (cell.width, cell.height) != (want_w, want_h):
                raise AvifError(Result.INVALID_IMAGE_GRID, f"cell {idx} size")
            if (cell.depth, cell.yuv_format) != (first.depth, first.yuv_format):
                raise AvifError(Result.INVALID_IMAGE_GRID, f"cell {idx} format")

        has_alpha = any(
            c.alpha_plane is not None and not c.is_opaque() for c in cells
        )
        # All cells encode in one pipelined device/host batch (grid cells
        # are independent bitstreams — SURVEY.md §2.4).
        from ..codec.frame import encode_frames_pipelined

        padded_cells = [_pad_cell(cell, cw, ch) for cell in cells]
        color = encode_frames_pipelined(padded_cells, self._params(self.quality))
        if self._first_hdr is None:
            self._first_hdr = color[0][1]
        color_payloads = [obus for obus, _ in color]
        alpha_payloads = []
        if has_alpha:
            alpha_imgs = []
            for padded in padded_cells:
                if padded.alpha_plane is None:
                    padded.alpha_plane = np.full(
                        (padded.height, padded.width),
                        (1 << padded.depth) - 1,
                        dtype=padded.dtype,
                    )
                alpha_imgs.append(self._alpha_image(padded))
            qa = self.quality if self.quality_alpha < 0 else self.quality_alpha
            alpha = encode_frames_pipelined(alpha_imgs, self._params(qa))
            if self._first_alpha_hdr is None:
                self._first_alpha_hdr = alpha[0][1]
            alpha_payloads = [a for a, _ in alpha]

        grid_payload = _grid_descriptor(rows, columns, out_w, out_h)
        grid_like = first.copy("none")
        grid_like.width, grid_like.height = out_w, out_h

        items: list[OutputItem] = []
        next_id = 1
        color_grid_id = next_id
        grid_props = self._base_properties(grid_like, self._first_hdr, False)
        grid_props = [p for p in grid_props if p.fourcc != "av1C"]
        items.append(
            OutputItem(
                id=color_grid_id, item_type="grid", payload=grid_payload,
                properties=grid_props, infe_name="Color",
            )
        )
        next_id += 1
        cell_prop_img = first.copy("none")
        cell_prop_img.width, cell_prop_img.height = cw, ch
        cell_props = [
            Property("ispe", ImageSpatialExtents(cw, ch)),
            Property(
                "pixi",
                PixelInformation(plane_depths=[first.depth] * (1 if first.monochrome else 3)),
            ),
            Property("av1C", config_from_sequence_header(self._first_hdr)),
        ]
        cell_ids = []
        for payload in color_payloads:
            items.append(
                OutputItem(
                    id=next_id, item_type="av01", payload=payload,
                    properties=cell_props, hidden=True,
                )
            )
            cell_ids.append(next_id)
            next_id += 1
        items[0].refs = {"dimg": cell_ids}

        if has_alpha:
            alpha_grid_id = next_id
            from ..containers.items import AuxiliaryType

            agrid_props = [
                Property("ispe", ImageSpatialExtents(out_w, out_h)),
                Property("auxC", AuxiliaryType(aux_type=ALPHA_URN)),
            ]
            items.append(
                OutputItem(
                    id=alpha_grid_id, item_type="grid", payload=grid_payload,
                    properties=agrid_props, refs={"auxl": [color_grid_id]},
                    infe_name="Alpha", hidden=True,
                )
            )
            next_id += 1
            acell_props = [
                Property("ispe", ImageSpatialExtents(cw, ch)),
                Property("pixi", PixelInformation(plane_depths=[first.depth])),
                Property("av1C", config_from_sequence_header(self._first_alpha_hdr)),
                Property("auxC", AuxiliaryType(aux_type=ALPHA_URN)),
            ]
            acell_ids = []
            for payload in alpha_payloads:
                items.append(
                    OutputItem(
                        id=next_id, item_type="av01", payload=payload,
                        properties=acell_props, hidden=True,
                    )
                )
                acell_ids.append(next_id)
                next_id += 1
            items[[i.id for i in items].index(alpha_grid_id)].refs["dimg"] = acell_ids

        return write_still(items, primary_item_id=color_grid_id)


def _pad_cell(cell: Image, cw: int, ch: int) -> Image:
    """Edge-pad a trailing-edge cell to the tile size (reference:
    avifImageCopyAndPad, write.c:1151)."""
    if (cell.width, cell.height) == (cw, ch):
        return cell
    out = Image(cw, ch, cell.depth, cell.yuv_format)
    out.copy_no_pixels(cell)
    out.width, out.height = cw, ch
    out.allocate_planes("yuv")
    for c in range(3):
        src = cell.yuv_planes[c]
        if src is None or out.yuv_planes[c] is None:
            continue
        h, w = src.shape
        dst = out.yuv_planes[c]
        dst[:h, :w] = src
        dst[:h, w:] = src[:, -1:]
        dst[h:, :] = dst[h - 1 : h, :]
    if cell.alpha_plane is not None:
        a = np.full((ch, cw), 0, dtype=cell.dtype)
        h, w = cell.alpha_plane.shape
        a[:h, :w] = cell.alpha_plane
        a[:h, w:] = cell.alpha_plane[:, -1:]
        a[h:, :] = a[h - 1 : h, :]
        out.alpha_plane = a
    return out


def _grid_descriptor(rows: int, columns: int, out_w: int, out_h: int) -> bytes:
    """'grid' item payload (HEIF ImageGrid, read.c:2110 layout)."""
    large = out_w >= (1 << 16) or out_h >= (1 << 16)
    b = bytearray()
    b.append(0)  # version
    b.append(1 if large else 0)  # flags: field size
    b.append(rows - 1)
    b.append(columns - 1)
    nbytes = 4 if large else 2
    b += out_w.to_bytes(nbytes, "big")
    b += out_h.to_bytes(nbytes, "big")
    return bytes(b)


def encode(image: Image, quality: int = 60, speed: int = 6,
           codec: str = "auto") -> bytes:
    """Convenience one-liner."""
    enc = Encoder()
    enc.quality = quality
    enc.speed = speed
    enc.codec_choice = codec
    return enc.write(image)


def encode_batch(
    images: list[Image], quality: int = 60, speed: int = 6,
    codec: str = "auto",
) -> list[bytes]:
    """Pipelined batch still encode: device compute for frame k+1 overlaps
    host entropy for frame k (the production serving path — see
    codec.frame.encode_frames_pipelined). Alpha/metadata follow the same
    item-graph rules as Encoder.write per image. codec="native" selects
    the device-pipelined own format (maximum device throughput, bench.py);
    the default emits spec-conformant AV1 like Encoder.write."""
    from ..codec.frame import FrameParams, encode_frames_pipelined

    params = FrameParams(quality=quality, speed=speed, codec=codec)
    color = encode_frames_pipelined(images, params)
    out = []
    for image, (obus, hdr) in zip(images, color):
        enc = Encoder()
        enc.quality = quality
        enc.speed = speed
        enc._first_hdr = hdr
        alpha_obus = None
        if image.alpha_plane is not None and not image.is_opaque():
            from ..codec import encode_frame as _ef

            alpha_obus, ahdr = _ef(enc._alpha_image(image), params)
            enc._first_alpha_hdr = ahdr
        items = enc._build_items(image, obus, alpha_obus)
        out.append(write_still(items, primary_item_id=1))
    return out
