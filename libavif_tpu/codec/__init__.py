"""Native AV1-family intra codec.

This package replaces the reference's six codec wrappers (SURVEY.md §2.2;
codec_aom.c / codec_dav1d.c / …) with one native codec behind the same
vtable-shaped seam: samples in → OBU payloads out, OBU payload in → planes
out (reference contract: include/avif/internal.h:605-623).

Compute-path split:
- device (JAX/XLA): transforms, quantization, intra
  prediction + wavefront reconstruction, mode search (`recon.py`)
- host: multi-symbol range coding of modes/levels (`entropy.py`, with a
  C++ fast path in native/), OBU framing (`frame.py`)
"""

from .frame import FrameParams, decode_frame, encode_frame  # noqa: F401
