"""Native (C++) fast paths, loaded via ctypes.

The shared object is built on demand from the checked-in source with the
system toolchain and cached next to it (rebuilds when the source changes).
Everything here has a pure-Python reference implementation; callers fall
back automatically when the toolchain is unavailable
(LIBAVIF_TPU_NATIVE=0 forces the fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

_DIR = pathlib.Path(__file__).parent
_SRC = _DIR / "msac.cc"
_LOCK = threading.Lock()
_lib = None
_tried = False
_error = None


_CXXFLAGS = ["-O3", "-std=c++17"]


def _simd_flags() -> list:
    """AVX512VL flags when the build machine (== the run machine: the
    .so is built on import) supports them — the inverse-transform lane
    vectors need native 64-bit multiplies (vpmullq, AVX512DQ).
    -mprefer-vector-width=256 keeps autovec at 256 bits (no 512-bit
    license downclocking)."""
    try:
        flags = ""
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = line
                    break
        if all(k in flags for k in ("avx512f", "avx512dq", "avx512vl", "avx512bw")):
            return ["-mavx512f", "-mavx512dq", "-mavx512vl", "-mavx512bw",
                    "-mprefer-vector-width=256"]
    except OSError:
        pass
    return []


_CXXFLAGS = _CXXFLAGS + _simd_flags()


def _build(so_path: pathlib.Path) -> None:
    # generic -O3 measured FASTER here than -march=native/x86-64-v3 (the
    # walk is branchy scalar integer code; wide-vector codegen loses)
    cmd = ["g++", *_CXXFLAGS, "-shared", "-fPIC", str(_SRC), "-o", str(so_path)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)


def load():
    """The msac native library, or None when unavailable (load_error()
    then says why)."""
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LIBAVIF_TPU_NATIVE", "1") == "0":
            return None
        try:
            h = hashlib.sha256(_SRC.read_bytes())
            h.update(" ".join(_CXXFLAGS).encode())
            for name in ("tile_walk.inc", "cdef.inc"):
                inc = _DIR / name
                if inc.exists():
                    h.update(inc.read_bytes())
            tag = h.hexdigest()[:16]
            so_path = _DIR / f"_msac_{tag}.so"
            if not so_path.exists():
                _build(so_path)
            lib = ctypes.CDLL(str(so_path))
            lib.avt_encode_tile.restype = ctypes.c_long
            lib.avt_encode_tile.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ]
            lib.avt_spec_coeffs.restype = ctypes.c_long
            lib.avt_spec_coeffs.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ]
            _u16p = ctypes.POINTER(ctypes.c_uint16)
            _i32p = ctypes.POINTER(ctypes.c_int32)
            lib.avt_spec_txb.restype = ctypes.c_long
            lib.avt_spec_txb.argtypes = (
                [ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                 ctypes.POINTER(ctypes.c_int64), _i32p,
                 ctypes.POINTER(ctypes.c_int64)]
                + [_u16p] * 2 + [_i32p] + [_u16p] * 7
                + [_i32p] * 8
            )
            lib.avt_enc_new.restype = ctypes.c_void_p
            lib.avt_enc_new.argtypes = []
            lib.avt_enc_free.restype = None
            lib.avt_enc_free.argtypes = [ctypes.c_void_p]
            lib.avt_enc_symbol.restype = None
            lib.avt_enc_symbol.argtypes = [
                ctypes.c_void_p, _u16p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.avt_enc_bit.restype = None
            lib.avt_enc_bit.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.avt_enc_literal.restype = None
            lib.avt_enc_literal.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
            ]
            lib.avt_enc_golomb.restype = None
            lib.avt_enc_golomb.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.avt_enc_finish.restype = ctypes.c_long
            lib.avt_enc_finish.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_long, ctypes.c_int,
            ]
            lib.avt_spec_txb_enc.restype = ctypes.c_long
            lib.avt_spec_txb_enc.argtypes = (
                [ctypes.c_void_p, _i32p, ctypes.POINTER(ctypes.c_int64)]
                + [_u16p] * 9
                + [_i32p] * 5
                + [ctypes.POINTER(ctypes.c_int64)]
                + [_i32p] * 3
            )
            lib.avt_decode_tile.restype = ctypes.c_int
            lib.avt_decode_tile.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.avt_selftest_roundtrip.restype = ctypes.c_long
            lib.avt_selftest_roundtrip.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ]
            if hasattr(lib, "avt_deblock_pass"):
                lib.avt_deblock_pass.restype = None
                lib.avt_deblock_pass.argtypes = [
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_void_p),
                ]
            if hasattr(lib, "avt_spec_tile"):
                lib.avt_spec_tile.restype = ctypes.c_long
                lib.avt_spec_tile.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_void_p),
                ]
            if hasattr(lib, "avt_spec_tile_enc_walk"):
                lib.avt_spec_tile_enc_walk.restype = ctypes.c_long
                lib.avt_spec_tile_enc_walk.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_double),
                ]
            if hasattr(lib, "avt_cdef_frame"):
                lib.avt_cdef_frame.restype = ctypes.c_long
                lib.avt_cdef_frame.argtypes = [
                    _i32p, _i32p, _i32p, _i32p,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int16),
                    _i32p, _i32p, _i32p,
                ]
            lib.avt_tx_init.restype = None
            lib.avt_tx_init.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            lib.avt_inverse_transform.restype = None
            lib.avt_inverse_transform.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        except Exception as e:  # no toolchain or a failed build: Python fallback
            stderr = getattr(e, "stderr", None) or b""
            _error = f"{type(e).__name__}: {e}\n{stderr.decode(errors='replace')}"
            _lib = None
        return _lib


def load_error():
    """Why load() returned None, if it tried and failed."""
    return _error
