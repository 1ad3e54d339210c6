"""Depth image I/O: 16-bit grayscale PNG (TUM RGB-D format).

Two implementations behind one API:

- the native C++ codec (native/depthio.cpp, built on demand with the repo's
  Makefile) — the framework's equivalent of the reference's vendored
  stb_image (reference: Application.cpp:28-29 stbi_load_16), including a
  multi-threaded batch decoder for dataset prefetch;
- a pure-Python fallback (stdlib zlib + numpy) so nothing breaks when a
  compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import zlib
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdepthio.so")
_PNG_SIG = b"\x89PNG\r\n\x1a\n"

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Load the native codec, built from native/depthio.cpp; None if it
    cannot be built.  The library is never committed: make rebuilds it
    whenever the source is newer, and is a no-op otherwise."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        subprocess.run(
            ["make", "-s", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        lib = ctypes.CDLL(_LIB_PATH)
        lib.png16_info.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.png16_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint16),
        ]
        lib.png16_encode.restype = ctypes.c_long
        lib.png16_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ]
        lib.png16_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


# --------------------------------------------------------------------------
# pure-Python codec (fallback + reference implementation for tests)
# --------------------------------------------------------------------------

def _py_decode(data: bytes) -> np.ndarray:
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    width = height = bit_depth = None
    idat = b""
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            width, height, bit_depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            if color != 0:
                raise ValueError("grayscale PNG required")
            if bit_depth not in (8, 16):
                raise ValueError("8/16-bit PNG required")
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if width is None:
        raise ValueError("truncated PNG: missing IHDR")
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    bpp = bit_depth // 8
    stride = width * bpp
    if len(raw) < height * (stride + 1):
        raise ValueError("truncated PNG: incomplete image data")
    out = np.zeros((height, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        row = np.frombuffer(
            raw[y * (stride + 1) : (y + 1) * (stride + 1)], dtype=np.uint8
        )
        filt, row = row[0], row[1:].copy()
        if filt == 0:
            line = row
        elif filt == 2:
            line = row + prior
        else:
            line = row
            a = np.zeros(bpp, dtype=np.int32)
            for x in range(stride):
                av = int(line[x - bpp]) if x >= bpp else 0
                bv = int(prior[x])
                cv = int(prior[x - bpp]) if x >= bpp else 0
                if filt == 1:
                    line[x] = (int(row[x]) + av) & 0xFF
                elif filt == 3:
                    line[x] = (int(row[x]) + (av + bv) // 2) & 0xFF
                elif filt == 4:
                    p = av + bv - cv
                    pa, pb, pc = abs(p - av), abs(p - bv), abs(p - cv)
                    pred = av if pa <= pb and pa <= pc else (
                        bv if pb <= pc else cv
                    )
                    line[x] = (int(row[x]) + pred) & 0xFF
                else:
                    raise ValueError(f"bad filter {filt}")
        out[y] = line
        prior = out[y]
    if bit_depth == 16:
        img = out.reshape(height, width, 2)
        return (
            img[..., 0].astype(np.uint16) << 8 | img[..., 1].astype(np.uint16)
        )
    img8 = out.reshape(height, width).astype(np.uint16)
    return img8 << 8 | img8


def _py_encode(img: np.ndarray) -> bytes:
    img = np.ascontiguousarray(img, dtype=np.uint16)
    height, width = img.shape
    be = img.byteswap() if img.dtype.byteorder in ("<", "=") else img
    raw = b"".join(
        b"\x00" + be[y].tobytes() for y in range(height)
    )
    idat = zlib.compress(raw, 6)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        c = ctype + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", width, height, 16, 0, 0, 0, 0)
    return _PNG_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat) + chunk(
        b"IEND", b""
    )


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def read_depth_png(path: str, native: Optional[bool] = None) -> np.ndarray:
    """Load a 16-bit grayscale PNG as a (H, W) uint16 array."""
    data = open(path, "rb").read()
    lib = _load_native() if native in (None, True) else None
    if lib is not None:
        w, h, bd = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.png16_info(data, len(data), ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(bd))
        if rc == 0:
            out = np.empty((h.value, w.value), dtype=np.uint16)
            rc = lib.png16_decode(
                data, len(data),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            )
            if rc == 0:
                return out
        if native:
            raise ValueError(f"native PNG decode failed ({rc}) for {path}")
    if native:
        raise RuntimeError("native codec unavailable")
    return _py_decode(data)


def write_depth_png(path: str, img: np.ndarray,
                    native: Optional[bool] = None) -> None:
    """Write a (H, W) uint16 array as a 16-bit grayscale PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint16)
    lib = _load_native() if native in (None, True) else None
    if lib is not None:
        h, w = img.shape
        cap = 1024 + 2 * img.nbytes
        out = np.empty(cap, dtype=np.uint8)
        n = lib.png16_encode(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), w, h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        )
        if n > 0:
            open(path, "wb").write(out[:n].tobytes())
            return
        if native:
            raise ValueError(f"native PNG encode failed ({n})")
    if native:
        raise RuntimeError("native codec unavailable")
    open(path, "wb").write(_py_encode(img))


def read_depth_batch(
    paths: Sequence[str], width: int, height: int, num_threads: int = 0
) -> np.ndarray:
    """Decode many uniform-size depth PNGs concurrently (native threads when
    available) -> (N, H, W) uint16.  The dataset-streaming fast path."""
    lib = _load_native()
    if lib is not None:
        out = np.empty((len(paths), height, width), dtype=np.uint16)
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths]
        )
        rc = lib.png16_decode_batch(
            arr, len(paths), width, height,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), num_threads,
        )
        if rc == 0:
            return out
    imgs = [read_depth_png(p) for p in paths]
    for p, img in zip(paths, imgs):
        if img.shape != (height, width):
            raise ValueError(
                f"{p}: depth image is {img.shape[1]}x{img.shape[0]}, "
                f"expected {width}x{height}"
            )
    return np.stack(imgs)
