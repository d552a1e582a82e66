"""Image IO and comparison metrics (PSNR gate, per SURVEY.md §4).

PNG IO is a small numpy + zlib codec for 8-bit RGB/RGBA images (what the
goldens and the demo use), so the render path needs no imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # PNG color type -> channels (RGB, RGBA)


def pil_image():
    """PIL.Image, for decoding and resizing textures (glTF images, texture
    layers of another size). The render path does not need it; this raises
    a clear ImportError where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding or resizing textures needs Pillow (PIL), which is not "
            "installed; rendering and PNG IO do not"
        ) from e
    return Image


def to_u8(img: np.ndarray) -> np.ndarray:
    """Float [0,1] (H,W,3|4) -> uint8, with rounding."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(np.round(np.asarray(img, np.float32) * 255.0), 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3|4) image (uint8, or float in [0, 1]) as a PNG."""
    img = to_u8(img)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png needs (H, W, 3|4), got {img.shape}")
    h, w, c = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    # filter type 2 ("Up") on every row: cheap, and decodes vectorized
    rows = np.ascontiguousarray(img).reshape(h, w * c)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, w * c), np.uint8))
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int):
    if ftype == 0:
        return line
    if ftype == 2:
        return line + prev  # uint8 arithmetic wraps mod 256
    if ftype == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
        elif ftype == 4:
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, up[i], c)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced RGB/RGBA PNG -> (H, W, 3|4) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are supported"
        )
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros((w * c,), np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, c)
    return out.reshape(h, w, c)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB between float images in [0,1] (or matching scale)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def srgb_encode(linear: np.ndarray) -> np.ndarray:
    """Linear -> sRGB transfer function."""
    linear = np.clip(np.asarray(linear, np.float32), 0.0, 1.0)
    return np.where(
        linear <= 0.0031308,
        linear * 12.92,
        1.055 * np.power(linear, 1.0 / 2.4) - 0.055,
    )
