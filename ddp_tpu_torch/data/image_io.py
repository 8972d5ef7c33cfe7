"""Image files read as Pillow reads them, with or without Pillow.

``read_image`` decodes a file through Pillow where Pillow is importable
(imported on the first read, never when this module is imported): that is
the reference's decoder, and the fast one. Where Pillow is not installed it
decodes a PNG with ``read_png`` and refuses a JPEG (ADE20K's images) with an
ImportError that names the missing decoder (ROADMAP.md queue 1).

``read_png`` decodes a PNG with the standard library's ``zlib`` and numpy,
and gives what Pillow gives: ``np.asarray(Image.open(path))``, or with
``rgb=True`` ``np.asarray(Image.open(path).convert("RGB"))``. It takes
8-bit grayscale, grey + alpha, RGB, RGBA and palette images (palettes of 1,
2, 4 or 8 bits) and 16-bit grayscale, not interlaced; other files raise,
naming what they hold. Cityscapes is PNG only.

PNG rows are filtered against the row above and the pixel to the left (five
filter types, one per row). The Average and Paeth predictors take the
already decoded left neighbour, so a row cannot be decoded in one vector
operation; ``_unfilter`` walks the anti-diagonals instead (pixel (r, c) at
step r + c), which needs the left, upper and upper-left pixels only from
earlier steps: W + H - 1 vector steps over at most H rows, each a few
numpy calls. That is far slower than Pillow's C decoder on a Cityscapes
image (PERF.md section 5 has both times), which is why Pillow comes first.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, Pillow's mode name)
_COLOUR = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 4: (2, "LA"), 6: (4, "RGBA")}


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind.decode('latin-1')}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The filtered scanlines ``raw`` ([height, 1 + row_bytes] uint8, each
    led by its filter type) -> the image bytes [height, row_bytes]."""
    kinds = raw[:, 0].astype(np.int64)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    cols = row_bytes // bpp
    filt = raw[:, 1:].reshape(height, cols, bpp).astype(np.int32)
    # recon with a zero row above and a zero column to the left
    rec = np.zeros((height + 1, cols + 1, bpp), np.int32)
    for t in range(height + cols - 1):
        r = np.arange(max(0, t - cols + 1), min(height, t + 1))
        c = t - r
        left, up, ul = rec[r + 1, c], rec[r, c + 1], rec[r, c]
        k = kinds[r][:, None]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [left, up, (left + up) >> 1, paeth], 0)
        rec[r + 1, c + 1] = (filt[r, c] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(height, row_bytes)


def read_png(path: str, rgb: bool = False) -> np.ndarray:
    """The pixels of a PNG as Pillow gives them: [H, W] for grayscale (uint8,
    or uint16 at 16 bits) and palette indices (uint8), [H, W, C] uint8 for
    grey + alpha, RGB and RGBA; with ``rgb`` [H, W, 3] uint8 as Pillow's
    ``convert("RGB")`` gives (grey replicated, alpha dropped, the palette
    looked up)."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced (Adam7) PNG is not supported")
    if colour not in _COLOUR:
        raise ValueError(f"{path}: unknown PNG colour type {colour}")
    channels, mode = _COLOUR[colour]
    supported = depth in (1, 2, 4, 8) if colour == 3 else (
        depth in (8, 16) if colour == 0 else depth == 8)
    if not supported:
        raise NotImplementedError(f"{path}: {depth}-bit {mode} PNG is not supported")
    bits = depth * channels
    row_bytes = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"{path}: {raw.size} decompressed bytes, want "
                         f"{height * (row_bytes + 1)}")
    img = _unfilter(raw.reshape(height, row_bytes + 1), height, row_bytes, max(1, bits // 8))
    if depth < 8:  # palette indices packed high bit first
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        img = ((img[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            height, row_bytes * per_byte)[:, :width]
    elif depth == 16:
        img = img.view(">u2").astype(np.uint16)
    if channels > 1:
        img = img.reshape(height, width, channels)
    if not rgb:
        return img
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        return full[img]
    if colour == 0:
        if depth == 16:
            raise NotImplementedError(f"{path}: 16-bit grayscale to RGB is not supported")
        return np.repeat(img[:, :, None], 3, axis=2)
    if colour == 4:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _pillow_image():
    """Pillow's ``Image`` module, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def read_image(path: str, rgb: bool = False) -> np.ndarray:
    """A ``.png`` or ``.jpg`` file's pixels as ``read_png`` describes them
    (``rgb`` as there): through Pillow where it is installed, else a PNG
    through ``read_png`` and a JPEG not at all (ImportError)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".png", ".jpg", ".jpeg"):
        raise ValueError(f"{path}: unsupported image type {ext!r}")
    image = _pillow_image()
    if image is not None:
        with image.open(path) as im:
            return np.asarray(im.convert("RGB") if rgb else im)
    if ext == ".png":
        return read_png(path, rgb)
    raise ImportError(
        f"{path}: no JPEG decoder: the port reads JPEG through Pillow, which is not "
        "installed here (a decoder of its own is queued in ROADMAP.md queue 1)")
