"""PNG read/write with the standard library only (``zlib`` + ``struct``).

Frames and 8-bit textures go through here, so the render path needs no
imaging package. Other raster formats go through Pillow when it is
installed.

Reading covers non-interlaced PNGs in every colour type and bit depth
(16-bit samples are reduced to their high byte, low-depth grey is scaled to
0..255). Writing emits 8-bit grey, RGB or RGBA with the Sub filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples/pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}           # channels -> colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF
    )


def encode_png(img: np.ndarray) -> bytes:
    """[H, W] or [H, W, C] uint8 (C in 1, 3, 4) -> PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"PNG writer takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    if c not in _COLOUR_TYPE:
        raise ValueError(f"PNG writer takes 1, 3 or 4 channels, got {c}")
    rows = a.reshape(h, w * c).astype(np.int16)
    # Sub filter: each byte minus the byte one pixel to its left
    sub = rows.copy()
    sub[:, c:] -= rows[:, :-c]
    raw = np.concatenate(
        [np.ones((h, 1), np.uint8), (sub & 0xFF).astype(np.uint8)], axis=1
    )
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return b"".join([
        _SIGNATURE,
        _chunk(b"IHDR", ihdr),
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    raw = np.frombuffer(data, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            # Sub: a running sum mod 256 along each byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            # Average / Paeth depend on the decoded pixel to the left:
            # one step per pixel, vectorized over its bytes
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    pred = _paeth(left, up, up_left)
                left = (line[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 (C = 1 grey, 2 grey+alpha, 3 RGB, 4 RGBA;
    palette images expand to RGB or RGBA)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, palette, trns = len(_SIGNATURE), [], None, None
    header = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    c = _CHANNELS.get(ctype, 0)
    if not c or depth not in ((1, 2, 4, 8, 16) if c == 1 else (8, 16)) or (
        ctype == 3 and depth == 16
    ):
        raise ValueError(f"unsupported PNG: colour type {ctype}, depth {depth}")
    bpp = max(1, c * depth // 8)
    stride = (w * c * depth + 7) // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp)
    if depth == 16:
        px = px.reshape(h, w * c, 2)[..., 0]  # high byte of each sample
    elif depth < 8:
        # unpack sub-byte samples, most significant first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = (px[..., None] >> shifts) & ((1 << depth) - 1)
        px = px.reshape(h, -1)[:, :w]
        if ctype == 0:  # scale grey levels to 0..255
            px = px * (255 // ((1 << depth) - 1))
    px = px.astype(np.uint8).reshape(h, w, c)
    if ctype == 3:
        idx = px[..., 0]
        rgb = palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[: len(trns)] = trns
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    return px


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _pillow():
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            "only .png is supported without Pillow; install Pillow for other "
            "image formats"
        ) from exc
    return Image


def save_image(path: str, img: np.ndarray) -> None:
    """Write [H, W(, C)] uint8: PNG natively, other formats via Pillow."""
    if str(path).lower().endswith(".png"):
        write_png(path, img)
    else:
        _pillow().fromarray(np.asarray(img)).save(path)
