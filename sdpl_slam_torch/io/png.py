"""PNG reader and writer on ``zlib`` + numpy.

The sequence loaders decode PNGs with the native libpng reader
(``io/native.py``) where that library loads; this module is the decoder
where it does not, and the writer of the demo sequences, so that the
package needs neither OpenCV nor libpng.

Supported: non-interlaced images of colour type 0 (grey), 2 (RGB),
4 (grey + alpha) and 6 (RGBA) at 8 or 16 bits per sample, all five row
filters on read.  Anything else (palette, 1/2/4-bit, Adam7) raises
``ValueError``.  Arrays are (H, W) or (H, W, C), uint8 or native-endian
uint16, channels in file order (RGB).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk %r" % kind)
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    """Paeth predictor on int16 arrays (left, up, upper-left)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters.  ``rows``: (H, W * bpp) uint8 filtered
    bytes, ``ftype``: (H,) filter type per row.  Rows of type 0-2 (None,
    Sub, Up) are undone a row at a time; if any row uses Average or Paeth,
    whose bytes depend on the left, upper and upper-left bytes at once,
    the image is undone along anti-diagonals instead (every byte on one
    depends only on earlier ones), H + W vector steps in all."""
    if ftype.max(initial=0) > 4:
        raise ValueError("bad PNG filter type %d" % ftype.max())
    h = rows.shape[0]
    x = rows.reshape(h, -1, bpp)
    w = x.shape[1]
    # one zero row above and one zero pixel to the left, as the format says
    out = np.zeros((h + 1, w + 1, bpp), np.uint8)
    if ftype.max(initial=0) <= 2:
        for r in range(h):
            if ftype[r] == 1:
                out[r + 1, 1:] = np.cumsum(x[r], axis=0, dtype=np.uint8)
            elif ftype[r] == 2:
                out[r + 1, 1:] = x[r] + out[r, 1:]
            else:
                out[r + 1, 1:] = x[r]
        return out[1:, 1:].reshape(h, w * bpp)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        c = d - r
        ft = ftype[r][:, None]
        a = out[r + 1, c].astype(np.int16)          # left
        b = out[r, c + 1].astype(np.int16)          # up
        ul = out[r, c].astype(np.int16)             # upper left
        pred = np.select(
            [ft == 1, ft == 2, ft == 3, ft == 4],
            [a, b, (a + b) >> 1, _paeth(a, b, ul)], 0)
        out[r + 1, c + 1] = (x[r, c].astype(np.int16) + pred).astype(np.uint8)
    return out[1:, 1:].reshape(h, w * bpp)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file contents -> (H, W) or (H, W, C) uint8 / uint16 array."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            "unsupported PNG: colour type %d, bit depth %d, interlace %d "
            "(supported: grey, RGB, grey+alpha, RGBA at 8 or 16 bits, not "
            "interlaced)" % (ctype, depth, interlace))
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG data holds %d bytes, %d expected"
                         % (raw.size, h * (1 + w * bpp)))
    raw = raw.reshape(h, 1 + w * bpp)
    pix = _unfilter(raw[:, 1:], raw[:, 0], bpp)
    if depth == 16:
        pix = np.ascontiguousarray(pix).view(">u2").astype(np.uint16)
    pix = pix.reshape(h, w, ch)
    return np.ascontiguousarray(pix[..., 0] if ch == 1 else pix)


def read_png(path: str | Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, C in 2, 3, 4) uint8 / uint16 array -> PNG bytes
    (rows filtered with Up, which suits smooth depth and grey images)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3):
        raise ValueError("write_png takes uint8 or uint16 (H, W[, C]) arrays, "
                         "got %s %s" % (img.dtype, img.shape))
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError("write_png: %d channels" % ch)
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(h, -1)
    filt = rows.copy()
    filt[1:] -= rows[:-1]                     # Up, modulo 256
    body = np.empty((h, 1 + filt.shape[1]), np.uint8)
    body[:, 0] = 2
    body[:, 1:] = filt
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), 3))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))
