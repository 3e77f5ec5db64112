"""PNG reading and writing with numpy and ``zlib`` only (no PIL).

The machine a scan is swept on need not have PIL, so the port reads the
PNGs of a scan itself.  ``read_png`` decodes 8-bit, non-interlaced PNGs of
colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA),
with any of the five row filters, to (H, W, 3) uint8 RGB: alpha is dropped
and grey is repeated, as PIL's ``.convert("RGB")`` does.  Every chunk's CRC
is checked.  Any other variant (another bit depth, interlacing) raises
``PNGUnsupported``; a damaged file raises ``ValueError``.

``write_png`` writes 8-bit RGB with one filter type for every row (so that
tests can produce each filter) in a single ``IDAT`` chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each supported colour type (8-bit samples)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTERS = ("none", "sub", "up", "average", "paeth")
SUPPORTED = ("8-bit, non-interlaced PNG of colour type 0 (grey), 2 (RGB), "
             "3 (palette), 4 (grey+alpha) or 6 (RGBA)")


class PNGUnsupported(ValueError):
    """A valid PNG of a variant this module does not decode."""


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRC checked, up to ``IEND``."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + n
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _paeth(a, b, c):
    """The Paeth predictor of int32 arrays a (left), b (up), c (up-left)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters of (H, W, C) bytes with per-row types (H,).

    Pixel (y, x) depends on (y, x-1), (y-1, x) and (y-1, x-1), so all
    pixels on one anti-diagonal x + y = t are independent of each other.
    The image is stored skewed, ``S[y, y + x] = pixel (y, x)``, so that
    each anti-diagonal is one column of S and every step is a slice; the
    positions of S outside the image stay 0, which is the filters' value
    for neighbours beyond the image's left and top edges.
    """
    H, W, C = raw.shape
    T = H + W - 1
    yy = np.arange(H)[:, None]
    cols = yy + np.arange(W)[None]
    rs = np.zeros((H, T + 1, C), np.int32)  # one spare column at the front
    rs[yy, cols + 1] = raw
    out = np.zeros_like(rs)
    f = ftype[:, None]
    for t in range(T):
        y0, y1 = max(0, t - W + 1), min(H - 1, t)
        c = t + 1
        ys = slice(y0, y1 + 1)
        a = out[ys, c - 1]
        if y0 > 0:
            b = out[y0 - 1:y1, c - 1]
            cc = out[y0 - 1:y1, c - 2]
        else:  # row 0 has no row above it
            b = np.concatenate([np.zeros((1, C), np.int32),
                                out[0:y1, c - 1]])
            cc = np.concatenate([np.zeros((1, C), np.int32),
                                 out[0:y1, c - 2]])
        fy = f[ys]
        pred = np.where(fy == 1, a, 0)
        pred = np.where(fy == 2, b, pred)
        pred = np.where(fy == 3, (a + b) >> 1, pred)
        pred = np.where(fy == 4, _paeth(a, b, cc), pred)
        out[ys, c] = (rs[ys, c] + pred) & 0xFF
    return out[yy, cols + 1].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as fh:
        data = fh.read()
    header = None
    palette = None
    idat = []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind != b"IEND" and not (kind[0] & 0x20):
            raise PNGUnsupported(
                f"{path}: unknown critical chunk {kind!r}; supported: "
                f"{SUPPORTED}")
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in CHANNELS or interlace != 0:
        raise PNGUnsupported(
            f"{path}: {depth}-bit PNG of colour type {ctype}, "
            f"{'interlaced' if interlace else 'not interlaced'}; "
            f"supported: {SUPPORTED}")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown compression {comp} or filter "
                         f"method {filt}")
    C = CHANNELS[ctype]
    try:
        flat = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    stride = W * C + 1
    if len(flat) != H * stride:
        raise ValueError(f"{path}: image data holds {len(flat)} bytes, "
                         f"expected {H * stride}")
    rows = np.frombuffer(flat, np.uint8).reshape(H, stride)
    ftype = rows[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError(f"{path}: unknown row filter {ftype.max()}")
    px = _unfilter(rows[:, 1:].reshape(H, W, C), ftype)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        if px.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _filter(img: np.ndarray, ftype: int) -> np.ndarray:
    """Filter every row of (H, W, C) uint8 with filter ``ftype``."""
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 4) -> None:
    """Write (H, W, 3) uint8 ``img`` as an 8-bit RGB PNG, compressed at
    zlib's default level.

    ``filter_type`` (0-4: none, sub, up, average, paeth) is used for every
    row.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"filter_type must be 0-4, got {filter_type}")
    H, W, _ = img.shape
    rows = _filter(img, filter_type).reshape(H, W * 3)
    body = np.concatenate(
        [np.full((H, 1), filter_type, np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(body.tobytes()))
                 + _chunk(b"IEND", b""))
