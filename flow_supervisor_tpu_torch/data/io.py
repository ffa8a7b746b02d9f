"""Flow and image files (counterpart of flow_supervisor_tpu/data/io.py), in
numpy and the standard library's ``zlib``: no cv2, PIL or imageio.

- ``.flo`` (Middlebury): ``read_flo`` / ``write_flo`` of ``flo.py``.
- ``.pfm`` (FlyingThings): PF / Pf header, the scale's sign gives the byte
  order, rows stored bottom-up; ``write_pfm`` writes little-endian.
- ``.ppm`` (chairs): binary P6 with 8-bit samples (``read_ppm`` /
  ``write_ppm``).
- PNG: ``read_png`` decodes 8- and 16-bit (big-endian) samples of colour
  types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA) and
  all five scanline filters; it refuses Adam7-interlaced files.
  ``write_png`` writes grey, grey + alpha, RGB or RGBA, every row with the
  Paeth filter.
- ``read_image``: RGB float32 in [0, 1] as the JAX package reads it with
  ``cv2.IMREAD_COLOR`` and reverses cv2's BGR: grey becomes 3 channels,
  alpha is dropped and 16-bit samples keep their high byte. JPEG raises: no
  decoder is written yet.
- KITTI flow PNGs: 16-bit RGB, u and v stored as 64 * flow + 2^15, the
  third channel the valid mask.
"""
from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

from flow_supervisor_tpu_torch.flo import read_flo, write_flo

__all__ = ["read_flo", "write_flo", "read_pfm", "write_pfm", "read_ppm", "write_ppm",
           "read_png", "write_png",
           "read_image", "read_flow_kitti", "write_flow_kitti", "read_flow_any"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour type -> samples per pixel, and back for the writer
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def read_pfm(path: str) -> np.ndarray:
    """[H, W, 3] (PF) or [H, W] (Pf) float32, top row first."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        m = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not m:
            raise ValueError(f"malformed PFM header: {path}")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f4")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    if data.size != int(np.prod(shape)):
        raise ValueError(f"truncated PFM file {path}")
    return np.ascontiguousarray(np.flipud(data.reshape(shape)).astype(np.float32))


def write_pfm(path: str, data: np.ndarray) -> None:
    """[H, W, 3] (PF) or [H, W] (Pf) as a little-endian PFM file."""
    data = np.asarray(data, np.float32)
    if data.ndim not in (2, 3) or (data.ndim == 3 and data.shape[2] != 3):
        raise ValueError(f"write_pfm takes [H, W] or [H, W, 3], got {data.shape}")
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
        f.write(b"%d %d\n-1.0\n" % (w, h))
        np.ascontiguousarray(np.flipud(data), "<f4").tofile(f)


def write_ppm(path: str, img: np.ndarray) -> None:
    """[H, W, 3] uint8 RGB as a binary (P6) PPM file."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_ppm takes [H, W, 3] uint8, got {img.shape} {img.dtype}")
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img).tobytes())


def read_ppm(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB of a binary (P6) PPM with 8-bit samples."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval; '#' starts a comment
        m = re.compile(rb"(?:\s|#[^\n]*\n)*(\S+)").match(data, pos)
        if m is None:
            raise ValueError(f"malformed PPM header: {path}")
        fields.append(m.group(1))
        pos = m.end()
    if fields[0] != b"P6":
        raise ValueError(f"not a binary (P6) PPM file: {path}")
    width, height, maxval = (int(v) for v in fields[1:])
    if maxval != 255:
        raise ValueError(f"{path}: PPM maxval {maxval}; only 8-bit (255) samples are read")
    n = width * height * 3
    if len(data) < pos + 1 + n:  # one whitespace byte ends the header
        raise ValueError(f"truncated PPM file {path}")
    return np.frombuffer(data, np.uint8, count=n, offset=pos + 1).reshape(height, width, 3).copy()


# ---- PNG ------------------------------------------------------------------


def _png_chunks(data: bytes, path: str):
    """(type, body) of each chunk up to IEND, each CRC checked."""
    view = memoryview(data)
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", view[pos : pos + 8])
        end = pos + 12 + n
        if end > len(data):
            break
        body = view[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", view[pos + 8 + n : end])
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise ValueError(f"truncated PNG file {path}")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left a, up b and up-left c (int16 arrays)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(types: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the scanline filters: types [H] (0-4), filt [H, W, P] the
    filtered bytes of W pixels of P bytes -> the raw bytes [H, W, P] uint8.

    A byte depends on the byte left of it (one pixel back), the byte above
    it and the one above-left. Every pixel of an anti-diagonal i + j = t
    depends only on the two diagonals before it, so the loop runs over the
    H + W - 1 diagonals, each a vector operation over the image's rows, in a
    skewed copy where diagonal t is one contiguous [H, P] slab (row 0 of
    each slab stands for the zero row above the image)."""
    h, w, p = filt.shape
    steps = h + w - 1
    rows = np.arange(h)
    # skewed filtered bytes: fs[t, i] = filt[i, t - i] where 0 <= t - i < w
    cols = np.arange(steps)[:, None] - rows[None, :]
    inside = (cols >= 0) & (cols < w)
    fs = np.where(inside[..., None], filt[rows[None, :], np.clip(cols, 0, w - 1)], 0)
    fs = fs.astype(np.int16)
    # rec[t + 2, i + 1] = recon[i, t - i]; the slabs t = -2, -1 and the row
    # above the image stay zero, and so do entries off the image
    rec = np.zeros((steps + 2, h + 1, p), np.int16)
    present = [int(f) for f in np.unique(types)]
    if max(present) > 4:
        raise ValueError(f"PNG filter type {max(present)} is not one of 0-4")
    masks = {f: (types == f)[:, None] for f in present}
    keep = inside[..., None]
    for t in range(steps):
        a = rec[t + 1, 1:]
        b = rec[t + 1, :-1]
        c = rec[t, :-1]
        pred = None
        for f in present:
            v = (0, a, b)[f] if f < 3 else ((a + b) >> 1 if f == 3 else _paeth(a, b, c))
            pred = v if pred is None else np.where(masks[f], v, pred)
        rec[t + 2, 1:] = np.where(keep[t], (fs[t] + pred) & 255, 0)
    return rec[2 + rows[:, None] + np.arange(w)[None, :], rows[:, None] + 1].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """[H, W, C] samples of a PNG file, uint8 or uint16: C = 1 (grey), 2
    (grey, alpha), 3 (RGB; palette images expanded) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"not a PNG file: {path}")
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNG files are not read")
    if colour not in _PNG_CHANNELS or depth not in (8, 16) or (colour == 3 and depth != 8):
        raise ValueError(f"{path}: PNG colour type {colour} at bit depth {depth} is not read "
                         "(8- and 16-bit samples of types 0, 2, 4, 6; 8-bit palettes)")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _PNG_CHANNELS[colour]
    pixel_bytes = channels * depth // 8
    raw = zlib.decompress(b"".join(idat))
    row = 1 + width * pixel_bytes
    if len(raw) < height * row:
        raise ValueError(f"truncated PNG image data in {path}")
    rows = np.frombuffer(raw, np.uint8, count=height * row).reshape(height, row)
    out = _unfilter(rows[:, 0], rows[:, 1:].reshape(height, width, pixel_bytes))
    if depth == 16:
        return np.ascontiguousarray(out).view(">u2").astype(np.uint16)
    if colour == 3:
        if int(out.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index outside the PLTE chunk")
        return palette[out[..., 0]]
    return out


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(body, zlib.crc32(kind)))


def write_png(path: str, img: np.ndarray) -> None:
    """img [H, W] or [H, W, C] uint8 or uint16, C = 1 (grey), 2 (grey,
    alpha), 3 (RGB) or 4 (RGBA), written as stored: no channel reversal."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16 samples, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _PNG_COLOUR_TYPE:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4], got {img.shape}")
    h, w, ch = img.shape
    depth = 8 * img.dtype.itemsize
    x = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    x = x.view(np.uint8).reshape(h, w, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    filt = ((x - _paeth(a, b, c)) & 255).astype(np.uint8).reshape(h, -1)
    scan = np.concatenate([np.full((h, 1), 4, np.uint8), filt], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _PNG_COLOUR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(scan.tobytes(), 6)) + _png_chunk(b"IEND", b""))


# ---- the readers the records use -----------------------------------------


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] RGB float32 in [0, 1] of a PNG or binary PPM file."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(_PNG_SIGNATURE):
        img = read_png(path)
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        img = img[..., :3] if img.shape[2] >= 3 else np.repeat(img[..., :1], 3, axis=2)
    elif magic.startswith(b"P6"):
        img = read_ppm(path)
    elif magic.startswith(_JPEG_SIGNATURE):
        raise ValueError(f"{path}: JPEG images are not read yet (no decoder without cv2)")
    else:
        raise ValueError(f"{path}: not a PNG or binary PPM image")
    return np.ascontiguousarray(img.astype(np.float32) / 255.0)


def read_flow_kitti(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(flow [H, W, 2], valid [H, W]) float32 of a KITTI flow PNG."""
    raw = read_png(path).astype(np.float32)
    return (raw[:, :, :2] - 2**15) / 64.0, raw[:, :, 2]


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    """Flow [H, W, 2] as a KITTI flow PNG, every pixel valid."""
    uv = 64.0 * flow + 2**15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    write_png(path, np.concatenate([uv, valid], axis=-1).astype(np.uint16))


def read_flow_any(path: str):
    """(flow [H, W, 2] or [H, W] of a one-channel PFM, valid or None), by
    extension: .flo, .pfm (the first two channels), .png (KITTI)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return read_flo(path), None
    if ext == ".pfm":
        data = read_pfm(path)
        return (data if data.ndim == 2 else data[:, :, :2]), None
    if ext == ".png":
        return read_flow_kitti(path)
    raise ValueError(f"unknown flow format: {path}")
