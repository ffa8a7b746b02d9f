"""Flow and image files (counterpart of flow_supervisor_tpu/data/io.py), in
numpy, the standard library's ``zlib`` and the port's host library
(``data/native.py``): no cv2, PIL or imageio.

- ``.flo`` (Middlebury): ``read_flo`` by the host library (as the JAX
  package's reads it natively), ``write_flo`` of ``flo.py``; its numpy
  reader ``read_flo_plain``.
- ``.pfm`` (FlyingThings): PF / Pf header, the scale's sign gives the byte
  order, rows stored bottom-up: ``read_pfm`` by the host library, the numpy
  reader ``read_pfm_plain``; ``write_pfm`` writes little-endian.
- ``.ppm`` (chairs): binary P6 with 8-bit samples (``read_ppm``, numpy,
  uint8; ``write_ppm``); ``read_image`` reads them by the host library.
- PNG: ``read_png`` decodes 8- and 16-bit (big-endian) samples of colour
  types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA) and
  all five scanline filters; it refuses Adam7-interlaced files.
  ``write_png`` writes grey, grey + alpha, RGB or RGBA, every row with the
  Paeth filter.
- JPEG: baseline (sequential Huffman, 8-bit) files decoded by the host
  library as libjpeg-turbo decodes them (``native.decode_jpeg``); the
  progressive, arithmetic-coded, 12-bit and CMYK files it refuses raise a
  ``ValueError``. ``write_jpeg`` is a baseline encoder in numpy (Annex K's
  tables, 4:2:0, IJG quality scaling), for synthetic trees.
- ``read_image``: RGB float32 in [0, 1] as the JAX package reads it with
  ``cv2.IMREAD_COLOR`` and reverses cv2's BGR: grey becomes 3 channels,
  alpha is dropped and 16-bit samples keep their high byte. cv2 applies a
  JPEG's EXIF orientation; this reader does not (the datasets' frames carry
  none).
- KITTI flow PNGs: 16-bit RGB, u and v stored as 64 * flow + 2^15, the
  third channel the valid mask.
"""
from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np

from flow_supervisor_tpu_torch.data import native
from flow_supervisor_tpu_torch.flo import read_flo as read_flo_plain
from flow_supervisor_tpu_torch.flo import write_flo

__all__ = ["read_flo", "read_flo_plain", "write_flo", "read_pfm", "read_pfm_plain", "write_pfm",
           "read_ppm", "write_ppm", "read_png", "write_png", "write_jpeg",
           "read_image", "read_flow_kitti", "write_flow_kitti", "read_flow_any"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour type -> samples per pixel, and back for the writer
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def read_flo(path: str) -> np.ndarray:
    """[H, W, 2] float32 of a .flo file, by the host library."""
    return native.read_flo(path)


def read_pfm(path: str) -> np.ndarray:
    """[H, W, 3] (PF) or [H, W] (Pf) float32, top row first, by the host library."""
    return native.read_pfm(path)


def read_pfm_plain(path: str) -> np.ndarray:
    """``read_pfm`` in numpy."""
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


# ---- JPEG: a baseline encoder ---------------------------------------------

# zigzag position -> natural (row-major) index in an 8x8 block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.1 / K.2 quantization tables, natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24,
                                                              26, 56, 47, 66]
# Annex K.3 Huffman tables: (code counts by length 1-16, symbols)
_AC_SYMBOLS_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a73747576777879"
    "7a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_SYMBOLS_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f117"
    "18191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778"
    "797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_HUFFMAN = {  # (class << 4 | id) -> (counts, symbols)
    0x00: (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    0x01: (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    0x10: (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_SYMBOLS_LUMA),
    0x11: (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_SYMBOLS_CHROMA),
}


def _huffman_codes(counts: bytes, symbols: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Annex C's canonical codes -> (code, length) by symbol, 256 each."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG's quality scaling of an Annex K table (jcparam.c), 1-255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    d = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    d[0] /= np.sqrt(2)
    return d


def _blocks(plane: np.ndarray, by: int, bx: int) -> np.ndarray:
    """plane [MY * by * 8, MX * bx * 8] -> blocks [MY * MX, by * bx, 64], each
    MCU's by x bx blocks in row-major order."""
    my, mx = plane.shape[0] // (8 * by), plane.shape[1] // (8 * bx)
    return plane.reshape(my, by, 8, mx, bx, 8).transpose(0, 3, 1, 4, 2, 5).reshape(
        my * mx, by * bx, 64)


def _bit_length(a: np.ndarray) -> np.ndarray:
    return np.frexp(np.abs(a).astype(np.float64))[1].astype(np.int64)


def write_jpeg(path: str, img: np.ndarray, quality: int = 90) -> None:
    """img [H, W, 3] uint8 RGB as a baseline JFIF file: YCbCr 4:2:0,
    Annex K's quantization tables at IJG ``quality``, Annex K's Huffman
    tables, one interleaved scan, no restart markers."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg takes [H, W, 3] uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    x = np.pad(img.astype(np.float64), ((0, -h % 16), (0, -w % 16), (0, 0)), mode="edge")
    qs = [_quant_table(_Q_LUMA, quality), _quant_table(_Q_CHROMA, quality)]
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b

    def down(c):  # 2x2 means
        return c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean(axis=(1, 3))

    blocks = np.concatenate([_blocks(y - 128.0, 2, 2), _blocks(down(cb), 1, 1),
                             _blocks(down(cr), 1, 1)], axis=1)
    n_mcu = blocks.shape[0]
    comp = np.tile([0, 0, 0, 0, 1, 2], n_mcu)  # the MCU's 4 Y blocks, Cb, Cr
    table = np.minimum(comp, 1)  # luma or chroma tables
    d = _dct_matrix()
    coef = d @ blocks.reshape(-1, 8, 8) @ d.T
    q = np.stack(qs)[table].reshape(-1, 8, 8)
    zz = np.round(coef / q).astype(np.int64).reshape(-1, 64)[:, _ZIGZAG]
    nb = zz.shape[0]
    # DC: the difference from the previous block of the same component
    dc = zz[:, 0].copy()
    for c in np.unique(comp):
        sel = comp == c
        dc[sel] = np.diff(zz[sel, 0], prepend=0)
    # events: (sort key, table id, symbol, extra bits, their length); a block's
    # keys are block * 130 + 0 (DC), 2k - 1 (ZRLs before coefficient k), 2k
    # (coefficient k) or 129 (EOB), so one sort puts them in stream order
    cols = ([], [], [], [], [])

    def add(key, *rest):
        key = np.asarray(key, np.int64)
        for lst, v in zip(cols, (key, *rest)):
            lst.append(np.broadcast_to(np.asarray(v, np.int64), key.shape))

    size = _bit_length(dc)
    add(np.arange(nb) * 130, table, size, np.where(dc < 0, dc + (1 << size) - 1, dc), size)
    bi, ki = np.nonzero(zz[:, 1:])
    ki = ki + 1
    v = zz[bi, ki]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], ki[:-1]]))
    run = ki - prev - 1
    size = _bit_length(v)
    add(bi * 130 + 2 * ki, 0x10 | table[bi], (run % 16) * 16 + size,
        np.where(v < 0, v + (1 << size) - 1, v), size)
    zrl = np.repeat(np.arange(len(bi)), run // 16)  # a ZRL per 16 zeros of a run
    add(bi[zrl] * 130 + 2 * ki[zrl] - 1, 0x10 | table[bi[zrl]], 0xF0, 0, 0)
    last = np.zeros(nb, np.int64)
    last[bi] = ki  # the last write per block is its last nonzero coefficient
    eob = np.nonzero(last < 63)[0]
    add(eob * 130 + 129, 0x10 | table[eob], 0, 0, 0)
    key, tid, sym, val, n = (np.concatenate(c) for c in cols)
    order = np.argsort(key, kind="stable")
    tid, sym, val, n = tid[order], sym[order], val[order], n[order]
    codes = {t: _huffman_codes(*_HUFFMAN[t]) for t in _HUFFMAN}
    code, clen = np.zeros(len(sym), np.int64), np.zeros(len(sym), np.int64)
    for t, (c_of, l_of) in codes.items():
        sel = tid == t
        code[sel], clen[sel] = c_of[sym[sel]], l_of[sym[sel]]
    item_val = np.stack([code, val], 1).reshape(-1)
    item_len = np.stack([clen, n], 1).reshape(-1)
    total = int(item_len.sum())
    starts = np.cumsum(item_len) - item_len
    owner = np.repeat(np.arange(len(item_len)), item_len)
    shift = item_len[owner] - 1 - (np.arange(total) - starts[owner])
    bits = ((item_val[owner] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])  # pad with 1-bits
    data = np.packbits(bits)
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0)  # stuff a 0 after each 0xFF

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body

    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out.append(segment(0xDB, b"".join(bytes([i]) + qs[i][_ZIGZAG].astype(np.uint8).tobytes()
                                      for i in range(2))))
    comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]  # (id, sampling, quantization table)
    out.append(segment(0xC0, struct.pack(">BHHB", 8, h, w, len(comps))
                       + b"".join(bytes(c) for c in comps)))
    out.append(segment(0xC4, b"".join(bytes([t]) + _HUFFMAN[t][0] + _HUFFMAN[t][1]
                                      for t in _HUFFMAN)))
    out.append(segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([c[0], 0x00 if c[2] == 0 else 0x11]) for c in comps) + b"\x00\x3f\x00"))
    with open(path, "wb") as f:
        f.write(b"".join(out) + data.tobytes() + b"\xff\xd9")


# ---- the readers the records use -----------------------------------------


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] RGB float32 in [0, 1] of a PNG, baseline JPEG or binary PPM file."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(_PNG_SIGNATURE):
        img = read_png(path)
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        img = img[..., :3] if img.shape[2] >= 3 else np.repeat(img[..., :1], 3, axis=2)
    elif magic.startswith(b"P6"):
        return native.read_ppm(path)
    elif magic.startswith(_JPEG_SIGNATURE):
        img = native.read_jpeg(path)
    else:
        raise ValueError(f"{path}: not a PNG, JPEG or binary PPM image")
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
