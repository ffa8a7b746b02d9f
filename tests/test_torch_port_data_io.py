"""The port's file readers and writers and its dataset catalog against the
JAX package's (which decode with cv2) and cv2 itself, on the CPU.

PNGs are built here from numpy scanlines with every filter type (0-4, and
all five mixed row by row), colour types 0, 2, 3, 4 and 6, at 8 and 16 bits,
wrapped in chunks with their CRCs (cv2 picks its own filters, so files it
writes would not reach each one): the port's ``read_png`` must give the
samples, and ``read_image`` the bits of cv2's ``IMREAD_COLOR`` (BGR
reversed, / 255) and of the JAX ``read_image``. KITTI flow PNGs round-trip
both ways, bit for bit; ``.flo``, ``.pfm`` and ``.ppm`` read bit for bit as
the JAX readers read them. (The JAX package's optional native reader,
native/fst_io.cc, scales a ``.ppm`` by 1 / 255 where cv2 divides by 255, up
to one float ulp apart: the port keeps cv2's division, so the ``.ppm``
comparisons run JAX with FST_NATIVE_IO=0.) On ``flow_supervisor_tpu/data/synthetic.py``'s
tree (plus a small chairs tree) under FST_DATA_ROOT, every catalog gives
the JAX catalog's records and ``load_record`` its arrays.
"""
import importlib
import struct
import zlib

import cv2
import numpy as np
import pytest

from flow_supervisor_tpu.data import datasets as jD
from flow_supervisor_tpu.data import io as jio
from flow_supervisor_tpu.data import paths as jpaths
from flow_supervisor_tpu.data.pipeline import load_record as jload_record
from flow_supervisor_tpu_torch.data import datasets as D
from flow_supervisor_tpu_torch.data import io as pio
from flow_supervisor_tpu_torch.data import paths
from flow_supervisor_tpu_torch.data.pipeline import load_record


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _build_png(path, samples, colour, depth, filters, palette=None, interlace=0):
    """A PNG of samples [H, W, C] with row i filtered by filters[i % len]
    (the reference byte-by-byte filter definitions), the image data split
    over two IDAT chunks."""
    h, w = samples.shape[:2]
    x = samples.astype(">u2") if depth == 16 else samples.astype(np.uint8)
    x = np.ascontiguousarray(x).view(np.uint8).reshape(h, -1).astype(int)
    bpp = x.shape[1] // w
    out = bytearray()
    for i in range(h):
        f = filters[i % len(filters)]
        out.append(f)
        for k in range(x.shape[1]):
            a = x[i, k - bpp] if k >= bpp else 0
            b = x[i - 1, k] if i else 0
            c = x[i - 1, k - bpp] if i and k >= bpp else 0
            out.append((x[i, k] - [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]) & 255)
    z = zlib.compress(bytes(out))
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += _chunk(b"IDAT", z[:7]) + _chunk(b"IDAT", z[7:]) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


_CASES = [(colour, depth) for colour in (0, 2, 4, 6) for depth in (8, 16)] + [(3, 8)]
_FILTERS = [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]]


@pytest.mark.parametrize("filters", _FILTERS, ids=lambda f: "filter" + "".join(map(str, f)))
@pytest.mark.parametrize("colour,depth", _CASES, ids=lambda v: str(v))
def test_png_reads_as_cv2_and_jax_read_it(tmp_path, colour, depth, filters):
    rng = np.random.default_rng(colour * 100 + depth + len(filters) + filters[0])
    h, w, channels = 9, 13, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    palette = rng.integers(0, 256, (20, 3)) if colour == 3 else None
    samples = rng.integers(0, 20 if colour == 3 else 2 ** depth, (h, w, channels))
    samples[0, :3] = 2 ** depth - 1 if colour != 3 else 19  # the largest sample
    path = str(tmp_path / "x.png")
    _build_png(path, samples, colour, depth, filters, palette)
    want = palette[samples[..., 0]] if colour == 3 else samples
    got = pio.read_png(path)
    assert got.dtype == (np.uint16 if depth == 16 else np.uint8)
    np.testing.assert_array_equal(got, want)
    img = pio.read_image(path)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1].astype(np.float32) / 255.0
    assert img.dtype == np.float32 and img.shape == (h, w, 3)
    np.testing.assert_array_equal(img, ref)
    np.testing.assert_array_equal(img, jio.read_image(path))


def test_png_writer_round_trips_through_cv2(tmp_path):
    rng = np.random.default_rng(1)
    for shape, dtype in (((17, 23, 3), np.uint8), ((17, 23), np.uint8), ((9, 5, 4), np.uint16),
                         ((9, 5, 2), np.uint16), ((6, 7, 3), np.uint16)):
        x = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        path = str(tmp_path / "w.png")
        pio.write_png(path, x)
        np.testing.assert_array_equal(pio.read_png(path), x.reshape(*shape[:2], -1))
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if x.ndim == 3 and x.shape[2] >= 3:  # cv2 holds colour as BGR(A)
            back = np.concatenate([back[..., 2::-1], back[..., 3:]], axis=-1)
        elif x.ndim == 3:  # and grey + alpha as BGRA
            back = back[..., [0, 3]]
        np.testing.assert_array_equal(back.reshape(x.shape), x)


def test_kitti_flow_pngs_round_trip_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    flow = rng.normal(0, 30, (12, 21, 2)).astype(np.float32)
    mine, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    pio.write_flow_kitti(mine, flow)
    jio.write_flow_kitti(theirs, flow)
    for path in (mine, theirs):
        got, want = pio.read_flow_kitti(path), jio.read_flow_kitti(path)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[1], 1.0)
        assert np.abs(got[0] - flow).max() <= 1 / 64  # 1/64 px steps, truncated


def test_sparse_kitti_flow_png_reads_its_valid_mask(tmp_path):
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 2 ** 16, (10, 15, 3)).astype(np.uint16)
    raw[..., 2] = rng.random((10, 15)) < 0.3
    path = str(tmp_path / "sparse.png")
    cv2.imwrite(path, raw[..., ::-1])
    for g, w in zip(pio.read_flow_kitti(path), jio.read_flow_kitti(path)):
        np.testing.assert_array_equal(g, w)


def test_flo_pfm_and_ppm_read_as_jax_reads_them(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    flo = str(tmp_path / "a.flo")
    jio.write_flo(flo, rng.normal(0, 5, (7, 9, 2)).astype(np.float32))
    np.testing.assert_array_equal(pio.read_flo(flo), jio.read_flo(flo))
    for header, shape, endian, scale in ((b"PF", (6, 8, 3), "<f4", b"-1.0"),
                                         (b"Pf", (6, 8), ">f4", b"1.0")):
        pfm = str(tmp_path / "a.pfm")
        with open(pfm, "wb") as f:
            f.write(header + b"\n8 6\n" + scale + b"\n")
            rng.normal(0, 1, shape).astype(endian).tofile(f)
        np.testing.assert_array_equal(pio.read_pfm(pfm), jio.read_pfm(pfm))
        for g, w in zip(pio.read_flow_any(pfm), jio.read_flow_any(pfm)):
            np.testing.assert_array_equal(g, w)
    ppm = str(tmp_path / "a.ppm")
    img = rng.integers(0, 256, (11, 14, 3)).astype(np.uint8)
    cv2.imwrite(ppm, img)
    np.testing.assert_array_equal(pio.read_ppm(ppm), img[..., ::-1])
    np.testing.assert_allclose(pio.read_image(ppm), jio.read_image(ppm), rtol=0, atol=6e-8)
    monkeypatch.setenv("FST_NATIVE_IO", "0")
    np.testing.assert_array_equal(pio.read_image(ppm), jio.read_image(ppm))
    with open(ppm, "wb") as f:  # a comment in the header
        f.write(b"P6\n# made by hand\n14 11\n255\n" + img.tobytes())
    np.testing.assert_array_equal(pio.read_ppm(ppm), img)


def test_interlaced_png_jpeg_and_truncated_files_raise(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "i.png")
    _build_png(path, rng.integers(0, 256, (4, 4, 3)), 2, 8, [0], interlace=1)
    with pytest.raises(ValueError, match="Adam7"):
        pio.read_image(path)
    jpg = str(tmp_path / "x.jpg")  # baseline JPEG reads; progressive raises
    cv2.imwrite(jpg, rng.integers(0, 256, (8, 8, 3)).astype(np.uint8))
    np.testing.assert_array_equal(pio.read_image(jpg), jio.read_image(jpg))
    cv2.imwrite(jpg, rng.integers(0, 256, (8, 8, 3)).astype(np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive JPEG"):
        pio.read_image(jpg)
    _build_png(path, rng.integers(0, 256, (4, 4, 3)), 2, 8, [1])
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-20])
    with pytest.raises(ValueError, match="truncated"):
        pio.read_png(path)
    with open(path, "wb") as f:  # one flipped byte inside IHDR
        f.write(data[:20] + bytes([data[20] ^ 1]) + data[21:])
    with pytest.raises(ValueError, match="CRC"):
        pio.read_png(path)


@pytest.fixture()
def both_roots(fake_root, monkeypatch):
    """The synthetic tree (JAX paths reloaded by ``fake_root``) plus a
    two-pair chairs tree, with the port's paths reloaded too."""
    from flow_supervisor_tpu.data.io import write_flo

    chairs = fake_root / "FlyingChairs/FlyingChairs_release/data"
    chairs.mkdir(parents=True)
    rng = np.random.default_rng(6)
    for s in (1, 2, 3):
        for i in (1, 2):
            cv2.imwrite(str(chairs / f"{s:05d}_img{i}.ppm"),
                        rng.integers(0, 256, (24, 32, 3)).astype(np.uint8))
        write_flo(str(chairs / f"{s:05d}_flow.flo"), rng.normal(0, 1, (24, 32, 2)).astype(np.float32))
    (fake_root / "FlyingChairs/FlyingChairs_train_val.txt").write_text("1\n2\n1\n")
    monkeypatch.setenv("FST_NATIVE_IO", "0")  # the .ppm images as cv2 reads them
    importlib.reload(jpaths)
    importlib.reload(paths)
    yield fake_root
    importlib.reload(paths)


_CATALOGS = [
    ("flying_chairs", (True,)), ("flying_chairs", (False,)),
    ("flying_things", ("frames_cleanpass",)), ("flying_things", ("frames_finalpass",)),
    ("sintel", (True, "clean")), ("sintel", (True, "final")), ("sintel", (False, "final")),
    ("sintel_unsup_interval", (True, "final")), ("sintel_unsup_part", (1, "final")),
    ("sintel_unsup_part", (2, "clean")), ("sintel_multiframe", (True, "final")),
    ("kitti", (True,)), ("kitti_2012", (True,)), ("kitti_multiview", (False,)),
    ("kitti_multiview", (False, 2)), ("spring", ()), ("hd1k", ()),
]


def _fields(records):
    return [(r.images, r.flow, r.sparse, r.extra, r.canonical_size) for r in records]


def test_catalogs_and_load_record_match_jax(both_roots):
    assert paths.DATA_ROOT == jpaths.DATA_ROOT == str(both_roots)
    loaded = 0
    for name, args in _CATALOGS:
        got, want = getattr(D, name)(*args), getattr(jD, name)(*args)
        assert _fields(got) == _fields(want), name
        assert _fields(D.backward(got)) == _fields(jD.backward(want)), name
        for rec, jrec in zip(got, want):
            for g, w in zip(load_record(rec), jload_record(jrec)):
                assert g.dtype == w.dtype and g.shape == w.shape, name
                np.testing.assert_array_equal(g, w)
            loaded += 1
    assert loaded >= 20
    davis = str(both_roots / "DAVIS/JPEGImages/480p/bear")
    got, want = D.frames_directory(davis), jD.frames_directory(davis)
    assert _fields(got) == _fields(want) and len(got) == 2
    for g, w in zip(load_record(got[0]), jload_record(want[0])):  # the JPEG frames
        np.testing.assert_array_equal(g, w)
