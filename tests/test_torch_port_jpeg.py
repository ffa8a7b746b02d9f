"""The port's host I/O library (``data/native.py`` over ``native/fst_io.cc``)
and its visualisation on the CPU, against cv2 and the JAX package.

- The baseline JPEG decoder against the JAX package's ``read_image``
  (cv2.imread, libjpeg-turbo): files that cv2 writes at qualities 50, 75
  and 95, sampling 4:4:4, 4:2:2, 4:2:0 and 4:4:0, with and without restart
  intervals, at an odd size (37x53); greyscale; a 480x854 frame; a tiny and
  a narrow image. The target is bit-exact: each case prints its count of
  unequal samples, and the limit is max |d| <= 1/255 with at least 99.9 %
  of the samples equal. Progressive, arithmetic-coded, 12-bit, CMYK and
  truncated files, and Huffman tables with more codes of a length than its
  bits hold, raise a ``ValueError`` naming the file and the reason.
- The port's encoder (``data.io.write_jpeg``): cv2 decodes its files to the
  arrays the port's decoder gives, and the round trip's error is within
  10 % of libjpeg's at the same quality.
- The native ``.flo``, ``.ppm`` and ``.pfm`` readers (and the batch
  readers) equal the port's numpy readers and the JAX package's.
- ``utils/viz.py`` equals the JAX package's exactly.
- The ``davis_unsup`` loader yields a batch from the synthetic tree's
  ``.jpg`` frames.
"""
import importlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from flow_supervisor_tpu.data import io as jio  # noqa: E402
from flow_supervisor_tpu.utils import viz as jviz  # noqa: E402
from flow_supervisor_tpu_torch.data import io as pio  # noqa: E402
from flow_supervisor_tpu_torch.data import native  # noqa: E402
from flow_supervisor_tpu_torch.utils import viz  # noqa: E402

SHARE_EQUAL = 0.999
MAX_DIFF = 1.0 / 255.0
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111}


def _smooth(h, w, seed, channels=3):
    """A smooth random frame with some noise, uint8."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 255, (h // 8 + 2, w // 8 + 2, channels)).astype(np.float32)
    big = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, channels)
    return np.clip(big + rng.normal(0, 6, big.shape), 0, 255).astype(np.uint8)


def _check_like_cv2(path, where):
    got = pio.read_image(path)
    want = jio.read_image(path)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    d = np.abs(got - want)
    unequal = int((d > 0).sum())
    print(f"{where}: {unequal} of {d.size} samples differ from cv2's, max {d.max() * 255:.0f}/255")
    assert d.max() <= MAX_DIFF + 1e-7
    assert unequal <= (1 - SHARE_EQUAL) * d.size


@pytest.mark.parametrize("restart", [0, 4], ids=["no_rst", "rst4"])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_decoder_matches_cv2(quality, sampling, restart, tmp_path):
    path = str(tmp_path / "f.jpg")
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    assert cv2.imwrite(path, _smooth(37, 53, seed=quality), params)
    _check_like_cv2(path, f"q{quality} {sampling} rst {restart} 37x53")


@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (3, 100), (480, 854)],
                         ids=["odd", "one_pixel", "narrow", "davis_frame"])
@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey"])
def test_jpeg_decoder_matches_cv2_by_size(shape, grey, tmp_path):
    path = str(tmp_path / "f.jpg")
    img = _smooth(*shape, seed=shape[0], channels=1 if grey else 3)
    assert cv2.imwrite(path, img[..., 0] if grey else img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    _check_like_cv2(path, f"{'grey' if grey else 'colour'} {shape[0]}x{shape[1]}")
    if grey:
        rgb = pio.read_image(path)
        assert np.array_equal(rgb[..., 0], rgb[..., 1]) and np.array_equal(rgb[..., 0], rgb[..., 2])


def _patched(data: bytes, find: bytes, replace: bytes) -> bytes:
    i = data.index(find)
    return data[:i] + replace + data[i + len(find):]


def _dht(one_bit_codes: int) -> bytes:
    """SOI, then a DC table 0 of ``one_bit_codes`` codes of length 1."""
    counts = bytes([one_bit_codes] + [0] * 15)
    body = b"\x00" + counts + bytes(range(one_bit_codes))
    return b"\xff\xd8\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body


def test_jpeg_refusals_name_the_file_and_the_reason(tmp_path):
    img = _smooth(16, 24, seed=1)
    path = str(tmp_path / "p.jpg")
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="p.jpg: progressive JPEG"):
        pio.read_image(path)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = buf.tobytes()
    sof = data.index(b"\xff\xc0")
    cases = {
        "arithmetic": (_patched(data, b"\xff\xc0", b"\xff\xc9"), "arithmetic-coded"),
        "12bit": (data[:sof + 4] + b"\x0c" + data[sof + 5:], "12-bit"),
        "cmyk": (b"\xff\xd8\xff\xc0\x00\x14\x08\x00\x10\x00\x10\x04"
                 + b"\x01\x11\x00\x02\x11\x00\x03\x11\x00\x04\x11\x00\xff\xd9", "CMYK"),
        "truncated": (data[: len(data) // 2], "truncated"),
        "no_eoi": (data[:-2], "truncated"),
        "not_jpeg": (b"\xff\xd8\xff" + b"\x00" * 20, "marker"),
        # 255 one-bit codes (their lookup entries would run far past the
        # table), and two one-bit codes, the second all ones (libjpeg refuses it)
        "huffman_overfull": (_dht(255) + data[2:], "bad Huffman table"),
        "huffman_all_ones": (_dht(2) + data[2:], "bad Huffman table"),
    }
    for name, (body, reason) in cases.items():
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(body)
        with pytest.raises(ValueError, match=f"{name}.jpg: .*{reason}"):
            pio.read_image(str(p))


@pytest.mark.parametrize("shape,quality", [((48, 64), 90), ((37, 53), 75), ((480, 854), 90),
                                           ((9, 17), 50)])
def test_jpeg_encoder_is_read_alike_by_cv2_and_the_port(shape, quality, tmp_path):
    """cv2 decodes the port's encoder output to what the port's decoder
    gives, and its round trip's mean error is within 10 % (+ 0.25) of
    cv2's (libjpeg's encoder, 4:2:0) at the same quality."""
    img = _smooth(*shape, seed=7)
    path = str(tmp_path / "e.jpg")
    pio.write_jpeg(path, img, quality)
    got = native.read_jpeg(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1])
    err = np.abs(got.astype(np.int32) - img).mean()
    ok, buf = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    ref = np.abs(cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1].astype(np.int32) - img).mean()
    print(f"{shape} q{quality}: round trip mean |d| {err:.2f}, cv2's at that quality {ref:.2f}")
    assert err <= 1.1 * ref + 0.25


def test_native_readers_equal_numpy_and_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    flos, ppms = [], []
    for i in range(3):
        flos.append(str(tmp_path / f"{i}.flo"))
        jio.write_flo(flos[-1], rng.normal(0, 5, (7, 9, 2)).astype(np.float32))
        ppms.append(str(tmp_path / f"{i}.ppm"))
        cv2.imwrite(ppms[-1], rng.integers(0, 256, (11, 14, 3)).astype(np.uint8))
    for f in flos:
        got = native.read_flo(f)
        np.testing.assert_array_equal(got, pio.read_flo_plain(f))
        np.testing.assert_array_equal(got, jio.read_flo(f))
        np.testing.assert_array_equal(pio.read_flo(f), got)
    np.testing.assert_array_equal(native.read_flo_batch(flos, 7, 9, threads=2),
                                  np.stack([pio.read_flo_plain(f) for f in flos]))
    monkeypatch.setenv("FST_NATIVE_IO", "0")
    for f in ppms:
        # the port divides by 255 as cv2 then numpy do (JAX's native reader
        # multiplies by 1/255: compared with it off)
        plain = pio.read_ppm(f).astype(np.float32) / 255.0
        np.testing.assert_array_equal(native.read_ppm(f), plain)
        np.testing.assert_array_equal(pio.read_image(f), plain)
        np.testing.assert_array_equal(pio.read_image(f), jio.read_image(f))
    monkeypatch.undo()
    np.testing.assert_array_equal(native.read_ppm_batch(ppms, 11, 14, threads=3),
                                  np.stack([pio.read_ppm(f) / np.float32(255.0) for f in ppms]))
    commented = str(tmp_path / "commented.ppm")
    with open(commented, "wb") as f:
        f.write(b"P6\n# a comment\n14 # width\n11\n#\n255\n")
        f.write(rng.integers(0, 256, (11, 14, 3)).astype(np.uint8).tobytes())
    np.testing.assert_array_equal(native.read_ppm(commented),
                                  pio.read_ppm(commented) / np.float32(255.0))
    for header, shape, endian, scale in ((b"PF", (6, 8, 3), "<f4", b"-1.0"),
                                         (b"Pf", (6, 8), ">f4", b"1.0")):
        pfm = str(tmp_path / "a.pfm")
        with open(pfm, "wb") as f:
            f.write(header + b"\n8 6\n" + scale + b"\n")
            rng.normal(0, 1, shape).astype(endian).tofile(f)
        got = native.read_pfm(pfm)
        np.testing.assert_array_equal(got, pio.read_pfm_plain(pfm))
        np.testing.assert_array_equal(got, jio.read_pfm(pfm))
    with pytest.raises(FileNotFoundError):
        native.read_flo(str(tmp_path / "missing.flo"))
    with pytest.raises(ValueError, match="not a valid .flo"):
        native.read_flo(ppms[0])
    with pytest.raises(OSError, match="1 of 2 files failed"):
        native.read_flo_batch([flos[0], ppms[0]], 7, 9)


def test_native_library_is_named_by_its_source(monkeypatch, tmp_path):
    """The library's file carries a hash of its source and flags, lives in
    the package's _build/ directory, and another source builds anew."""
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libfst_io_")
    assert path == native.library_path()
    src = tmp_path / "fst_io.cc"
    src.write_text(native.SOURCE.read_text() + "\n// another source\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    other = native.build()
    assert other != path and other.exists() and native.build_seconds > 0.0


def test_viz_equals_jax():
    rng = np.random.default_rng(8)
    flow = rng.normal(0, 4, (20, 30, 2)).astype(np.float32)
    for kw in ({}, {"max_mag": 3.0}):
        got, want = viz.visualize_flow(flow, **kw), jviz.visualize_flow(flow, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(viz.visualize_flow(np.zeros((4, 5, 2), np.float32)),
                                  jviz.visualize_flow(np.zeros((4, 5, 2), np.float32)))
    for kw in ({}, {"clip_flow": 2.0}):
        np.testing.assert_array_equal(viz.flow_to_rgb_wheel(flow, **kw),
                                      jviz.flow_to_rgb_wheel(flow, **kw))


def test_davis_unsup_loader_reads_the_jpeg_tree(tmp_path, monkeypatch):
    from flow_supervisor_tpu_torch import config as pconfig
    from flow_supervisor_tpu_torch.data import paths as ppaths
    from flow_supervisor_tpu_torch.data import pipeline as ppipeline
    from flow_supervisor_tpu_torch.data.synthetic import build_synthetic_tree

    root = tmp_path / "datasets"
    build_synthetic_tree(root)
    frames = sorted((root / "DAVIS/JPEGImages/480p/bear").iterdir())
    assert [f.suffix for f in frames] == [".jpg"] * 3
    for f in frames:
        np.testing.assert_array_equal(pio.read_image(str(f)), jio.read_image(str(f)))
    monkeypatch.setenv("FST_DATA_ROOT", str(root))
    importlib.reload(ppaths)
    try:
        loader = ppipeline.fetch_dataloader(pconfig.TrainCfg(
            stage="davis_unsup", image_size=(24, 40), full_size=(40, 56), batch_size=2,
            loader_workers=0))
        batch = next(loader)
        loader.close()
    finally:
        monkeypatch.undo()
        importlib.reload(ppaths)
    assert batch["image1"].shape == (2, 24, 40, 3)
    assert np.isfinite(batch["image1"]).all() and batch["image1"].std() > 0.05
