"""afan_torch's image reader (``afan_torch/utils/imread.py`` over
``afan_torch/csrc/imdecode.cpp``) against PIL, which ``afan`` decodes with.

Every case must equal PIL bit for bit: ``read_rgb(p)`` against
``np.asarray(Image.open(p).convert("RGB"))`` and ``read_label(p)`` against
``np.asarray(Image.open(p), np.uint8)``.

- JPEGs written by PIL (libjpeg-turbo) at 4:4:4, 4:2:2 and 4:2:0, qualities
  10, 75 and 95, at sizes from 1x1 to 500x375 with odd sides (MCU padding
  cropped); gray; optimised Huffman tables; restart intervals by blocks and
  by rows; an RGB JPEG with Adobe's transform 0.
- Progressive JPEGs (PIL's scan script: DC and AC first and refinement
  scans) at the three subsamplings, with optimised tables and with
  restarts, and gray; CMYK JPEGs as PIL writes them (Adobe's transform 0,
  inverted) and as YCCK (the same file with Adobe's transform set to 2),
  baseline and progressive; OpenCV's 4:1:1 and 4:4:0 (PIL writes neither),
  baseline and progressive.
- PNGs of every 8-bit colour type, rows filtered by each of the five
  filter types and by all in turn (``chip_smoke.write_png``), a palette
  shorter than its indices, a ``tRNS`` chunk; every colour type at every
  bit depth PNG allows (1-16), Adam7-interlaced and not, written by the
  fixtures' numpy encoder (``make_fixtures.encode_png``; PIL writes no
  interlaced PNG); the label reader on gray and palette PNGs.
- The committed fixtures of ``tests/fixtures/torch_images`` against their
  manifest, which is recomputed here with PIL so that it cannot go stale.
- Progressive JPEGs that end early (PIL's scan script cut after each of
  its complete scans, then the end-of-image marker: DC only, partial AC
  bands, pending refinements), which libjpeg block-smooths, colour 4:2:0
  and gray, at 61x83 and 64x80, qualities 50 and 90.
- What the reader refuses raises a ``ValueError`` naming the file:
  12-bit, hierarchical (SOF5) and DNL (a height of 0) JPEG, truncated files
  of both kinds (a progressive one cut inside a scan among them), a broken
  checksum, other formats. Arithmetic-coded and lossless JPEG, which PIL
  reads, are held to it in ``tests/test_torch_imread_arith.py``, with each
  JPEG kind both refuse.
"""
import hashlib
import importlib.util
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from afan_torch.utils import imread
from chip_smoke import DATA_FIXTURES, write_png


def _fixture_writer():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(DATA_FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_writer = _fixture_writer()
encode_png = _writer.encode_png
cut_after_scans = _writer.cut_after_scans
scan_starts = _writer.scan_starts

SIZES = [(375, 500), (500, 375), (257, 333), (17, 9), (1, 1), (8, 16),
         (3, 5), (16, 24), (2, 7)]


def smooth(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(x / 17 + seed) * np.cos(y / 23),
                    128 + 120 * np.sin((x + y) / 31),
                    (x * 3 + y * 5) % 256], -1)
    return np.clip(img + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def pil_label(path):
    with Image.open(path) as im:
        return np.asarray(im, np.uint8)


def same(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_jpeg_equals_pil(tmp_path, subsampling, quality):
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(smooth(h, w, i)).save(path, quality=quality,
                                              subsampling=subsampling)
        same(imread.read_rgb(path), pil_rgb(path))


@pytest.mark.parametrize("kw", [dict(optimize=True),
                                dict(restart_marker_blocks=1),
                                dict(restart_marker_blocks=5),
                                dict(restart_marker_rows=1),
                                dict(restart_marker_rows=2, optimize=True)],
                         ids=["optimize", "restart1", "restart5",
                              "restart_row", "restart_rows_optimize"])
@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_jpeg_tables_and_restarts_equal_pil(tmp_path, kw, subsampling):
    for i, (h, w) in enumerate([(375, 500), (257, 333), (9, 17)]):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(smooth(h, w, i)).save(path, quality=80,
                                              subsampling=subsampling, **kw)
        data = open(path, "rb").read()
        if "restart_marker_blocks" in kw or "restart_marker_rows" in kw:
            assert b"\xff\xdd" in data        # a DRI segment
        same(imread.read_rgb(path), pil_rgb(path))


@pytest.mark.parametrize("quality", [30, 90])
def test_gray_jpeg_repeats_its_channel_as_pil(tmp_path, quality):
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(smooth(h, w, i)[..., 0]).save(path, quality=quality)
        with Image.open(path) as im:
            assert im.mode == "L"
        got = imread.read_rgb(path)
        same(got, pil_rgb(path))
        assert np.array_equal(got[..., 0], got[..., 2])


def test_adobe_rgb_jpeg_is_not_converted(tmp_path):
    """``keep_rgb`` writes RGB samples with Adobe's transform 0, which
    libjpeg reads as RGB."""
    path = str(tmp_path / "rgb.jpg")
    Image.fromarray(smooth(60, 90, 3)).save(path, quality=90, keep_rgb=True)
    assert b"Adobe" in open(path, "rb").read()
    same(imread.read_rgb(path), pil_rgb(path))


@pytest.mark.parametrize("kw", [{}, dict(optimize=True),
                                dict(restart_marker_blocks=3),
                                dict(restart_marker_rows=1, optimize=True)],
                         ids=["plain", "optimize", "restart3",
                              "restart_rows_optimize"])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_progressive_jpeg_equals_pil(tmp_path, subsampling, kw):
    """PIL's progressive scan script: DC first (interleaved) and refinement,
    AC first and refinement scans per component with EOB runs; optimised
    tables are redefined between scans; restarts reset the EOB run and the
    DC predictions."""
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(smooth(h, w, i)).save(
            path, quality=(10, 75, 95)[i % 3], subsampling=subsampling,
            progressive=True, **kw)
        assert b"\xff\xc2" in open(path, "rb").read()     # SOF2
        same(imread.read_rgb(path), pil_rgb(path))


def test_gray_progressive_jpeg_equals_pil(tmp_path):
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(smooth(h, w, i)[..., 1]).save(path, quality=60,
                                                      progressive=True)
        same(imread.read_rgb(path), pil_rgb(path))


def adobe_transform(path, transform):
    """The file at ``path`` with its Adobe segment's transform byte set."""
    data = bytearray(open(path, "rb").read())
    at = data.index(b"Adobe")
    data[at + 11] = transform
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("transform", [0, 2], ids=["cmyk", "ycck"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_cmyk_and_ycck_jpeg_equal_pil(tmp_path, transform, progressive):
    """PIL writes CMYK with Adobe's transform 0 and reads it as ``CMYK;I``,
    then ``convert("RGB")`` is its cmyk2rgb; with the transform byte set to
    2 the same samples are read as YCCK, which libjpeg turns into CMYK
    first."""
    for i, (h, w) in enumerate(SIZES[:6]):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(smooth(h, w, i)).convert("CMYK").save(
            path, quality=85, progressive=progressive)
        adobe_transform(path, transform)
        with Image.open(path) as im:
            assert im.mode == "CMYK"
        same(imread.read_rgb(path), pil_rgb(path))


@pytest.mark.parametrize("progressive", [0, 1],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("factor", ["411", "440"])
def test_opencv_411_and_440_jpeg_equal_pil(tmp_path, factor, progressive):
    """Luma 4x1 over chroma 1x1 (replicated) and 1x2 over 1x1 (h1v2 fancy
    upsampling), which PIL cannot write and reads."""
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    for i, (h, w) in enumerate(SIZES):
        path = str(tmp_path / f"{i}.jpg")
        assert cv2.imwrite(path, smooth(h, w, i),
                           [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
                            cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        same(imread.read_rgb(path), pil_rgb(path))


PNG_MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
              4: (8, 16), 6: (8, 16)}


@pytest.mark.parametrize("mode", sorted(PNG_MODES) + ["P"])
def test_png_colour_types_equal_pil(tmp_path, mode):
    rng = np.random.RandomState(len(mode))
    path = str(tmp_path / "a.png")
    if mode == "P":
        im = Image.fromarray(rng.randint(0, 40, (37, 53)).astype(np.uint8),
                             mode="P")
        im.putpalette(rng.randint(0, 256, 40 * 3).astype(np.uint8).tobytes())
    else:
        shape = (37, 53) if mode == "L" else (37, 53, PNG_MODES[mode])
        im = Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8),
                             mode=mode)
    im.save(path)
    same(imread.read_rgb(path), pil_rgb(path))
    if mode in ("L", "P"):
        same(imread.read_label(path), pil_label(path))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "all"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_filter_types_equal_pil(tmp_path, filters, channels):
    """Each filter type forced on every row, and all five in turn; smooth
    and noisy content, so Paeth's ties and all three of its choices
    occur."""
    img = smooth(41, 67, channels)
    img = np.concatenate([img, img[..., :1]], -1)[..., :channels]
    img = img[..., 0] if channels == 1 else img
    path = str(tmp_path / "f.png")
    write_png(path, img, filters=filters)
    same(imread.read_rgb(path), pil_rgb(path))
    if channels == 1:
        same(imread.read_label(path), pil_label(path))


def test_palette_png_past_its_palette_and_with_trns(tmp_path):
    """Indices past a 10-entry palette read as Pillow reads them (black);
    ``read_label`` returns the indices and ignores ``tRNS``."""
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 256, (20, 30)).astype(np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    pal[:10] = rng.randint(0, 256, (10, 3))
    path = str(tmp_path / "p.png")
    write_png(path, idx, palette=pal[:10])
    same(imread.read_rgb(path), pil_rgb(path))
    same(imread.read_label(path), idx)
    im = Image.fromarray(idx, mode="P")
    im.putpalette(pal.tobytes())
    im.info["transparency"] = 3
    trns = str(tmp_path / "t.png")
    im.save(trns, transparency=3)
    assert b"tRNS" in open(trns, "rb").read()
    same(imread.read_label(trns), pil_label(trns))
    same(imread.read_rgb(trns), pil_rgb(trns))


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["rows", "adam7"])
@pytest.mark.parametrize("ctype,depth", [(c, d) for c in sorted(PNG_DEPTHS)
                                         for d in PNG_DEPTHS[c]])
def test_png_depths_and_adam7_equal_pil(tmp_path, ctype, depth, interlace):
    """Every colour type at every depth, Adam7 or not, at sizes where
    passes have no column or no row: ``read_rgb`` and (gray, palette)
    ``read_label`` as PIL's, e.g. 16-bit colour its high byte, 16-bit gray
    clipped to 255 in RGB and its low byte as a label, 1-bit gray 0/255 and
    0/1, 2- and 4-bit gray scaled by 85 and 17, sub-byte palettes looked
    up."""
    rng = np.random.RandomState(ctype * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for i, (h, w) in enumerate([(1, 1), (1, 9), (9, 1), (2, 3), (5, 7),
                                (8, 8), (13, 17), (37, 53)]):
        samples = rng.randint(0, 1 << depth, (h, w, channels))
        palette = (rng.randint(0, 256, (1 << depth, 3))
                   if ctype == 3 else None)
        path = tmp_path / f"{i}.png"
        path.write_bytes(encode_png(samples, depth, ctype, interlace,
                                    palette, filters=(i % 5, 4, 1, 3, 2)))
        same(imread.read_rgb(str(path)), pil_rgb(path))
        if ctype in (0, 3):
            same(imread.read_label(str(path)), pil_label(path))


def manifest():
    out = {}
    for name in sorted(os.listdir(DATA_FIXTURES)):
        path = os.path.join(DATA_FIXTURES, name)
        if name.endswith(".png"):
            a = pil_label(path)
        elif name.endswith(".jpg"):
            a = pil_rgb(path)
        else:
            continue
        out[name] = {"shape": list(a.shape),
                     "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def test_committed_fixtures_match_their_manifest_and_pil():
    with open(os.path.join(DATA_FIXTURES, "manifest.json")) as f:
        committed = json.load(f)
    assert committed == manifest()
    sizes = sum(os.path.getsize(os.path.join(DATA_FIXTURES, n))
                for n in os.listdir(DATA_FIXTURES))
    assert sizes < 400 * 1024
    for name in committed:
        path = os.path.join(DATA_FIXTURES, name)
        if name.endswith(".png"):
            same(imread.read_label(path), pil_label(path))
        else:
            same(imread.read_rgb(path), pil_rgb(path))
    restart = open(os.path.join(DATA_FIXTURES, "restart_333x257.jpg"),
                   "rb").read()
    assert b"\xff\xdd" in restart and b"\xff\xd0" in restart


@pytest.mark.parametrize("gray", [False, True], ids=["color420", "gray"])
@pytest.mark.parametrize("size", [(61, 83), (64, 80)], ids=str)
@pytest.mark.parametrize("quality", [50, 90])
def test_progressive_files_that_end_after_a_scan_equal_pil(tmp_path, gray,
                                                          size, quality):
    """Every cut of PIL's progressive scan script after a complete scan:
    the DC scan alone (libjpeg smooths the DC and estimates nine AC
    coefficients from a 5x5 neighbourhood of DC values), partial AC bands
    and pending refinements (the estimates of the still-zero first nine
    coefficients, clamped below their missing bits), and the whole file;
    block rows and columns at the edges, and 4:2:0 chroma planes whose
    block grid is not the MCU grid, included."""
    img = smooth(*size, 5 + quality)
    if gray:
        img = img[..., 0]
    whole = tmp_path / "whole.jpg"
    Image.fromarray(img).save(whole, quality=quality, progressive=True)
    data = whole.read_bytes()
    n_scans = len(scan_starts(data))
    assert n_scans == (6 if gray else 10)
    for n in range(1, n_scans):
        cut = tmp_path / f"scans{n}.jpg"
        cut.write_bytes(cut_after_scans(data, n))
        same(imread.read_rgb(str(cut)), pil_rgb(cut))
    same(imread.read_rgb(str(whole)), pil_rgb(whole))
    # inside a scan it stays a truncated file, as PIL says
    inside = tmp_path / "inside.jpg"
    inside.write_bytes(data[:(scan_starts(data)[1] + scan_starts(data)[2])
                            // 2])
    refused(inside, "truncated")
    with pytest.raises(OSError, match="truncated"):
        pil_rgb(inside)


def png_bytes(w, h, depth, ctype, interlace, raw):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def refused(path, match, reader=imread.read_rgb):
    with pytest.raises(ValueError, match=match) as e:
        reader(str(path))
    assert str(path) in str(e.value)


def test_what_the_reader_refuses_raises_naming_the_file(tmp_path):
    img = smooth(64, 80, 1)
    jpg = tmp_path / "whole.jpg"
    Image.fromarray(img).save(jpg, quality=90)
    data = jpg.read_bytes()
    sof = data.index(b"\xff\xc0")
    hierarchical = tmp_path / "sof5.jpg"
    hierarchical.write_bytes(data[:sof + 1] + b"\xc5" + data[sof + 2:])
    refused(hierarchical, "hierarchical")
    twelve = tmp_path / "12bit.jpg"                   # the SOF's precision
    twelve.write_bytes(data[:sof + 4] + b"\x0c" + data[sof + 5:])
    refused(twelve, "12-bit")
    dnl = tmp_path / "height0.jpg"                    # the SOF's height
    dnl.write_bytes(data[:sof + 5] + b"\x00\x00" + data[sof + 7:])
    refused(dnl, "height of 0")
    cut = tmp_path / "truncated.jpg"
    cut.write_bytes(data[:len(data) * 2 // 3])
    refused(cut, "truncated")
    with pytest.raises(OSError, match="truncated"):
        pil_rgb(cut)
    prog = tmp_path / "progressive.jpg"
    Image.fromarray(img).save(prog, progressive=True)
    data = prog.read_bytes()
    cut_prog = tmp_path / "truncated_progressive.jpg"
    cut_prog.write_bytes(data[:len(data) * 2 // 3])
    refused(cut_prog, "truncated")
    with pytest.raises(OSError, match="truncated"):
        pil_rgb(cut_prog)
    # the scans up to the last refinement of the AC bands, then the end of
    # the image: PIL decodes it with libjpeg's block smoothing, and so does
    # the reader
    early = tmp_path / "early_end.jpg"
    early.write_bytes(data[:data.rindex(b"\xff\xda")] + b"\xff\xd9")
    assert pil_rgb(early).shape == (64, 80, 3)
    same(imread.read_rgb(str(early)), pil_rgb(early))
    png = tmp_path / "whole.png"
    Image.fromarray(img).save(png)
    data = png.read_bytes()
    cut_png = tmp_path / "truncated.png"
    cut_png.write_bytes(data[:len(data) * 2 // 3])
    refused(cut_png, "truncated")
    bad = bytearray(data)
    bad[40] ^= 0xFF                                    # inside IDAT
    broken = tmp_path / "broken.png"
    broken.write_bytes(bytes(bad))
    refused(broken, "checksum")
    other = tmp_path / "image.bmp"
    Image.fromarray(img).save(other)
    refused(other, "neither a PNG nor a JPEG")
    refused(png, "gray or palette", imread.read_label)
    refused(jpg, "must be a PNG", imread.read_label)
