"""afan_torch's image reader on arithmetic-coded (SOF9, SOF10) and lossless
(SOF3) JPEG, and on the JPEG kinds it still refuses, against PIL.

Every decoded case must equal PIL bit for bit: ``read_rgb(p)`` against
``np.asarray(Image.open(p).convert("RGB"))`` (Pillow's libjpeg-turbo 3).

- Arithmetic JPEGs come from ``jpeg_arith_writer.c`` (the fixtures'), built
  with ``cc ... -ljpeg`` against the system's libjpeg; its tests skip only
  where ``jpeglib.h`` is missing (the committed fixtures hold each kind
  everywhere): SOF9 at 4:4:4, 4:2:2, 4:2:0 and gray, restart intervals 0, 1
  and 7, default and other DAC conditioning; CMYK and YCCK; SOF10 with
  libjpeg's simple script and a deeper successive-approximation script,
  with restarts, and every cut of the latter after a complete scan, which
  libjpeg block-smooths; a file whose scan spans more than one of PIL's
  64 KiB reads, which PIL reads whole only when its read size is raised.
- Lossless JPEGs come from ``make_fixtures.encode_lossless_jpeg``:
  predictors 1-7 at Pt 0 and 2, restarts, 4:2:0 and other sampling
  (replicated, not fancy-upsampled), gray with and without JFIF, RGB
  with Adobe's transform 0, CMYK, an interleaved scan or one per
  component, and the restart that libjpeg-turbo undifferences as the
  first row of its iMCU row.
- What the reader refuses, PIL refuses on the same bytes (``afan``'s
  ``load_image``, through PIL, raises; ``read_rgb`` raises naming the
  file): 12-bit samples, hierarchical SOF5, a height of 0 (DNL), SOF11
  (lossless arithmetic: libjpeg-turbo says "arithmetic coding is not
  implemented" before it reads a byte of the scan), fractional sampling,
  lossless YCbCr and YCCK (libjpeg-turbo converts no colours in lossless
  mode), a lossless restart interval that is not a whole number of MCU
  rows, a DAC with L above U, and a truncated arithmetic file.
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

from afan.data import voc_det as j_voc_det
from afan_torch.utils import imread
from chip_smoke import DATA_FIXTURES
from test_torch_imread import _writer, cut_after_scans, pil_rgb, same, \
    scan_starts, smooth

arith_jpeg = _writer.arith_jpeg
lossless = _writer.encode_lossless_jpeg

SIZES = [(83, 61), (17, 9), (1, 1), (48, 64)]
SAMPLINGS = {"444": "1x1,1x1,1x1", "422": "2x1,1x1,1x1",
             "420": "2x2,1x1,1x1", "gray": None}
# libjpeg's simple script goes 2 bits deep; this one 3, with the luma's
# first band split at 9 and refined before the rest joins it
DEEP_SCRIPT = ("0,1,2:0:0:0:2;0,1,2:0:0:2:1;0:1:9:0:3;0:10:63:0:2;"
               "1:1:63:0:2;2:1:63:0:2;0:1:9:3:2;0:1:63:2:1;0,1,2:0:0:1:0;"
               "1:1:63:2:1;2:1:63:2:1;0:1:63:1:0;1:1:63:1:0;2:1:63:1:0")
DEEP_SCRIPT_GRAY = ("0:0:0:0:2;0:0:0:2:1;0:1:9:0:3;0:10:63:0:2;0:1:9:3:2;"
                    "0:1:63:2:1;0:0:0:1:0;0:1:63:1:0")


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    reason = _writer.jpeglib_missing()
    if reason:
        pytest.skip(f"the arithmetic writer cannot be built: {reason}")
    return _writer.build_arith_writer(str(tmp_path_factory.mktemp("writer")))


def image(h, w, seed, sampling):
    img = smooth(h, w, seed)
    return img[..., 0] if sampling is None else img


def check(path, data):
    path.write_bytes(data)
    same(imread.read_rgb(str(path)), pil_rgb(path))


@pytest.mark.parametrize("dac", [{}, dict(dc="2,4", ac=12)],
                         ids=["dac_default", "dac_2_4_12"])
@pytest.mark.parametrize("ri", [0, 1, 7], ids=lambda r: f"restart{r}")
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_arith_sequential_jpeg_equals_pil(tmp_path, writer, sampling, ri,
                                         dac):
    """SOF9 with the DAC conditioning L, U and Kx of every table; a
    restart resets the statistics, registers and DC contexts."""
    for i, (h, w) in enumerate(SIZES):
        opts = dict(q=(40, 90)[i % 2], ri=ri, **dac)
        if SAMPLINGS[sampling]:
            opts["s"] = SAMPLINGS[sampling]
        data = arith_jpeg(writer, image(h, w, i, SAMPLINGS[sampling]),
                          **opts)
        assert b"\xff\xc9" in data and b"\xff\xcc" in data    # SOF9, DAC
        assert (b"\xff\xdd" in data) == bool(ri)
        check(tmp_path / f"{i}.jpg", data)


@pytest.mark.parametrize("space", ["cmyk", "ycck"])
@pytest.mark.parametrize("prog", [0, 1], ids=["sof9", "sof10"])
def test_arith_cmyk_and_ycck_jpeg_equal_pil(tmp_path, writer, space, prog):
    """Four components, Adobe's transform 0 (CMYK) or 2 (YCCK); Pillow
    reads them inverted and turns them into RGB with its cmyk2rgb."""
    rng = np.random.RandomState(prog)
    for i, (h, w) in enumerate(SIZES):
        img = np.concatenate([smooth(h, w, i), rng.randint(
            0, 256, (h, w, 1)).astype(np.uint8)], -1)
        check(tmp_path / f"{i}.jpg",
              arith_jpeg(writer, img, space, q=80, prog=prog))


@pytest.mark.parametrize("ri", [0, 5], ids=lambda r: f"restart{r}")
@pytest.mark.parametrize("script", ["simple", "deep"])
@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
def test_arith_progressive_jpeg_equals_pil(tmp_path, writer, sampling,
                                          script, ri):
    """SOF10: the four scan kinds (DC first and refinement, AC first and
    refinement, the latter past the previous stage's end of block) with
    their statistics, restarts included."""
    for i, (h, w) in enumerate(SIZES):
        opts = dict(q=(30, 95)[i % 2], ri=ri)
        if SAMPLINGS[sampling]:
            opts["s"] = SAMPLINGS[sampling]
        if script == "simple":
            opts["prog"] = 1
        else:
            opts["scans"] = (DEEP_SCRIPT_GRAY if sampling == "gray"
                             else DEEP_SCRIPT)
        data = arith_jpeg(writer, image(h, w, 20 + i, SAMPLINGS[sampling]),
                          **opts)
        assert b"\xff\xca" in data                            # SOF10
        check(tmp_path / f"{i}.jpg", data)


@pytest.mark.parametrize("sampling", ["420", "gray"])
def test_arith_progressive_cut_after_each_scan_equals_pil(tmp_path, writer,
                                                          sampling):
    """The deep script cut after each of its complete scans, then the end
    of the image: libjpeg block-smooths the coefficients it has, as for a
    Huffman file."""
    opts = dict(q=75, scans=DEEP_SCRIPT_GRAY if sampling == "gray"
                else DEEP_SCRIPT)
    if SAMPLINGS[sampling]:
        opts["s"] = SAMPLINGS[sampling]
    for i, (h, w) in enumerate([(61, 83), (64, 80)]):
        data = arith_jpeg(writer, image(h, w, 30 + i, SAMPLINGS[sampling]),
                          **opts)
        n_scans = len(scan_starts(data))
        assert n_scans == (8 if sampling == "gray" else 14)
        for n in range(1, n_scans):
            check(tmp_path / f"{i}_{n}.jpg", cut_after_scans(data, n))


def test_arith_jpeg_past_pils_read_size_equals_pil_read_whole(tmp_path,
                                                             writer):
    """libjpeg's arithmetic decoder cannot wait for more bytes, so PIL,
    which feeds it 64 KiB at a time, refuses a file whose scan spans two
    reads; with its read size raised it decodes it, and so does the
    reader."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (300, 400, 3)).astype(np.uint8)
    data = arith_jpeg(writer, img, q=95)
    assert len(data) > 65536
    path = tmp_path / "large.jpg"
    path.write_bytes(data)
    with pytest.raises(OSError):
        pil_rgb(path)
    with Image.open(path) as im:
        im.decodermaxblock = len(data)
        want = np.asarray(im.convert("RGB"))
    same(imread.read_rgb(str(path)), want)


def test_committed_fixtures_hold_each_new_kind():
    """The committed fixtures hold SOF9 with restarts, SOF10 and SOF3 (in
    every environment; ``test_torch_imread.py`` holds them to PIL)."""
    def read(name):
        with open(os.path.join(DATA_FIXTURES, name), "rb") as f:
            return f.read()
    seq = read("arith_500x375.jpg")
    assert b"\xff\xc9" in seq and b"\xff\xdd" in seq and b"\xff\xd0" in seq
    assert b"\xff\xca" in read("arith_progressive_375x500.jpg")
    assert b"\xff\xc3" in read("lossless_500x375.jpg")


def lossless_pil(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("pt", [0, 2], ids=lambda p: f"pt{p}")
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_jpeg_predictors_equal_pil(tmp_path, predictor, pt):
    """Each predictor with and without a point transform: PIL returns the
    samples written (shifted back by Pt), and so does the reader."""
    for i, (h, w) in enumerate(SIZES + [(375, 500)]):
        img = smooth(h, w, 40 + i)
        data = lossless(img, predictor, pt, restart_rows=(0, 3)[i % 2])
        assert np.array_equal(lossless_pil(data), (img >> pt) << pt)
        check(tmp_path / f"{i}.jpg", data)


LOSSLESS_LAYOUTS = {
    "420": dict(sampling=[(2, 2), (1, 1), (1, 1)]),
    "420_scans": dict(sampling=[(2, 2), (1, 1), (1, 1)], one_scan=False,
                      predictor=(1, 4, 7)),
    "422_restarts": dict(sampling=[(2, 1), (1, 1), (1, 1)], restart_rows=2),
    "440_scans_restarts": dict(sampling=[(1, 2), (1, 1), (1, 1)],
                               one_scan=False, restart_rows=2),
    "411": dict(sampling=[(4, 1), (1, 1), (1, 1)], predictor=6),
    "scans_restart_each_row": dict(sampling=[(2, 2), (1, 1), (1, 1)],
                                   one_scan=False, restart_rows=1,
                                   predictor=5),
    "gray": dict(predictor=3),
    "gray_jfif": dict(jfif=True, restart_rows=1),
    "rgb_adobe0": dict(adobe=0, predictor=2),
    "cmyk": dict(pt=1),
    "cmyk_scans": dict(one_scan=False, predictor=(7, 6, 5, 4)),
}


@pytest.mark.parametrize("layout", sorted(LOSSLESS_LAYOUTS))
def test_lossless_jpeg_layouts_equal_pil(tmp_path, layout):
    """Sampling (replicated: lossless JPEG has no DCT, so libjpeg takes no
    fancy upsampling), interleaved scans and one per component, restarts,
    gray (a JFIF marker changes nothing), RGB (the lossless default, and
    Adobe's transform 0) and CMYK. In a scan of one component of v = 2 a
    restart before its second row makes libjpeg-turbo undifference the
    first row of that iMCU row as a first row
    (``scans_restart_each_row``): the reader follows it, not the
    encoder."""
    kw = dict(LOSSLESS_LAYOUTS[layout])
    channels = 4 if layout.startswith("cmyk") else (
        1 if layout.startswith("gray") else 3)
    for i, (h, w) in enumerate(SIZES + [(375, 500)]):
        img = smooth(h, w, 50 + i)
        if channels == 1:
            img = img[..., 1]
        elif channels == 4:
            img = np.concatenate([img, img[..., :1] // 2], -1)
        data = lossless(img, **kw)
        check(tmp_path / f"{i}.jpg", data)
        if layout in ("gray", "gray_jfif", "rgb_adobe0"):
            assert np.array_equal(lossless_pil(data),
                                  np.dstack([img] * 3) if channels == 1
                                  else img)


def patched(data, at, new):
    return data[:at] + new + data[at + len(new):]


IMG = smooth(64, 80, 1)


def baseline():
    buf = io.BytesIO()
    Image.fromarray(IMG).save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    return data, data.index(b"\xff\xc0")


def arith(writer):
    return arith_jpeg(writer(), IMG, q=90)


# name: (the bytes, given a getter of the arithmetic writer; what the
# reader's message says)
REFUSALS = {
    "12bit": (lambda w: patched(baseline()[0], baseline()[1] + 4, b"\x0c"),
              "12-bit"),
    "sof5": (lambda w: patched(baseline()[0], baseline()[1] + 1, b"\xc5"),
             "hierarchical"),
    "height0": (lambda w: patched(baseline()[0], baseline()[1] + 5,
                                  b"\x00\x00"), "height of 0"),
    "sof11": (lambda w: patched(lossless(IMG), lossless(IMG).index(
        b"\xff\xc3") + 1, b"\xcb"), "arithmetic"),
    # luma 3x1 over chroma 2x1: 3 is no multiple of 2
    "fractional": (lambda w: patched(patched(
        baseline()[0], baseline()[1] + 11, b"\x31"), baseline()[1] + 14,
        b"\x21"), "fractional"),
    "lossless_ycc": (lambda w: lossless(IMG, jfif=True), "YCbCr"),
    "lossless_ycck": (lambda w: lossless(np.dstack([IMG, IMG[..., :1]]),
                                         adobe=2), "YCCK"),
    # 7 MCUs, where a row of this interleaved scan holds 80
    "lossless_restart": (lambda w: lossless(IMG)[:2]
                         + b"\xff\xdd\x00\x04\x00\x07" + lossless(IMG)[2:],
                         "restart interval"),
    "arith_dac_l_above_u": (lambda w: patched(arith(w), arith(w).index(
        b"\xff\xcc") + 5, b"\x02"), "conditioning"),
    "arith_truncated": (lambda w: arith(w)[:len(arith(w)) * 2 // 3],
                        "truncated"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_what_the_reader_refuses_pil_refuses(tmp_path, request, name):
    """Each kind the reader refuses, on the same bytes: ``afan``'s
    ``load_image`` (PIL) raises, and ``read_rgb`` raises a ``ValueError``
    that names the file and what it met."""
    make, what = REFUSALS[name]
    path = tmp_path / f"{name}.jpg"
    path.write_bytes(make(lambda: request.getfixturevalue("writer")))
    sample = j_voc_det.DetSample(name, str(path), 80, 64,
                                 np.zeros((0, 4), np.float32),
                                 np.zeros(0, np.int64))
    with pytest.raises((OSError, SyntaxError)):
        j_voc_det.load_image(sample)
    with pytest.raises(ValueError, match=what) as e:
        imread.read_rgb(str(path))
    assert str(path) in str(e.value)
