"""afan_torch's PNG files against afan's: ``utils/png.py`` (the port's
standard-library writer with ``plt.imsave``'s float → byte rules, the
viridis table kept as data, the VOC palette), ``utils/observe.
save_image_panel`` and ``eval/feature_vis.save_spectrum_pngs``. The machine
with the card has neither PIL nor matplotlib; here both are present, so
each file the port writes is decoded with PIL and compared with the file
``afan`` writes for the same array, pixel for pixel (tolerance 0)."""
import os

import matplotlib
import numpy as np
import pytest
from PIL import Image

from afan.cli.eval_segment import voc_color_map as j_voc_color_map
from afan.data.seg_data import CITY_TRAIN_COLORS as J_CITY_TRAIN_COLORS
from afan.eval.feature_vis import save_spectrum_pngs as j_save_spectrum_pngs
from afan.utils.observe import save_image_panel as j_save_image_panel
from afan_torch.data.seg_data import CITY_TRAIN_COLORS
from afan_torch.eval.feature_vis import save_spectrum_pngs
from afan_torch.utils import png
from afan_torch.utils.observe import save_image_panel

matplotlib.use("Agg")


def pixels(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im)


def same_file_pixels(ours, theirs):
    (m1, a), (m2, b) = pixels(ours), pixels(theirs)
    assert m1 == m2 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def arrays():
    """RGB images and 2-D arrays through plt.imsave's two branches, with
    the edges of its rules: 0 and 1 exactly, NaN, a constant array,
    float64, odd sizes, a single pixel."""
    rng = np.random.RandomState(0)
    rgb = rng.rand(17, 23, 3).astype(np.float32)
    rgb[0, 0] = (0.0, 1.0, 0.5)
    rgb_nan = rgb.copy()
    rgb_nan[3, 4, 1] = np.nan
    heat = (rng.randn(9, 31) * 3 + 2).astype(np.float32)
    heat_nan = heat.copy()
    heat_nan[1, 1] = np.nan
    return {
        "rgb": rgb, "rgb_nan": rgb_nan,
        "rgb64": rng.rand(5, 4, 3),
        "heat": heat, "heat_unit": (heat - heat.min()) / np.ptp(heat),
        "heat_nan": heat_nan, "heat_const": np.full((4, 5), 3.0, np.float32),
        "heat64": rng.randn(8, 8), "one_pixel": np.float32([[0.25]]),
    }


@pytest.mark.parametrize("name", sorted(arrays()))
def test_imsave_equals_matplotlib(tmp_path, name):
    import matplotlib.pyplot as plt
    a = arrays()[name]
    plt.imsave(tmp_path / "theirs.png", a, cmap="viridis")
    png.imsave(str(tmp_path / "ours.png"), a)
    same_file_pixels(tmp_path / "ours.png", tmp_path / "theirs.png")


def test_imsave_refuses_floats_outside_the_unit_range(tmp_path):
    with pytest.raises(ValueError, match="0..1"):
        png.imsave(str(tmp_path / "x.png"), np.full((2, 2, 3), 1.5))


@pytest.mark.parametrize("channels", [3, 4])
def test_write_png_equals_pil(tmp_path, channels):
    a = np.random.RandomState(channels).randint(
        0, 256, (13, 1, channels)).astype(np.uint8)
    a = np.repeat(a, 29, axis=1)
    png.write_png(str(tmp_path / "ours.png"), a)
    Image.fromarray(a).save(tmp_path / "theirs.png")
    same_file_pixels(tmp_path / "ours.png", tmp_path / "theirs.png")
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "bad.png"), a.astype(np.float32))


def test_palettes_are_afans():
    np.testing.assert_array_equal(png.voc_color_map(), j_voc_color_map())
    np.testing.assert_array_equal(png.voc_color_map(21), j_voc_color_map(21))
    np.testing.assert_array_equal(CITY_TRAIN_COLORS, J_CITY_TRAIN_COLORS)
    cm = matplotlib.colormaps["viridis"]
    cm._init()
    np.testing.assert_array_equal(
        png.VIRIDIS, (cm._lut[:256, :3] * 255).astype(np.uint8))


def test_image_panel_equals_afans(tmp_path):
    rng = np.random.RandomState(1)
    image = rng.rand(11, 7, 3).astype(np.float32) * 1.4 - 0.2
    target = rng.randint(0, 256, (11, 7, 3)).astype(np.uint8)
    pred = rng.randint(0, 256, (11, 7, 3)).astype(np.uint8)
    save_image_panel(str(tmp_path / "a" / "ours.png"), image, target, pred)
    j_save_image_panel(str(tmp_path / "theirs.png"), image, target, pred)
    same_file_pixels(tmp_path / "a" / "ours.png", tmp_path / "theirs.png")


def test_spectrum_pngs_equal_afans(tmp_path):
    rng = np.random.RandomState(2)
    spectrum = (rng.randn(3, 2, 6, 10, 8) * 2).astype(np.float32)
    spectrum[:, 1] = 0.5                      # a flat heat map
    images = rng.rand(2, 24, 40, 3).astype(np.float32) * 1.2 - 0.1
    ids = ["img_a", "img_b"]
    n = save_spectrum_pngs(spectrum, images, ids, str(tmp_path / "ours"))
    m = j_save_spectrum_pngs(spectrum, images, ids, str(tmp_path / "theirs"))
    assert n == m == 8
    files = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == files
    for f in files:
        same_file_pixels(tmp_path / "ours" / f, tmp_path / "theirs" / f)
