"""The rest of ``afan/data/ext_transforms.py`` in afan_torch, against
afan's on the same ``RandomState``, bit for bit: ``ExtRandomVerticalFlip``,
``ExtCenterCrop``, ``ExtScale``, ``ExtRandomRotation``, ``ExtPad``,
``ExtResize``, ``ExtToTensor``, ``ExtNormalize``, ``ExtLambda``,
``ExtRandomCrop``'s fixed padding and ``ExtColorJitter``'s hue. ``afan``
resizes and rotates through PIL, the port in numpy; the rotation is held
to PIL's ``Image.rotate`` also on the paths the random angles seldom
reach: the exact-angle shortcuts, non-square images at 90 and 270 degrees
without ``expand``, a shear that rounds to 0 (Pillow's scale path) and an
image wider than the 16.16 fixed-point range (its float path).

Each transform's ``skip`` draws what its ``__call__`` draws and returns the
size the call gives.
"""
import numpy as np
import pytest
from PIL import Image

from afan.data import ext_transforms as j_ext
from afan_torch.data import ext_transforms as ext
from torch_threads import one_torch_thread  # noqa: F401


def pair(seed, h=37, w=53, classes=21):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3).astype(np.float32)
    lbl = rng.randint(0, classes, (h, w)).astype(np.int32)
    lbl[:3, :4] = 255
    return img, lbl


def same_call(port, afan, seed, img, lbl):
    """Both on ``RandomState(seed)``: equal outputs and states; the port's
    ``skip`` on a third state draws alike and gives the output's size."""
    r1, r2, r3 = (np.random.RandomState(seed) for _ in range(3))
    got, want = port(img, lbl, r1), afan(img, lbl, r2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert port.skip(lbl.shape, r3) == got[1].shape
    for s in (r1, r3):
        np.testing.assert_array_equal(s.get_state()[1], r2.get_state()[1])
        assert s.get_state()[2] == r2.get_state()[2]
    return got


CASES = {
    "vflip": (ext.ExtRandomVerticalFlip(0.7),
              j_ext.ExtRandomVerticalFlip(0.7)),
    "center_crop": (ext.ExtCenterCrop((20, 70)),
                    j_ext.ExtCenterCrop((20, 70))),
    "center_crop_int": (ext.ExtCenterCrop(30), j_ext.ExtCenterCrop(30)),
    "scale": (ext.ExtScale(0.7), j_ext.ExtScale(0.7)),
    "scale_up": (ext.ExtScale(1.6), j_ext.ExtScale(1.6)),
    "rotation": (ext.ExtRandomRotation(30), j_ext.ExtRandomRotation(30)),
    "rotation_expand": (ext.ExtRandomRotation((-180, 180), expand=True,
                                              label_fill=255),
                        j_ext.ExtRandomRotation((-180, 180), expand=True,
                                                label_fill=255)),
    "pad": (ext.ExtPad(16), j_ext.ExtPad(16)),
    "pad_fill": (ext.ExtPad(7, label_fill=3), j_ext.ExtPad(7, label_fill=3)),
    "resize_pair": (ext.ExtResize((24, 31)), j_ext.ExtResize((24, 31))),
    "resize_short": (ext.ExtResize(29), j_ext.ExtResize(29)),
    "to_tensor": (ext.ExtToTensor(), j_ext.ExtToTensor()),
    "normalize": (ext.ExtNormalize((0.485, 0.456, 0.406),
                                   (0.229, 0.224, 0.225)),
                  j_ext.ExtNormalize((0.485, 0.456, 0.406),
                                     (0.229, 0.224, 0.225))),
    "lambda": (ext.ExtLambda(lambda im: im[..., ::-1] * 0.5),
               j_ext.ExtLambda(lambda im: im[..., ::-1] * 0.5)),
    "crop_padding": (ext.ExtRandomCrop(32, padding=4, label_fill=7),
                     j_ext.ExtRandomCrop(32, padding=4, label_fill=7)),
    "crop_padding_if_needed": (
        ext.ExtRandomCrop((45, 60), padding=2, pad_if_needed=True),
        j_ext.ExtRandomCrop((45, 60), padding=2, pad_if_needed=True)),
    "hue": (ext.ExtColorJitter(hue=0.3), j_ext.ExtColorJitter(hue=0.3)),
    "jitter_all": (ext.ExtColorJitter(0.5, 0.5, 0.5, 0.5),
                   j_ext.ExtColorJitter(0.5, 0.5, 0.5, 0.5)),
    "jitter_ranges": (ext.ExtColorJitter((0.8, 1.1), 0.2, (0.5, 1.5),
                                         (-0.1, 0.4)),
                      j_ext.ExtColorJitter((0.8, 1.1), 0.2, (0.5, 1.5),
                                           (-0.1, 0.4))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_transform_matches_afan(name):
    port, afan = CASES[name]
    for seed in range(12):
        img, lbl = pair(seed, 30 + 3 * seed, 60 - 2 * seed)
        same_call(port, afan, seed, img, lbl)


def test_to_tensor_on_uint8_and_unnormalized():
    img = (pair(0)[0] * 255).astype(np.uint8)
    lbl = pair(0)[1].astype(np.int64)
    for normalize in (True, False):
        same_call(ext.ExtToTensor(normalize), j_ext.ExtToTensor(normalize), 0,
                  img, lbl)


def test_pipeline_of_every_transform_matches_afan():
    names = ("vflip", "rotation", "scale", "pad", "center_crop",
             "crop_padding_if_needed", "jitter_all", "resize_short",
             "normalize")
    port = ext.ExtCompose([CASES[n][0] for n in names])
    afan = j_ext.ExtCompose([CASES[n][1] for n in names])
    for seed in range(6):
        same_call(port, afan, seed, *pair(seed, 41, 57))


def pil_rotate(arr, angle, resample, expand, fill):
    mode = "I" if arr.dtype == np.int32 else None
    return np.asarray(Image.fromarray(arr, mode=mode).rotate(
        angle, resample, expand=expand, fillcolor=fill))


ANGLES = (0.0, 90.0, 180.0, 270.0, 360.0, -90.0, -180.0, 450.0, 45.0,
          -30.5, 1e-14, 180.0 + 1e-13, 89.99999, 0.3)


@pytest.mark.parametrize("hw", [(23, 23), (17, 41), (40, 9), (1, 1), (2, 7)])
@pytest.mark.parametrize("expand", [False, True])
def test_rotate_matches_pillow(hw, expand):
    rng = np.random.RandomState(hw[0] * 100 + hw[1])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    lbl = rng.randint(0, 30, hw).astype(np.int32)
    angles = ANGLES + tuple(rng.uniform(-400, 400, 25))
    for angle in angles:
        got = ext.rotate_pil(img, angle, True, expand, 0)
        np.testing.assert_array_equal(
            got, pil_rotate(img, angle, Image.BILINEAR, expand, 0),
            err_msg=f"image at {angle}")
        got = ext.rotate_pil(lbl, angle, False, expand, 255)
        np.testing.assert_array_equal(
            got, pil_rotate(lbl, angle, Image.NEAREST, expand, 255),
            err_msg=f"label at {angle}")
        assert ext.rotated_size(hw, angle, expand) == got.shape


def test_rotate_past_the_fixed_point_range_matches_pillow():
    """A label 40000 pixels wide: Pillow's nearest walks in float64."""
    rng = np.random.RandomState(7)
    lbl = rng.randint(0, 30, (2, 40000)).astype(np.int32)
    for angle in (0.001, -0.0004, 179.9993):
        np.testing.assert_array_equal(
            ext.rotate_pil(lbl, angle, False, False, 255),
            pil_rotate(lbl, angle, Image.NEAREST, False, 255))
