"""The port's test files compare ``seg_data.cv2_resize_linear`` with cv2
through ``assert_opencv_linear``.

``cv2_resize_linear`` copies OpenCV's AVX2 code, which fuses each
multiply-add (``seg_data._fma32``). A cv2 that takes its plain path rounds
twice instead (ids 11 and 12 are CV_CPU_AVX2 and CV_CPU_FMA3).
"""
import cv2
import numpy as np

OPENCV_FMA = (cv2.useOptimized() and cv2.checkHardwareSupport(11)
              and cv2.checkHardwareSupport(12))


def assert_opencv_linear(got, want):
    """``got`` equals cv2's bilinear resize ``want`` bit for bit where cv2
    takes its AVX2 path, the one the port copies; elsewhere the two may
    differ by one rounding in each pass, 2 float32 ulps below 1."""
    assert got.dtype == want.dtype == np.float32
    if OPENCV_FMA:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0 ** -23)
