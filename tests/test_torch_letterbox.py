"""The port's letterbox equals the JAX package's ``LetterBox`` (which
resizes with ``cv2.resize(INTER_LINEAR)``) pixel for pixel: resized,
up- and downscaled, and pad-only inputs.  Exact equality, no tolerance:
the port computes OpenCV's fixed-point arithmetic in integers."""

import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.data.augment import LetterBox as JaxLetterBox
from xlstm_yolo_tpu_torch.data.augment import LetterBox

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

SHAPES = [
    (720, 1280), (1000, 1500), (300, 200), (640, 641),  # the shapes of the bug report
    (120, 160), (50, 70), (213, 320),                    # upscales
    (1080, 1920), (1920, 640), (2000, 333),              # downscales
    (1280, 1920),                                        # exact 1/3 downscale
    (640, 480),                                          # pad only
]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_letterbox_equals_jax_pixel_for_pixel(shape):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    im = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    ref, ref_ratio, ref_pad = JaxLetterBox((640, 640))(im)
    out, ratio, pad = LetterBox((640, 640))(torch.from_numpy(im))
    assert (ratio, pad) == (ref_ratio, ref_pad)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_letterbox_small_target():
    rng = np.random.default_rng(5)
    for shape in ((37, 53), (101, 99), (300, 200)):
        im = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        np.testing.assert_array_equal(LetterBox((160, 160))(torch.from_numpy(im))[0].numpy(),
                                      JaxLetterBox((160, 160))(im)[0])
