"""ctypes wrapper of the native image core (``csrc/host/imagecore.cpp``,
built at first use by ``ops/_build_host.py``; the port's counterpart of the
JAX package's ``vault_tpu/data/native_image.py``).

The core reimplements Pillow's fixed-point bicubic resample bit for bit and
fuses the ``(x/255 - mean)/std`` normalize and the HWC->CHW transpose.
``data/image.py`` routes every uint8 RGB image it resizes on the host here;
other inputs keep their path.  A library that does not build or load
raises."""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from vault_tpu_torch.ops import _build_host

_SIGNATURES = {
    "ic_resize_rgb8": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int], None),
    "ic_resize_normalize": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_float, ctypes.c_float], None),
    "ic_normalize_chw": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float],
                         None),
}


def library() -> ctypes.CDLL:
    return _build_host.load("imagecore", _SIGNATURES)


def _rgb8(image: np.ndarray) -> np.ndarray:
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"the native resize takes uint8 (H, W, 3) images, got "
                         f"{image.dtype} {image.shape}")
    return np.ascontiguousarray(image)


def resize_rgb8_native(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (oh, ow, 3), bit-equal to PIL's BICUBIC."""
    img = _rgb8(image)
    out = np.empty((*out_hw, 3), np.uint8)
    library().ic_resize_rgb8(img.ctypes.data, img.shape[0], img.shape[1],
                             out.ctypes.data, out_hw[0], out_hw[1])
    return out


def resize_normalize_native(image: np.ndarray, out_hw: Tuple[int, int],
                            mean: float, std: float) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (3, oh, ow): PIL's BICUBIC resize, then
    ``(x/255 - mean)/std``."""
    img = _rgb8(image)
    out = np.empty((3, *out_hw), np.float32)
    library().ic_resize_normalize(img.ctypes.data, img.shape[0], img.shape[1],
                                  out_hw[0], out_hw[1], out.ctypes.data,
                                  out_hw[0], out_hw[1],
                                  ctypes.c_float(mean), ctypes.c_float(std))
    return out
