"""Image pipeline: ViltProcessor-equivalent crop/resize/normalize/pad (port
of the JAX package's ``vault_tpu/data/image.py``).

  * HF ``ViltImageProcessor``: shortest-edge resize to 384 with the longer
    side capped at 384*1333/800, both floored to multiples of 32; rescale
    1/255; normalize mean=std=0.5.
  * ``safe_dict_concat`` collation: zero-pad images to a canvas and emit a
    pixel_mask (vault/vl_utils/dataset_utils.py:7-36).

Geometry is numpy.  On the host a uint8 RGB image resizes through the
native core (``data/native_image.py``, ``csrc/host/imagecore.cpp``), PIL's
fixed-point bicubic bit for bit with the normalize fused, as the JAX
package resizes it.  Other inputs, and every image resized on the card
(where a serving batch's images resize in a fraction of the host's time),
take ``F.interpolate(mode="bicubic", antialias=True)``, PyTorch's PIL-style
antialiased bicubic, in PIL's order (width pass, uint8 levels, height
pass, uint8 levels) before normalizing: within one uint8 level of PIL's
(tests/test_torch_serving.py, tests/test_torch_cuda.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SHORTER = 384
LONGER = int(1333 / 800 * 384)  # 639
SIZE_DIVISOR = 32
IMAGE_MEAN = 0.5
IMAGE_STD = 0.5
DEFAULT_CANVAS = "auto"

# Reference safe-preprocess threshold (vault/models/vault/utils.py:38): crop
# when aspect ratio exceeds (384/32)*(1333/800) so the /32 floor can't zero a
# patch-grid side.
MAX_ASPECT_RATIO = 384 / 32 * 1333 / 800


def target_size(height: int, width: int, shorter: int = SHORTER,
                longer: int = LONGER, divisor: int = SIZE_DIVISOR) -> Tuple[int, int]:
    """HF get_resize_output_image_size semantics (image_processing_vilt.py:92-120)."""
    scale = shorter / min(height, width)
    if height < width:
        nh, nw = shorter, scale * width
    else:
        nh, nw = scale * height, shorter
    if max(nh, nw) > longer:
        s = longer / max(nh, nw)
        nh, nw = s * nh, s * nw
    nh, nw = int(nh + 0.5), int(nw + 0.5)
    return (nh // divisor) * divisor, (nw // divisor) * divisor


def safe_aspect_crop(image: np.ndarray) -> np.ndarray:
    """Center-crop the larger side when the aspect ratio exceeds
    MAX_ASPECT_RATIO — the reference's ``vilt_safe_image_preprocess``
    (vault/models/vault/utils.py:17-48).  image: (H, W, C) array.  Offsets
    use torchvision CenterCrop's int(round(diff / 2.0))."""
    h, w = image.shape[:2]
    if max(w / h, h / w) <= MAX_ASPECT_RATIO:
        return image
    if h > w:
        new_h = int(w * MAX_ASPECT_RATIO)
        top = int(round((h - new_h) / 2.0))
        return image[top:top + new_h]
    new_w = int(h * MAX_ASPECT_RATIO)
    left = int(round((w - new_w) / 2.0))
    return image[:, left:left + new_w]


def relative_random_crop(rng: np.random.Generator, image: np.ndarray,
                         ratio: float = 0.9) -> np.ndarray:
    """Random crop to ``ratio`` of each side — train-time augmentation
    (vault/models/vault/utils.py:51-57)."""
    h, w = image.shape[:2]
    ch, cw = int(ratio * h), int(ratio * w)
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    return image[top:top + ch, left:left + cw]


def crop_stage(image: np.ndarray, safe: bool = True,
               augment_rng: Optional[np.random.Generator] = None,
               crop_ratio: float = 0.9) -> np.ndarray:
    """[safe-crop] -> [random-crop].  Consumes the augment rng, so callers
    batching images run this stage serially (the stream stays
    deterministic); the crops are view slices, so that costs nothing."""
    image = np.asarray(image)
    if safe:
        image = safe_aspect_crop(image)
    if augment_rng is not None:
        image = relative_random_crop(augment_rng, image, crop_ratio)
    return image


def rgba_to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 -> (H, W, 3) uint8, alpha-blended onto WHITE like
    skimage.color.rgba2rgb (the reference's conversion)."""
    rgb = img[..., :3].astype(np.float32) / 255.0
    a = img[..., 3:4].astype(np.float32) / 255.0
    out = rgb * a + (1.0 - a)  # white background
    return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)


def _to_rgb_hwc(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.tile(img, (1, 1, 3))
    elif img.shape[-1] == 4:
        img = rgba_to_rgb(img)
    return img


def _resize_levels(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bicubic resize of (1, C, H, W) uint8 levels held in fp32,
    rounded back to uint8 levels."""
    x = F.interpolate(x, size=tuple(out_hw), mode="bicubic", antialias=True,
                      align_corners=False)
    return x.round().clamp(0, 255)


def resize_normalize(image: np.ndarray, out_hw: Tuple[int, int],
                     mean: float = IMAGE_MEAN, std: float = IMAGE_STD,
                     device="cpu") -> torch.Tensor:
    """(H, W, C) uint8 -> (C, out_h, out_w) float32 normalized, on
    ``device``.  A uint8 image on the host: the native core, equal to PIL's
    ``Image.resize(..., BICUBIC)``.  Otherwise, like PIL, the width pass
    runs first and its result is stored as uint8 levels before the height
    pass; with that, the result is within one uint8 level of PIL's."""
    img = np.ascontiguousarray(_to_rgb_hwc(image))
    if img.dtype == np.uint8 and torch.device(device).type == "cpu":
        from vault_tpu_torch.data.native_image import resize_normalize_native

        return torch.from_numpy(resize_normalize_native(img, out_hw, mean, std))
    if not img.flags.writeable:  # e.g. decoded by PIL; torch wants writable
        img = img.copy()
    x = torch.from_numpy(img).to(device).permute(2, 0, 1)[None].float()
    x = _resize_levels(x, (x.shape[2], out_hw[1]))
    x = _resize_levels(x, out_hw)[0]
    return (x / 255.0 - mean) / std


def resize_stage(image: np.ndarray, shorter: int = SHORTER,
                 longer: Optional[int] = None,
                 max_hw: Optional[Tuple[int, int]] = None,
                 device="cpu") -> torch.Tensor:
    """target-size -> resize+normalize.  ``max_hw`` clamps
    aspect-preservingly: both sides scale by the same factor (then /32
    floor) when the natural target exceeds the canvas."""
    if longer is None:
        longer = int(1333 / 800 * shorter)
    h, w = np.asarray(image).shape[:2]
    th, tw = target_size(h, w, shorter, longer)
    if max_hw is not None and (th > max_hw[0] or tw > max_hw[1]):
        s = min(max_hw[0] / th, max_hw[1] / tw)
        th = max(SIZE_DIVISOR, int(th * s) // SIZE_DIVISOR * SIZE_DIVISOR)
        tw = max(SIZE_DIVISOR, int(tw * s) // SIZE_DIVISOR * SIZE_DIVISOR)
    return resize_normalize(np.asarray(image), (th, tw), device=device)


def preprocess_image(image: np.ndarray, safe: bool = True,
                     augment_rng: Optional[np.random.Generator] = None,
                     crop_ratio: float = 0.9, shorter: int = SHORTER,
                     longer: Optional[int] = None,
                     max_hw: Optional[Tuple[int, int]] = None,
                     device="cpu") -> torch.Tensor:
    """One image's whole path: [safe-crop] -> [random-crop] ->
    resize+normalize, (C, H, W) on ``device``."""
    cropped = crop_stage(image, safe, augment_rng, crop_ratio)
    return resize_stage(cropped, shorter, longer, max_hw, device=device)


def bucket_canvas_from_sizes(sizes: Sequence[Tuple[int, int]],
                             buckets: Tuple[int, ...] = (SHORTER, 608)
                             ) -> Tuple[int, int]:
    """Smallest bucketed canvas covering every (h, w) in ``sizes``."""
    max_h = max(h for h, _ in sizes)
    max_w = max(w for _, w in sizes)

    def up(v):
        for b in buckets:
            if v <= b:
                return b
        return v  # oversized (custom geometry) — use as-is

    return up(max_h), up(max_w)


def bucket_canvas(images: Sequence[np.ndarray],
                  buckets: Tuple[int, ...] = (SHORTER, 608)) -> Tuple[int, int]:
    """Smallest bucketed canvas covering every (C, H, W) image in the batch:
    each side rounds the batch max up to the next bucket, so at most four
    canvases exist ((384, 608) for landscape batches, (608, 384) portrait,
    (384, 384), (608, 608) mixed)."""
    return bucket_canvas_from_sizes([im.shape[1:] for im in images], buckets)


def canvas_key(height: int, width: int,
               buckets: Tuple[int, ...] = (SHORTER, 608),
               shorter: int = SHORTER,
               longer: int = LONGER) -> Tuple[int, int]:
    """The bucketed canvas a raw (height, width) image occupies after the
    safe crop and the resize: the grouping key of orientation-bucketed
    sampling (``loader.grouped_batch_indices``).  Batches homogeneous in
    this key land on their own canvas under :func:`bucket_canvas`."""
    if max(width / height, height / width) > MAX_ASPECT_RATIO:
        # safe_aspect_crop clamps the longer side first
        if height > width:
            height = int(width * MAX_ASPECT_RATIO)
        else:
            width = int(height * MAX_ASPECT_RATIO)
    th, tw = target_size(height, width, shorter, longer)
    return bucket_canvas_from_sizes([(th, tw)], buckets)


def pad_batch(images: Sequence[torch.Tensor],
              canvas: Optional[Tuple[int, int]] = None):
    """Collate (C, H_i, W_i) images: zero-pad to the batch max or to a fixed
    ``canvas``, on the images' device.  Returns (pixel_values (B,C,H,W)
    f32, pixel_mask (B,H,W) i32)."""
    if canvas is None:
        max_h = max(im.shape[1] for im in images)
        max_w = max(im.shape[2] for im in images)
    else:
        max_h, max_w = canvas
    b = len(images)
    c = images[0].shape[0]
    dev = images[0].device
    pixel_values = torch.zeros((b, c, max_h, max_w), dtype=torch.float32,
                               device=dev)
    pixel_mask = torch.zeros((b, max_h, max_w), dtype=torch.int32, device=dev)
    for i, im in enumerate(images):
        _, h, w = im.shape
        if h > max_h or w > max_w:
            raise ValueError(f"image {i} ({h}x{w}) exceeds canvas {max_h}x{max_w}")
        pixel_values[i, :, :h, :w] = im
        pixel_mask[i, :h, :w] = 1
    return pixel_values, pixel_mask
