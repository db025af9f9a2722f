"""Host-side image preprocessing of the InternVL2.5 family, the
counterpart of ``x2i_tpu/data/vision.py`` (numpy on the host): a bicubic
resize to 448-pixel tiles, ImageNet normalization, and the aspect-ratio
tiling of InternVL (up to 12 tiles and an optional thumbnail). X2I first
resizes every input image to 128 x 128, which makes the tiling one tile.
The tiles are NHWC float32, as the JAX package gives them.

PIL is imported inside the functions that resize: the machine with the
card need not have it. There the encoder takes the host half's output
instead of an image (``image_tiles``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def to_imagenet_tensor(image, input_size: int = 448) -> np.ndarray:
    """PIL image -> (H, W, 3) f32, bicubic-resized + ImageNet-normalized."""
    from PIL import Image
    if image.mode != "RGB":
        image = image.convert("RGB")
    image = image.resize((input_size, input_size), Image.BICUBIC)
    arr = np.asarray(image, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def find_closest_aspect_ratio(aspect_ratio: float, target_ratios,
                              width: int, height: int,
                              image_size: int) -> Tuple[int, int]:
    """The grid of ``target_ratios`` whose aspect ratio is nearest; on a
    tie the later one when the image covers more than half its area."""
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target_ar = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target_ar)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def dynamic_tiles(image, min_num: int = 1, max_num: int = 12,
                  image_size: int = 448,
                  use_thumbnail: bool = False) -> List:
    """InternVL's tiling: the grid (i, j) with i * j in [min_num,
    max_num] nearest the image's aspect ratio, the image resized to it and
    cut into tiles, then a thumbnail if asked and there is more than one
    tile."""
    ow, oh = image.size
    aspect = ow / oh
    ratios = sorted({(i, j)
                     for n in range(min_num, max_num + 1)
                     for i in range(1, n + 1) for j in range(1, n + 1)
                     if min_num <= i * j <= max_num},
                    key=lambda x: x[0] * x[1])
    gi, gj = find_closest_aspect_ratio(aspect, ratios, ow, oh, image_size)
    tw, th = image_size * gi, image_size * gj
    resized = image.resize((tw, th))
    tiles = []
    for k in range(gi * gj):
        box = ((k % gi) * image_size, (k // gi) * image_size,
               ((k % gi) + 1) * image_size, ((k // gi) + 1) * image_size)
        tiles.append(resized.crop(box))
    if use_thumbnail and len(tiles) != 1:
        tiles.append(image.resize((image_size, image_size)))
    return tiles


def load_image_tiles(image, input_size: int = 448, max_num: int = 12,
                     pre_resize: int = 128) -> np.ndarray:
    """X2I's inference path: resize to 128 x 128, tile (one tile),
    normalize -> (T, input_size, input_size, 3) f32."""
    if pre_resize:
        image = image.resize((pre_resize, pre_resize))
    tiles = dynamic_tiles(image, max_num=max_num, image_size=input_size)
    return np.stack([to_imagenet_tensor(t, input_size) for t in tiles])


def image_tiles(image, input_size: int = 448) -> np.ndarray:
    """The tiles of one request image: ``load_image_tiles`` of a PIL
    image, or the image itself when it is already the host half's output,
    a (T, input_size, input_size, 3) float32 array."""
    if isinstance(image, np.ndarray):
        if (image.dtype != np.float32 or image.ndim != 4
                or image.shape[1:] != (input_size, input_size, 3)):
            raise ValueError(f"an image given as an array is its tiles, "
                             f"(T, {input_size}, {input_size}, 3) float32; "
                             f"got {image.dtype} {image.shape}")
        return image
    return load_image_tiles(image, input_size=input_size)
