"""The port's host halves (x2i_torch/data/vision.py, qwen_vision.py and
video.py) against the JAX package's, for equality: the same PIL images
and the same arrays in, the same arrays out, bit for bit (pixels) or
exactly (the integer logic: tiling, smart_resize, rope positions, window
permutation, segment ids, 3-D positions, frame sampling). Inputs are
drawn from numpy seeds."""

import shutil

import numpy as np
import pytest
from PIL import Image

from x2i_tpu.data import qwen_vision as jqv
from x2i_tpu.data import video as jvid
from x2i_tpu.data import vision as jvis
from x2i_torch.data import qwen_vision as tqv
from x2i_torch.data import video as tvid
from x2i_torch.data import vision as tvis

IMG, VID, START = 151655, 151656, 151652


def pil(rng, w, h, mode="RGB"):
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
    return img.convert(mode) if mode != "RGB" else img


def assert_same(a, b):
    """Equal arrays (or nested tuples and dicts of them), dtypes too."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ InternVL

SIZES = [(128, 128), (300, 100), (97, 411), (640, 480), (33, 34)]


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_to_imagenet_tensor_is_jaxs(mode):
    img = pil(np.random.default_rng(0), 150, 90, mode)
    for size in (448, 28):
        assert_same(tvis.to_imagenet_tensor(img, size),
                    jvis.to_imagenet_tensor(img, size))


def test_find_closest_aspect_ratio_is_jaxs():
    ratios = sorted({(i, j) for n in range(1, 13) for i in range(1, n + 1)
                     for j in range(1, n + 1) if i * j <= 12},
                    key=lambda x: x[0] * x[1])
    rng = np.random.default_rng(1)
    for w, h in [*SIZES, *rng.integers(1, 2000, (200, 2))]:
        args = (w / h, ratios, int(w), int(h), 448)
        assert (tvis.find_closest_aspect_ratio(*args)
                == jvis.find_closest_aspect_ratio(*args))


@pytest.mark.parametrize("thumbnail", [False, True])
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_dynamic_tiles_are_jaxs(size, thumbnail):
    img = pil(np.random.default_rng(2), *size)
    got = tvis.dynamic_tiles(img, max_num=6, image_size=28,
                             use_thumbnail=thumbnail)
    want = jvis.dynamic_tiles(img, max_num=6, image_size=28,
                              use_thumbnail=thumbnail)
    assert_same([np.asarray(t) for t in got], [np.asarray(t) for t in want])


@pytest.mark.parametrize("size", SIZES, ids=str)
def test_load_image_tiles_is_jaxs(size):
    """X2I's path (128^2 first: one 448 tile) and the tiling without
    it."""
    img = pil(np.random.default_rng(3), *size)
    assert_same(tvis.load_image_tiles(img, input_size=56),
                jvis.load_image_tiles(img, input_size=56))
    assert_same(tvis.load_image_tiles(img, 28, max_num=4, pre_resize=0),
                jvis.load_image_tiles(img, 28, max_num=4, pre_resize=0))
    assert tvis.load_image_tiles(img).shape == (1, 448, 448, 3)


def test_image_tiles_takes_a_pil_image_or_its_tiles():
    img = pil(np.random.default_rng(4), 64, 48)
    tiles = jvis.load_image_tiles(img, input_size=28)
    assert_same(tvis.image_tiles(img, 28), tiles)
    assert tvis.image_tiles(tiles, 28) is tiles
    for bad in (tiles.astype(np.float64), tiles[0], tiles[:, :14]):
        with pytest.raises(ValueError, match="float32"):
            tvis.image_tiles(bad, 28)


# ---------------------------------------------------------- Qwen2.5-VL

def test_smart_resize_is_jaxs():
    rng = np.random.default_rng(5)
    for h, w in [(128, 128), (1, 199), (10, 10), (4000, 30),
                 *rng.integers(1, 3000, (300, 2))]:
        for factor, mx in ((28, 128 * 128), (8, 56 * 56 * 4)):
            try:
                want = jqv.smart_resize(int(h), int(w), factor,
                                        max_pixels=mx)
            except ValueError:
                with pytest.raises(ValueError, match="aspect"):
                    tqv.smart_resize(int(h), int(w), factor, max_pixels=mx)
                continue
            assert tqv.smart_resize(int(h), int(w), factor,
                                    max_pixels=mx) == want


@pytest.mark.parametrize("frames", [0, 1, 3, 4],
                         ids=["image", "1 frame", "3 frames", "4 frames"])
def test_preprocess_image_is_jaxs(frames):
    """An image, or frames of which an odd count repeats the last; the
    host half's own pair comes back as it is."""
    rng = np.random.default_rng(6)
    medium = (pil(rng, 90, 60) if not frames
              else [pil(rng, 70, 50) for _ in range(frames)])
    got = tqv.preprocess_image(medium, patch_size=4)
    want = jqv.preprocess_image(medium, patch_size=4)
    assert_same(got, want)
    assert tqv.preprocess_image(got)[0] is got[0]
    assert tqv.is_preprocessed(got) and not tqv.is_preprocessed(medium)


GRIDS = [[(1, 4, 6)], [(1, 8, 8), (2, 4, 10)], [(3, 6, 4), (1, 2, 2),
                                                  (1, 10, 14)]]


@pytest.mark.parametrize("grids", GRIDS, ids=str)
def test_rot_pos_ids_and_window_index_are_jaxs(grids):
    assert_same(tqv.rot_pos_ids(grids), jqv.rot_pos_ids(grids))
    for ws, ps in ((112, 14), (16, 4), (8, 4)):
        assert_same(tqv.window_index(grids, ws, ps),
                    jqv.window_index(grids, ws, ps))


def _media(seed):
    rng = np.random.default_rng(seed)
    images = [pil(rng, 90, 60), pil(rng, 40, 40)]
    video = [pil(rng, 64, 48) for _ in range(3)]
    return images, video


@pytest.mark.parametrize("what", ["images", "video", "both", "nothing"])
def test_prepare_vision_inputs_is_jaxs(what):
    images, video = _media(7)
    args = (images if what in ("images", "both") else None,
            [video] if what in ("video", "both") else None)
    kw = dict(patch_size=4, window_size=16)
    got = tqv.prepare_vision_inputs(*args, **kw)
    want = jqv.prepare_vision_inputs(*args, **kw)
    if what == "nothing":
        assert got is None and want is None
        return
    assert_same(got, want)
    # the same from the host half's pairs (the route without PIL)
    pairs = ([tqv.preprocess_image(im, patch_size=4) for im in args[0]]
             if args[0] else None,
             [tqv.preprocess_image(args[1][0], patch_size=4)]
             if args[1] else None)
    assert_same(tqv.prepare_vision_inputs(*pairs, **kw), want)


def test_concat_vision_inputs_is_jaxs():
    images, video = _media(8)
    kw = dict(patch_size=4, window_size=16)
    vins = [jqv.prepare_vision_inputs(images, [video], **kw), None,
            jqv.prepare_vision_inputs(images[1:], **kw),
            jqv.prepare_vision_inputs(None, [video[:2]], **kw)]
    assert_same(tqv.concat_vision_inputs(vins),
                jqv.concat_vision_inputs(vins))
    assert tqv.concat_vision_inputs([None, None]) is None


def _prompt(rng, media, s, left_pad=0):
    """ids (s,) and mask: text, then per medium (kind, grid) the vision
    start token and its merged pad run, then text; right-padded, or
    left-padded by ``left_pad``."""
    toks = list(rng.integers(0, 1000, 4))
    for kind, (t, h, w) in media:
        toks += [START] + [IMG if kind == "image" else VID] * (
            t * h * w // 4) + [151653] + list(rng.integers(0, 1000, 2))
    assert len(toks) + left_pad <= s
    ids = np.zeros(s, np.int64)
    mask = np.zeros(s, np.int64)
    ids[left_pad:left_pad + len(toks)] = toks
    mask[left_pad:left_pad + len(toks)] = 1
    return ids, mask


@pytest.mark.parametrize("case", ["images", "videos", "both", "text",
                                  "left-padded", "seconds per grid"])
def test_get_rope_index_is_jaxs(case):
    """A batch of two rows: images, videos, a video between two images,
    no media, left padding, and videos with their seconds per grid."""
    rng = np.random.default_rng(9)
    img = [("image", (1, 4, 6)), ("image", (1, 8, 8))]
    vid = [("video", (2, 4, 4)), ("video", (3, 6, 4))]
    rows = {"images": (img, img[1:]), "videos": (vid, vid[:1]),
            "both": (img[:1] + vid[:1] + img[1:], vid[1:]),
            "text": ([], []), "left-padded": (img, vid),
            "seconds per grid": (vid[1:], vid)}[case]
    pads = (5, 11) if case == "left-padded" else (0, 0)
    built = [_prompt(rng, m, 96, p) for m, p in zip(rows, pads)]
    ids = np.stack([b[0] for b in built])
    mask = np.stack([b[1] for b in built])
    flat = [g for m in rows for g in m]
    image_grid = np.array([g for k, g in flat if k == "image"],
                          np.int64).reshape(-1, 3)
    video_grid = np.array([g for k, g in flat if k == "video"],
                          np.int64).reshape(-1, 3)
    spg = [0.5, 2.0, 1.5] if case == "seconds per grid" else None
    args = (ids, image_grid, video_grid, mask)
    got = tqv.get_rope_index(*args, second_per_grid_ts=spg)
    want = jqv.get_rope_index(*args, second_per_grid_ts=spg)
    assert_same(got, want)


# --------------------------------------------------------------- video

def test_uniform_sample_indices_is_jaxs():
    for frames in (0, 1, 23, 24, 250, 1600, 5000):
        for fps in (1.0, 12.0, 24.0, 29.97, 60.0):
            for mx in (8, 64):
                args = (frames, fps, 1.0, mx)
                assert (tvid.uniform_sample_indices(*args)
                        == jvid.uniform_sample_indices(*args))


def test_load_video_frames_is_jaxs(tmp_path):
    """Frames given as PIL images, as a uint8 array and as an animated
    GIF file: the same frames picked; a still image raises in both."""
    rng = np.random.default_rng(10)
    arr = rng.integers(0, 256, (30, 16, 24, 3), np.uint8)
    frames = [Image.fromarray(a) for a in arr]
    for given in (frames, arr):
        got = tvid.load_video_frames(given, max_frames=8, assumed_fps=6.0)
        want = jvid.load_video_frames(given, max_frames=8, assumed_fps=6.0)
        assert_same([np.asarray(f) for f in got],
                    [np.asarray(f) for f in want])
    gif = str(tmp_path / "clip.gif")
    frames[0].save(gif, save_all=True, append_images=frames[1:12],
                   duration=100)
    got = tvid.load_video_frames(gif, max_frames=4)
    want = jvid.load_video_frames(gif, max_frames=4)
    assert len(got) == len(want) > 0
    assert_same([np.asarray(f) for f in got], [np.asarray(f) for f in want])
    still = str(tmp_path / "still.png")
    frames[0].save(still)
    if shutil.which("ffmpeg") is None:
        for load in (tvid.load_video_frames, jvid.load_video_frames):
            with pytest.raises(ValueError, match="cannot decode"):
                load(still)
    else:
        assert_same([np.asarray(f) for f in tvid.load_video_frames(still)],
                    [np.asarray(f) for f in jvid.load_video_frames(still)])
