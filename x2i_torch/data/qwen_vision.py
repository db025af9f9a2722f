"""Host-side Qwen2.5-VL vision preprocessing, the counterpart of
``x2i_tpu/data/qwen_vision.py`` (numpy on the host, equal to it array for
array).

It gives the arrays the vision tower reads (``models/qwen2_5_vl.py``):
the flattened pixel patches in merge-block order, window-permuted, with
their rope positions, their window and image segment ids and the reverse
permutation, and the 3-D M-RoPE positions of the prompt. It mirrors HF's
Qwen2VLImageProcessor patch layout and
Qwen2_5_VisionTransformerPretrainedModel.{rot_pos_emb,get_window_index}
and Qwen2_5_VLModel.get_rope_index, all of them host logic (loops over
token lists, data-dependent shapes).

X2I's operating points: images at most 128^2 pixels, video frames 128^2 at
1 fps. PIL is imported inside ``preprocess_image``, which resizes; a
request may give the host half's output of a medium instead, a pair
(flat patches, grid_thw), on a machine without PIL.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 128 * 128) -> Tuple[int, int]:
    """HF qwen2_vl smart_resize: round to multiples of `factor` within the
    pixel budget."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absurd aspect ratio")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def is_preprocessed(medium) -> bool:
    """Whether a request's image or video is already the host half's
    output: a pair (flat patches (S, C * tps * ps^2), grid_thw)."""
    return (isinstance(medium, tuple) and len(medium) == 2
            and isinstance(medium[0], np.ndarray) and medium[0].ndim == 2)


def preprocess_image(image, patch_size: int = 14, merge_size: int = 2,
                     temporal_patch_size: int = 2,
                     max_pixels: int = 128 * 128
                     ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """PIL image (or (T,H,W,3) uint8 frames) -> (flat_patches, grid_thw).

    Layout matches Qwen2VLImageProcessor: (t, h/m, w/m, m, m) blocks
    flattened to (S, C * tps * ps^2). A pair that ``is_preprocessed``
    comes back as it is.
    """
    if is_preprocessed(image):
        return image[0], tuple(int(x) for x in image[1])
    from PIL import Image as PILImage

    if hasattr(image, "size"):        # PIL image
        frames = [image]
    else:
        frames = list(image)
    w0, h0 = (frames[0].size if hasattr(frames[0], "size")
              else (frames[0].shape[1], frames[0].shape[0]))
    factor = patch_size * merge_size
    h, w = smart_resize(h0, w0, factor, max_pixels=max_pixels)

    arrs = []
    for f in frames:
        if not hasattr(f, "resize"):
            f = PILImage.fromarray(np.asarray(f))
        f = f.convert("RGB").resize((w, h), PILImage.BICUBIC)
        a = np.asarray(f, np.float32) / 255.0
        arrs.append((a - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD)
    patches = np.stack(arrs)                                 # (T, H, W, 3)
    if patches.shape[0] % temporal_patch_size != 0:
        reps = temporal_patch_size - (
            patches.shape[0] % temporal_patch_size)
        patches = np.concatenate(
            [patches, np.repeat(patches[-1:], reps, axis=0)], axis=0)
    t = patches.shape[0] // temporal_patch_size
    grid_h, grid_w = h // patch_size, w // patch_size

    x = patches.transpose(0, 3, 1, 2)                        # (T, C, H, W)
    x = x.reshape(t, temporal_patch_size, 3,
                  grid_h // merge_size, merge_size, patch_size,
                  grid_w // merge_size, merge_size, patch_size)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = x.reshape(t * grid_h * grid_w,
                     3 * temporal_patch_size * patch_size * patch_size)
    return flat.astype(np.float32), (t, grid_h, grid_w)


def rot_pos_ids(grid_thw: Sequence[Tuple[int, int, int]],
                merge_size: int = 2) -> np.ndarray:
    """(S, 2) per-patch (h, w) rope positions in merge-block order
    (HF rot_pos_emb)."""
    out = []
    for t, h, w in grid_thw:
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hpos = hpos.reshape(h // merge_size, merge_size,
                            w // merge_size, merge_size)
        hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wpos = wpos.reshape(h // merge_size, merge_size,
                            w // merge_size, merge_size)
        wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
        out.append(np.tile(np.stack([hpos, wpos], -1), (t, 1)))
    return np.concatenate(out, axis=0)


def window_index(grid_thw: Sequence[Tuple[int, int, int]],
                 window_size: int = 112, patch_size: int = 14,
                 merge_size: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """(window_index (S/m^2,), window_seg (S,)) — merge-unit permutation
    grouping units into windows, and the per-token window segment id
    (HF get_window_index; cu_seqlens expressed as segment ids)."""
    vit_ws = window_size // merge_size // patch_size
    unit = merge_size * merge_size
    indices, seg_lens = [], []
    base = 0
    for t, h, w in grid_thw:
        lh, lw = h // merge_size, w // merge_size
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = (-lh) % vit_ws
        pad_w = (-lw) % vit_ws
        padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
        padded[:, :lh, :lw] = idx
        nh, nw = (lh + pad_h) // vit_ws, (lw + pad_w) // vit_ws
        padded = padded.reshape(t, nh, vit_ws, nw, vit_ws)
        padded = padded.transpose(0, 1, 3, 2, 4).reshape(
            t, nh * nw, vit_ws, vit_ws)
        lens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        keep = flat[flat != -100]
        indices.append(keep + base)
        seg_lens.extend(int(l) * unit for l in lens if l > 0)
        base += t * lh * lw
    win_index = np.concatenate(indices)
    window_seg = np.repeat(np.arange(len(seg_lens)), seg_lens)
    return win_index, window_seg


def prepare_vision_inputs(images=None, videos=None,
                          max_pixels: int = 128 * 128,
                          video_max_pixels: int = 128 * 128,
                          patch_size: int = 14, merge_size: int = 2,
                          temporal_patch_size: int = 2,
                          window_size: int = 112) -> Optional[Dict]:
    """-> dict for Qwen2_5_VLEncoder vision_inputs + grid_thw lists."""
    flats, grids = [], []
    for im in images or []:
        f, g = preprocess_image(im, patch_size, merge_size,
                                temporal_patch_size, max_pixels)
        flats.append(f)
        grids.append(g)
    video_grids = []
    if videos is not None:
        for frames in videos:
            f, g = preprocess_image(frames, patch_size, merge_size,
                                    temporal_patch_size, video_max_pixels)
            flats.append(f)
            video_grids.append(g)
    if not flats:
        return None
    patches = np.concatenate(flats, axis=0)
    all_grids = grids + video_grids
    pos = rot_pos_ids(all_grids, merge_size)
    win_idx, window_seg = window_index(all_grids, window_size, patch_size,
                                       merge_size)
    unit = merge_size * merge_size
    # token-level permutation from merge-unit permutation
    tok_perm = (win_idx[:, None] * unit + np.arange(unit)[None]).reshape(-1)
    image_seg_units = np.concatenate([
        np.full(t * (h // merge_size) * (w // merge_size), i)
        for i, (t, h, w) in enumerate(all_grids)])
    image_seg = np.repeat(image_seg_units[win_idx], unit)

    return {
        "patches": patches[tok_perm],
        "pos_hw": pos[tok_perm],
        "window_seg": window_seg,
        "image_seg": image_seg,
        "reverse_index": np.argsort(win_idx),
        "image_grid_thw": np.asarray(grids, np.int64).reshape(-1, 3),
        "video_grid_thw": np.asarray(video_grids, np.int64).reshape(-1, 3),
    }


def concat_vision_inputs(vins: Sequence[Optional[Dict]]) -> Optional[Dict]:
    """Merge per-request prepare_vision_inputs dicts into ONE vision-tower
    call, preserving REQUEST order.

    Needed for batched serving with mixed media: a single global
    prepare_vision_inputs(all_images, all_videos) call would emit every
    image before every video, while embed_multimodal's flat cumsum scatter
    consumes features strictly in row-major pad-token order (request 0's
    media, then request 1's...). All the per-grid machinery (rope
    positions, window segmentation) is independent across grids, so the
    merge is pure bookkeeping: window/image segment ids shift by the
    segments seen so far, reverse_index rows by the merge-unit count."""
    vins = [v for v in vins if v is not None]
    if not vins:
        return None
    segs, imsegs, revs = [], [], []
    seg0 = im0 = unit0 = 0
    for v in vins:
        segs.append(v["window_seg"] + seg0)
        imsegs.append(v["image_seg"] + im0)
        revs.append(v["reverse_index"] + unit0)
        seg0 += int(v["window_seg"][-1]) + 1     # window_seg is sorted
        im0 += len(v["image_grid_thw"]) + len(v["video_grid_thw"])
        unit0 += len(v["reverse_index"])
    return {
        "patches": np.concatenate([v["patches"] for v in vins], axis=0),
        "pos_hw": np.concatenate([v["pos_hw"] for v in vins], axis=0),
        "window_seg": np.concatenate(segs),
        "image_seg": np.concatenate(imsegs),
        "reverse_index": np.concatenate(revs),
        "image_grid_thw": np.concatenate(
            [v["image_grid_thw"] for v in vins], axis=0),
        "video_grid_thw": np.concatenate(
            [v["video_grid_thw"] for v in vins], axis=0),
    }


def get_rope_index(input_ids: np.ndarray,
                   image_grid_thw: Optional[np.ndarray] = None,
                   video_grid_thw: Optional[np.ndarray] = None,
                   attention_mask: Optional[np.ndarray] = None,
                   spatial_merge_size: int = 2,
                   image_token_id: int = 151655,
                   video_token_id: int = 151656,
                   vision_start_token_id: int = 151652,
                   tokens_per_second: int = 2,
                   second_per_grid_ts: Optional[Sequence[float]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy mirror of Qwen2_5_VLModel.get_rope_index: 3D (t, h, w)
    position ids per token. Returns (position_ids (3, B, S), deltas (B,))."""
    bsz, seqlen = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    has_vision = ((image_grid_thw is not None and len(image_grid_thw))
                  or (video_grid_thw is not None and len(video_grid_thw)))
    if not has_vision:
        pos = np.cumsum(attention_mask, axis=-1) - 1
        pos[attention_mask == 0] = 1
        pos = np.broadcast_to(pos[None], (3, bsz, seqlen)).copy()
        deltas = pos.max(axis=(0, 2)) + 1 - attention_mask.sum(-1)
        return pos, deltas

    position_ids = np.ones((3, bsz, seqlen), np.int64)
    deltas = np.zeros((bsz,), np.int64)
    img_i = vid_i = 0
    for b in range(bsz):
        ids = input_ids[b][attention_mask[b] == 1]
        toks = ids.tolist()
        starts = np.where(ids == vision_start_token_id)[0]
        vis_tokens = ids[starts + 1] if len(starts) else np.array([])
        n_img = int((vis_tokens == image_token_id).sum())
        n_vid = int((vis_tokens == video_token_id).sum())
        pos_list = []
        st = 0
        rem_img, rem_vid = n_img, n_vid
        for _ in range(n_img + n_vid):
            ed_img = (toks.index(image_token_id, st)
                      if image_token_id in toks[st:] and rem_img else
                      len(toks) + 1)
            ed_vid = (toks.index(video_token_id, st)
                      if video_token_id in toks[st:] and rem_vid else
                      len(toks) + 1)
            if ed_img < ed_vid:
                t, h, w = image_grid_thw[img_i]
                spg = 0.0
                img_i += 1
                rem_img -= 1
                ed = ed_img
            else:
                t, h, w = video_grid_thw[vid_i]
                spg = (second_per_grid_ts[vid_i]
                       if second_per_grid_ts is not None else 1.0)
                vid_i += 1
                rem_vid -= 1
                ed = ed_vid
            lh, lw = h // spatial_merge_size, w // spatial_merge_size
            text_len = ed - st
            st_idx = (pos_list[-1].max() + 1) if pos_list else 0
            if text_len:
                pos_list.append(
                    np.tile(np.arange(text_len) + st_idx, (3, 1)))
                st_idx += text_len
            t_idx = (np.broadcast_to(
                np.arange(t)[:, None], (t, lh * lw)).reshape(-1)
                * spg * tokens_per_second).astype(np.int64)
            h_idx = np.tile(np.repeat(np.arange(lh), lw), t)
            w_idx = np.tile(np.tile(np.arange(lw), lh), t)
            pos_list.append(np.stack([t_idx, h_idx, w_idx]) + st_idx)
            st = ed + t * lh * lw
        if st < len(toks):
            st_idx = (pos_list[-1].max() + 1) if pos_list else 0
            text_len = len(toks) - st
            pos_list.append(np.tile(np.arange(text_len) + st_idx, (3, 1)))
        pos = np.concatenate(pos_list, axis=1)
        position_ids[:, b, attention_mask[b] == 1] = pos
        deltas[b] = pos.max() + 1 - len(toks)
    return position_ids, deltas
