"""The tasks with images, video and audio end to end for MiniCPM-o
(SigLIP at 56^2 slices, the resampler, Whisper), its entry points with
audio, its batch path and its media: the cases, helpers and bars of
test_torch_tasks.py, which holds InternVL2.5's."""

import numpy as np
import pytest
import torch

import test_torch_tasks as tt
from test_torch_tasks import PX, STEPS, frames, pil, wave
from test_torch_params import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    return tt.build_pipes(tmp_path_factory, "minicpm")


@pytest.mark.parametrize("family,task", tt.cases("minicpm"))
def test_task_matches_jax(pipes, family, task):
    tt.task_matches_jax(pipes, family, task)


def test_task_entry_points_make_images(pipes):
    port, _ = pipes["minicpm"]
    kw = dict(height=PX, width=PX, num_steps=STEPS)
    for img in (port.audio2image(wave(8, 1.0), **kw),
                port.x2image("a cat", [pil(9)], wave(9, 1.0), **kw)):
        assert img.shape == (1, PX, PX, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("family", ["minicpm"])
def test_mixed_batch_matches_jax_and_serial(pipes, family):
    tt.mixed_batch_matches_jax_and_serial(pipes, family)


@pytest.mark.parametrize("family", ["minicpm"])
def test_cut_image_tokens_send_the_batch_to_the_serial_path(pipes, family):
    tt.cut_image_tokens_send_the_batch_to_the_serial_path(pipes, family)


def test_minicpm_media_name_the_roadmap_item(pipes):
    """The MiniCPM-o media that the port refused before its encoders were
    ported (ROADMAP.md Queue A item 4.3, done) are taken: an image, video
    frames and audio each give a stack of the text request's shape that
    is not the text request's."""
    port, _ = pipes["minicpm"]
    text = port.encoder_fn({"prompt": "x"})
    for media in ({"images": [pil(50)]}, {"video": frames(51, 2)},
                  {"audio": wave(52, 1.0)}):
        got = port.encoder_fn({"prompt": "x", **media})
        assert got.shape == text.shape and not torch.equal(got, text)
