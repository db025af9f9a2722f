"""The tasks with images and video end to end for the Qwen2.5-VL family
(``tests/ckpt_fixtures.py``'s directory): the cases, helpers and bars of
test_torch_tasks.py, which holds InternVL2.5's."""

import numpy as np
import pytest

import test_torch_tasks as tt
from test_torch_tasks import PX, STEPS, frames, pil
from test_torch_params import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    return tt.build_pipes(tmp_path_factory, "qwenvl")


@pytest.mark.parametrize("family,task", tt.cases("qwenvl"))
def test_task_matches_jax(pipes, family, task):
    tt.task_matches_jax(pipes, family, task)


def test_task_entry_points_make_images(pipes):
    port, _ = pipes["qwenvl"]
    kw = dict(height=PX, width=PX, num_steps=STEPS)
    for img in (port.image2image([pil(6)], **kw),
                port.imagetext2image("a cat", [pil(7)], **kw),
                port.video2image(frames(8, 2), **kw),
                port.x2image("a cat", [pil(9)], **kw)):
        assert img.shape == (1, PX, PX, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("family", ["qwenvl"])
def test_mixed_batch_matches_jax_and_serial(pipes, family):
    tt.mixed_batch_matches_jax_and_serial(pipes, family)


@pytest.mark.parametrize("family", ["qwenvl"])
def test_cut_image_tokens_send_the_batch_to_the_serial_path(pipes, family):
    tt.cut_image_tokens_send_the_batch_to_the_serial_path(pipes, family)
