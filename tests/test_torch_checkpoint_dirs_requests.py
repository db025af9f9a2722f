"""Requests beyond a text prompt on the checkpoint fixture directories of
test_torch_checkpoint_dirs.py (its builders and bars): media per family,
``use_answer`` and a two-turn chat session, the port's loaders against
the JAX package's."""

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_checkpoint_dirs import (PROMPTS, PX, STACK_BAR, STEPS,
                                        _tokenizer, build_dirs, pipe_cache)
from test_torch_params import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return build_dirs(tmp_path_factory)


@pytest.fixture(scope="module")
def pipes(dirs):
    return pipe_cache(dirs)


@pytest.mark.parametrize("family", ["qwenvl", "internvl", "minicpm"])
def test_media_are_refused(pipes, family):
    """No family refuses the media its JAX loader takes: MiniCPM-o takes
    images, video frames and audio, each request's stack the JAX loader's
    (tests/test_torch_tasks.py holds the tasks' images); the two families
    with a vision tower take images (tests/test_torch_tasks.py holds them
    against JAX) and, as in JAX, ignore audio (and InternVL video): the
    stack is the text request's."""
    port, ref = pipes(family)
    image = np.random.default_rng(0).integers(0, 256, (32, 32, 3), np.uint8)
    frames = [Image.fromarray(np.roll(image, i, axis=0)) for i in range(2)]
    wave = (np.random.default_rng(1).standard_normal(24000) * 0.1).astype(
        np.float32)
    if family == "minicpm":
        text = port.encoder_fn({"prompt": "x"})
        for m in ({"images": [Image.fromarray(image)]}, {"video": frames},
                  {"audio": wave}):
            got = port.encoder_fn({"prompt": "x", **m}).float().numpy()
            want = np.asarray(ref.encoder_fn({"prompt": "x", **m}),
                              np.float32)
            assert got.shape == want.shape == tuple(text.shape)
            assert np.abs(got - want).max() <= STACK_BAR * np.abs(want).max()
            assert not np.array_equal(got, text.float().numpy())
        return
    media = ({"images": [Image.fromarray(image)]}, {"video": [1, 2]},
             {"audio": np.zeros(16)})
    text = port.encoder_fn({"prompt": "x"})
    assert port.encoder_fn({"prompt": "x", **media[0]}).shape[:2] == \
        text.shape[:2]
    ignored = media[2:] if family == "qwenvl" else media[1:]
    for m in ignored:
        torch.testing.assert_close(port.encoder_fn({"prompt": "x", **m}),
                                   text, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["qwenvl", "internvl", "minicpm"])
def test_use_answer_matches_jax_or_is_refused(pipes, family):
    """qwenvl: the prompt's stack and a 128-token answer's, equal to the
    JAX loader's within the stack bar (the tokenizer's EOS in both);
    internvl and minicpm have no answer mode and raise ValueError, as
    the JAX loader does."""
    port, ref = pipes(family)
    req = {"prompt": PROMPTS[0], "task": "text2image", "use_answer": True}
    if family != "qwenvl":
        with pytest.raises(ValueError, match="Qwen2.5-VL feature"):
            port.encode(req)
        with pytest.raises(ValueError, match="Qwen2.5-VL feature"):
            ref.encode(req)
        return
    got = port.encoder_fn(req).float().numpy()
    want = np.asarray(ref.encoder_fn(req), np.float32)
    assert got.shape == want.shape == (1, 3, 512 + 128,
                                       port.proj.cfg.input_dim)
    assert np.abs(got - want).max() <= STACK_BAR * np.abs(want).max()
    tok = port.encoder_fn.ctx["tokenizer"]
    assert port.encoder_fn.ctx["eos_token_id"] == tok.eos_token_id


def test_session_from_checkpoints_matches_jax(dirs):
    """A two-turn chat session over the qwenvl fixture directory: the
    port's ``build_session_from_checkpoints`` (the tokenizer passed in)
    and the JAX one give the same answers and history; each turn's image
    is (1, PX, PX, 3)."""
    from x2i_torch.multiturn import build_session_from_checkpoints
    from x2i_tpu.multiturn import build_session_from_checkpoints as jsess
    model, flux, mllm, proj = dirs["qwenvl"]
    kw = dict(num_steps=STEPS, height=PX, width=PX, max_new_tokens=6,
              quantized=False)
    port = build_session_from_checkpoints(
        model, flux, mllm, proj, device="cpu",
        tokenizer=_tokenizer(mllm, "qwenvl"), **kw)
    ref = jsess(model, flux, mllm, proj, **kw)
    assert port.eos_token_id == ref.eos_token_id
    for msg in PROMPTS:
        answer, image = port.turn(msg)
        assert answer == ref.turn(msg)[0]
        assert image.shape == (1, PX, PX, 3)
    assert [(h.user, h.assistant) for h in port.history] == [
        (h.user, h.assistant) for h in ref.history]
