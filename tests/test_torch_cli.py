"""The port's command line (``x2i_torch/cli.py``) on the CPU: ``main`` on
the Qwen2.5-VL fixture directories of ``tests/ckpt_fixtures.py`` (bf16, as
released) against JAX's ``x2i_tpu.cli.main`` on the same directories and
the same noise (the two packages draw noise from different generators,
so both draws are patched to one numpy draw); both PNGs decoded by PIL
and held to the bf16 image bar of ``test_torch_checkpoint_dirs.py``
(16 levels at the worst pixel, 1 on average). Then the ``--quantize``
modes, the exit code 2 paths, ``--random-weights tiny``, ``--device``,
``--use_answer`` and ``--audio``, the REPL (three turns, an empty line,
``stop``, the end of the input; on the fixture directories too), and the
PNG writer decoded by PIL bit for bit."""

import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckpt_fixtures import FLUX_KW, build_family_checkpoints
from test_torch_checkpoint_dirs import IMG_MAX, IMG_MEAN, _to_bf16
from test_torch_params import one_thread  # noqa: F401 (autouse)
from x2i_tpu import cli as jcli
from x2i_torch import cli
from x2i_torch.convert import load as tload

PX, STEPS = 64, 2


@pytest.fixture(scope="module")
def qwenvl(tmp_path_factory):
    """(model, flux, mllm, proj) of the bf16 Qwen2.5-VL fixture."""
    root = str(tmp_path_factory.mktemp("cli_qwenvl"))
    flux, mllm, proj, model = build_family_checkpoints(root, "qwenvl")
    _to_bf16(root)
    return model, flux, mllm, proj


def _ckpt_args(dirs, *extra):
    model, flux, mllm, proj = dirs
    return ["--model", model, "--flux_path", flux, "--mllm_path", mllm,
            "--proj_path", proj, "--height", str(PX), "--width", str(PX),
            "--num_steps", str(STEPS), "--device", "cpu", *extra]


def _png(path):
    from PIL import Image
    with Image.open(path) as img:
        assert img.mode == "RGB"
        return np.asarray(img).astype(int)


def _patch_noise(monkeypatch, noise):
    """Both packages' image noise (bf16, (1, S_img, in_channels)) is
    ``noise``; the patched draws count their hits."""
    randn, normal = torch.randn, jax.random.normal

    hits = []

    def t_randn(*shape, **kw):
        if (kw.get("dtype") is torch.bfloat16 and len(shape) == 1
                and tuple(shape[0]) == noise.shape):
            hits.append("torch")
            return torch.from_numpy(noise).to(torch.bfloat16)
        return randn(*shape, **kw)

    def j_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape and dtype == jnp.bfloat16:
            hits.append("jax")
            return jnp.asarray(noise, jnp.bfloat16)
        return normal(key, shape, dtype)

    monkeypatch.setattr(torch, "randn", t_randn)
    monkeypatch.setattr(jax.random, "normal", j_normal)
    return hits


def test_main_matches_the_jax_command_line(qwenvl, tmp_path, monkeypatch,
                                           capsys):
    """text2image in bf16 through both command lines on the same
    directories, prompt and noise."""
    noise = np.random.default_rng(3).standard_normal(
        (1, (PX // 16) ** 2, FLUX_KW["in_channels"])).astype(np.float32)
    hits = _patch_noise(monkeypatch, noise)
    got_path, want_path = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    prompt = ["--prompt", "a lighthouse at dusk", "--quantize", "none"]
    assert cli.main(_ckpt_args(qwenvl, *prompt, "--output", got_path)) == 0
    assert f"wrote {got_path} ({PX}x{PX})" in capsys.readouterr().out
    jax_args = _ckpt_args(qwenvl, *prompt, "--output", want_path)
    i = jax_args.index("--device")
    assert jcli.main(jax_args[:i] + jax_args[i + 2:]) == 0
    assert hits == ["torch", "jax"]
    got, want = _png(got_path), _png(want_path)
    assert got.shape == want.shape == (PX, PX, 3)
    assert np.unique(got).size > 1
    diff = np.abs(got - want)
    assert diff.max() <= IMG_MAX and diff.mean() <= IMG_MEAN, (
        diff.max(), diff.mean())


@pytest.fixture(autouse=True, scope="module")
def built_once():
    """Each set of ``build_pipeline_from_checkpoints`` arguments builds its
    pipeline once a module: the ``cli.main`` calls after the first with
    the same directories, mode and sizes take the same pipeline, as one
    process serving several commands would. The ``spy`` below wraps this
    seam. -> the cache."""
    cache, real = {}, tload.build_pipeline_from_checkpoints

    def build(*args, **kw):
        key = (args, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = real(*args, **kw)
        return cache[key]

    patch = pytest.MonkeyPatch()
    patch.setattr(tload, "build_pipeline_from_checkpoints", build)
    yield cache
    patch.undo()


@pytest.fixture
def spy(monkeypatch):
    """Records the keyword arguments of every
    ``build_pipeline_from_checkpoints`` call and keeps the pipelines."""
    calls, real = [], tload.build_pipeline_from_checkpoints

    def build(**kw):
        pipe = real(**kw)
        calls.append((kw, pipe))
        return pipe

    monkeypatch.setattr(tload, "build_pipeline_from_checkpoints", build)
    return calls


@pytest.mark.parametrize("choice", ["none", "w8", "w8a8", "w4", "w4a8"])
def test_quantize_modes(qwenvl, tmp_path, spy, choice):
    """Each ``--quantize`` choice loads the DiT in that mode (none: bf16)
    and writes the pipeline's own image."""
    out = str(tmp_path / "q.png")
    assert cli.main(_ckpt_args(qwenvl, "--prompt", "a bowl of ramen",
                               "--quantize", choice, "--output", out)) == 0
    (kw, pipe), = spy
    assert kw["quantized"] == (False if choice == "none" else choice)
    assert pipe.flux.cfg.quantized == kw["quantized"]
    assert not pipe.flux.cfg.fused_glue          # unfused on the CPU
    want = pipe.run_task("text2image", prompt="a bowl of ramen", seed=0)
    assert np.array_equal(_png(out), want[0].astype(int))


def test_exit_code_2_paths(qwenvl, tmp_path, spy, capsys):
    """JAX's exit code 2 and messages: no checkpoints (before anything is
    built), text2image without a prompt, an image task without an
    image."""
    out = str(tmp_path / "x.png")
    assert cli.main(["--prompt", "x", "--device", "cpu"]) == 2
    assert cli.main(["multiturn", "--device", "cpu"]) == 2
    assert "--random-weights tiny" in capsys.readouterr().err
    assert spy == []
    assert cli.main(_ckpt_args(qwenvl, "--output", out)) == 2
    assert "text2image requires --prompt" in capsys.readouterr().err
    assert cli.main(_ckpt_args(qwenvl, "--task", "imagetext2image",
                               "--prompt", "x", "--output", out)) == 2
    assert "task requires --image" in capsys.readouterr().err
    assert not (tmp_path / "x.png").exists()


def test_random_weights_tiny_and_the_device_flag(tmp_path):
    """``--random-weights tiny`` makes a 64^2 image at most, whatever the
    size asked; the default device is the card, which raises without
    one."""
    out = str(tmp_path / "r.png")
    args = ["--prompt", "a cat", "--random-weights", "tiny", "--num_steps",
            "2", "--output", out]
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert _png(out).shape == (64, 64, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)


def test_use_answer_and_audio(qwenvl, tmp_path, spy):
    """``--use_answer`` conditions on the decoded answer (another image
    than the prompt's alone, the pipeline's own use_answer image), and
    ``--audio`` reads 16-bit PCM through ``wave`` into the request (the
    Qwen2.5-VL encoder ignores audio, as in JAX)."""
    plain, answered = str(tmp_path / "p.png"), str(tmp_path / "a.png")
    wav = str(tmp_path / "a.wav")
    pcm = (np.sin(np.arange(1600) / 10) * 2e4).astype(np.int16)
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    base = _ckpt_args(qwenvl, "--prompt", "a cat", "--quantize", "none")
    assert cli.main(base + ["--output", plain, "--audio", wav]) == 0
    assert cli.main(base + ["--output", answered, "--use_answer"]) == 0
    (_, pipe), _ = spy
    want = pipe.run_task("text2image", prompt="a cat", seed=0,
                         use_answer=True)
    assert np.array_equal(_png(answered), want[0].astype(int))
    assert not np.array_equal(_png(plain), _png(answered))


def test_repl_three_turns_empty_line_and_stop(tmp_path, monkeypatch,
                                              capsys):
    lines = iter(["a red cat", "", "make it blue", "add a hat", "stop",
                  "never read"])
    monkeypatch.setattr("builtins.input", lambda _="": next(lines))
    prefix = str(tmp_path / "mt_")
    assert cli.main(["multiturn", "--random-weights", "tiny",
                     "--output_prefix", prefix, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("Query should not be empty!") == 1
    assert out.count("wrote ") == 3
    for turn in (1, 2, 3):
        assert _png(f"{prefix}{turn}.png").shape == (64, 64, 3)
    assert not (tmp_path / "mt_4.png").exists()
    assert next(lines) == "never read"


def test_repl_on_checkpoints_ends_at_eof(qwenvl, tmp_path, monkeypatch,
                                         capsys):
    """Two turns over the fixture directories' chat template, decoding 4
    answer tokens each, then the end of the input."""
    lines = iter(["draw a dog", "make it red"])

    def read(_=""):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", read)
    model, flux, mllm, proj = qwenvl
    prefix = str(tmp_path / "ck_")
    assert cli.main(["multiturn", "--model", model, "--flux_path", flux,
                     "--mllm_path", mllm, "--proj_path", proj, "--height",
                     str(PX), "--width", str(PX), "--num_steps", "1",
                     "--max_new_tokens", "4", "--output_prefix", prefix,
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("wrote ") == 2
    assert _png(f"{prefix}2.png").shape == (PX, PX, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 48)])
def test_png_writer_is_read_back_bit_for_bit(shape):
    from PIL import Image
    img = np.random.default_rng(shape[0]).integers(
        0, 256, (*shape, 3)).astype(np.uint8)
    data = cli.png_bytes(img)
    with Image.open(io.BytesIO(data)) as back:
        assert back.mode == "RGB" and back.size == (shape[1], shape[0])
        assert np.array_equal(np.asarray(back), img)
    assert cli.png_bytes(img) == data
    with pytest.raises(ValueError, match="uint8"):
        cli.png_bytes(img.astype(np.float32))
