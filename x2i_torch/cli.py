"""The port's command line, the counterpart of ``x2i_tpu/cli.py``:

    python -m x2i_torch.cli --task text2image --prompt "..." \
        --flux_path <diffusers_dir> --mllm_path <hf_dir> \
        --proj_path <proj.bin> [--quantize w8|w8a8|w4|w4a8|none]
    python -m x2i_torch.cli --task text2image --prompt "..." \
        --random-weights tiny
    python -m x2i_torch.cli multiturn --flux_path ... --mllm_path ... \
        --proj_path ...

JAX's tasks (text2image, image2image, imagetext2image, video2image,
audio2image, x2image), flags, defaults, messages and exit codes (2 for a
missing prompt, image or checkpoint), and one flag more, ``--device``
(``cuda`` by default, where the port's entry points run; ``cpu`` for the
CPU; without a card ``cuda`` raises). ``--use_answer`` is reasoning2image
(the Qwen2.5-VL family). ``multiturn`` is the chat REPL: each turn decodes
an answer, conditions on the prompt's and the answer's hidden states and
writes one image with the session's fixed seed; an empty line is refused
and ``stop`` (or the end of the input) ends it.

``--audio`` is read with the stdlib ``wave`` module (16-bit PCM) and
``--image`` with PIL, imported only there. The output PNG is written by
``write_png`` (8-bit RGB through ``zlib`` and ``struct``), so that no
image library is needed to make an image.
"""

from __future__ import annotations

import argparse
import struct
import sys
import zlib

import numpy as np

TASKS = ("text2image", "image2image", "imagetext2image", "video2image",
         "audio2image", "x2image")
QUANT_CHOICES = ("none", "w8", "w8a8", "w4", "w4a8")


def png_bytes(image) -> bytes:
    """An 8-bit RGB PNG of ``image`` (H, W, 3) uint8: one IDAT of the rows,
    each behind filter byte 0, deflated by zlib at its default level."""
    img = np.ascontiguousarray(np.asarray(image))
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"png: (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def write_png(path: str, image) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def _quantized(choice: str):
    return False if choice == "none" else choice


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("x2i_torch")
    p.add_argument("--task", choices=TASKS, default="text2image")
    p.add_argument("--use_answer", action="store_true",
                   help="reasoning2image: decode an answer and condition "
                        "on cat(prefill, answer) hidden states "
                        "(Qwen2.5-VL family)")
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--image", type=str, action="append", default=None,
                   help="input image path(s)")
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--audio", type=str, default=None)
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--guidance_scale", type=float, default=3.5)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--flux_path", type=str, default=None)
    p.add_argument("--mllm_path", type=str, default=None)
    p.add_argument("--proj_path", type=str, default=None)
    p.add_argument("--model", type=str, default="x2i-internvl2.5-1b",
                   help="registry name (core.config.MODEL_REGISTRY)")
    p.add_argument("--random-weights", choices=("tiny",), default=None,
                   help="run with random weights at the given scale "
                        "(no checkpoints needed)")
    p.add_argument("--quantize", choices=QUANT_CHOICES, default="w8",
                   help="DiT weight quantization: w8 near-lossless "
                        "(default), w8a8 fastest, w4a8 smallest at speed, "
                        "w4 smallest, none = bf16")
    p.add_argument("--output", type=str, default="output.png")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def build_multiturn_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("x2i_torch multiturn")
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0,
                   help="fixed per-session seed (turns refine the same "
                        "trajectory)")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--quantize", choices=QUANT_CHOICES, default="w8")
    p.add_argument("--flux_path", type=str, default=None)
    p.add_argument("--mllm_path", type=str, default=None)
    p.add_argument("--proj_path", type=str, default=None)
    p.add_argument("--model", type=str, default="x2i-qwenvl2.5-7b")
    p.add_argument("--random-weights", choices=("tiny",), default=None)
    p.add_argument("--output_prefix", type=str, default="multiturn_",
                   help="images are written to {prefix}{turn}.png")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def _missing_checkpoints(args) -> bool:
    if args.flux_path and args.proj_path and args.mllm_path:
        return False
    print("error: provide --flux_path/--mllm_path/--proj_path or "
          "--random-weights tiny", file=sys.stderr)
    return True


def multiturn_main(argv=None) -> int:
    """The chat REPL: an empty line is refused, 'stop' exits, every other
    line is one conversation turn with its answer and image."""
    args = build_multiturn_parser().parse_args(argv)

    if args.random_weights:
        from x2i_torch.multiturn import build_random_session
        session = build_random_session(seed=args.seed, max_new_tokens=8,
                                       device=args.device)
    else:
        if _missing_checkpoints(args):
            return 2
        from x2i_torch.multiturn import build_session_from_checkpoints
        session = build_session_from_checkpoints(
            model=args.model, flux_path=args.flux_path,
            mllm_path=args.mllm_path, proj_path=args.proj_path,
            num_steps=args.num_steps, height=args.height, width=args.width,
            seed=args.seed, max_new_tokens=args.max_new_tokens,
            quantized=_quantized(args.quantize), device=args.device)

    turn = 0
    while True:
        try:
            raw = input("\nPlease Input Query (stop to exit) >>> ")
        except EOFError:
            break
        if not raw:
            print("Query should not be empty!")
            continue
        if raw == "stop":
            break
        answer, image = session.turn(raw)
        turn += 1
        path = f"{args.output_prefix}{turn}.png"
        write_png(path, np.asarray(image)[0])
        print(answer)
        print(f"wrote {path}")
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "multiturn":
        return multiturn_main(argv[1:])
    args = build_parser().parse_args(argv)

    if args.random_weights:
        from x2i_torch.core.config import GenerationConfig
        from x2i_torch.pipeline import build_random_pipeline
        pipe = build_random_pipeline(
            args.random_weights,
            gen_cfg=GenerationConfig(height=min(args.height, 64),
                                     width=min(args.width, 64),
                                     num_inference_steps=args.num_steps,
                                     seed=args.seed),
            device=args.device)
    else:
        if _missing_checkpoints(args):
            return 2
        from x2i_torch.convert.load import build_pipeline_from_checkpoints
        pipe = build_pipeline_from_checkpoints(
            model=args.model, flux_path=args.flux_path,
            mllm_path=args.mllm_path, proj_path=args.proj_path,
            num_steps=args.num_steps, height=args.height, width=args.width,
            seed=args.seed, quantized=_quantized(args.quantize),
            device=args.device)

    images = audio = video = None
    if args.image:
        from PIL import Image
        images = [Image.open(p).convert("RGB") for p in args.image]
    if args.video:
        from x2i_torch.data.video import load_video_frames
        video = load_video_frames(args.video)   # 1 fps, at most 64 frames
    if args.audio:
        import wave
        with wave.open(args.audio) as w:
            raw = w.readframes(w.getnframes())
            audio = (np.frombuffer(raw, np.int16).astype(np.float32)
                     / 32768.0)
    if args.task in ("image2image", "imagetext2image", "x2image") \
            and images is None and not args.random_weights:
        print("error: task requires --image", file=sys.stderr)
        return 2
    if args.task == "text2image" and not args.prompt:
        print("error: text2image requires --prompt", file=sys.stderr)
        return 2

    out = pipe.run_task(args.task, prompt=args.prompt, images=images,
                        video=video, audio=audio, seed=args.seed,
                        use_answer=args.use_answer)
    write_png(args.output, out[0])
    print(f"wrote {args.output} ({out.shape[2]}x{out.shape[1]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
