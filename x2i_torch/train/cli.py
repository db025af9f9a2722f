"""The trainers' command line, the counterpart of ``x2i_tpu/train/cli.py``:

    python -m x2i_torch.train.cli distill --tiny --synthetic ...
    python -m x2i_torch.train.cli lightcontrol --tiny ...

with JAX's subcommands, flags and defaults, and one flag more,
``--device`` (``cuda`` by default, where the port's entry points run;
``cpu`` for the CPU; without a card ``cuda`` raises). As in JAX, only the
tiny random models on their own synthetic batch are wired up: without
``--tiny`` a subcommand prints JAX's message and returns 2. Each run goes
through ``train/runner.py``'s TrainLoop with step-directory checkpoints in
``--output_dir``: a run resumes from the latest step there and logs
``resumed from step N``. ``--trace_dir`` traces the second step (the
first after the warm-up) into a Chrome trace (JAX's command line passes
its trace directory without steps to trace, so traces nothing).
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser():
    p = argparse.ArgumentParser("x2i_torch.train")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("distill", help="phase-1 attention distillation")
    d.add_argument("--model", default="x2i-internvl2.5-1b")
    d.add_argument("--urls", default=None, help="webdataset shard urls")
    d.add_argument("--synthetic", action="store_true",
                   help="synthetic token batches (no data needed)")
    d.add_argument("--tiny", action="store_true",
                   help="tiny random models (no checkpoints needed)")
    d.add_argument("--batch_size", type=int, default=1)
    d.add_argument("--learning_rate", type=float, default=1e-4)
    d.add_argument("--lr_warmup_steps", type=int, default=100)
    d.add_argument("--max_train_steps", type=int, default=100_000)
    d.add_argument("--gradient_accumulation_steps", type=int, default=1)
    d.add_argument("--max_grad_norm", type=float, default=1.0)
    d.add_argument("--use_8bit_adam", action="store_true")
    d.add_argument("--checkpointing_steps", type=int, default=1000)
    d.add_argument("--checkpoints_total_limit", type=int, default=5)
    d.add_argument("--output_dir", default="ckpt_distill")
    d.add_argument("--seed", type=int, default=2024)
    d.add_argument("--trace_dir", default=None)
    d.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")

    l = sub.add_parser("lightcontrol", help="phase-2 ControlNeXt finetune")
    l.add_argument("--tiny", action="store_true")
    l.add_argument("--synthetic", action="store_true")
    l.add_argument("--batch_size", type=int, default=1)
    l.add_argument("--learning_rate", type=float, default=1e-5)
    l.add_argument("--max_train_steps", type=int, default=2_000_000)
    l.add_argument("--gradient_accumulation_steps", type=int, default=8)
    l.add_argument("--checkpointing_steps", type=int, default=1000)
    l.add_argument("--output_dir", default="ckpt_lightcontrol")
    l.add_argument("--seed", type=int, default=42)
    l.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def _repeat(batch):
    while True:
        yield batch


def run_distill(args) -> int:
    if not args.tiny:
        print("full-size distillation requires converted checkpoints; "
              "run with --tiny --synthetic for the wired-up smoke path",
              file=sys.stderr)
        return 2

    from x2i_torch.train.harness import build_tiny_distill
    from x2i_torch.train.runner import TrainLoop

    step_fn, state, batch, _ = build_tiny_distill(
        batch_size=args.batch_size, use_8bit_adam=args.use_8bit_adam,
        device=args.device)
    loop = TrainLoop(step_fn, state, _repeat(batch),
                     checkpoint_dir=args.output_dir,
                     checkpointing_steps=args.checkpointing_steps,
                     max_to_keep=args.checkpoints_total_limit,
                     trace_dir=args.trace_dir, trace_steps=range(1, 2),
                     seed=args.seed, log_every=10)
    metrics = loop.run(args.max_train_steps)
    print(f"final: {metrics}")
    return 0


def run_lightcontrol(args) -> int:
    if not args.tiny:
        print("lightcontrol full-size training requires converted "
              "checkpoints; run with --tiny --synthetic for the wired-up "
              "smoke path", file=sys.stderr)
        return 2

    from x2i_torch.train.harness import build_tiny_lightcontrol
    from x2i_torch.train.runner import TrainLoop

    step_fn, state, batch, _ = build_tiny_lightcontrol(
        batch_size=args.batch_size, seed=args.seed, device=args.device,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        learning_rate=args.learning_rate)
    loop = TrainLoop(step_fn, state, _repeat(batch),
                     checkpoint_dir=args.output_dir,
                     checkpointing_steps=args.checkpointing_steps,
                     seed=args.seed, log_every=10)
    metrics = loop.run(args.max_train_steps)
    print(f"final: {metrics}")
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.cmd == "distill":
        return run_distill(args)
    return run_lightcontrol(args)


if __name__ == "__main__":
    raise SystemExit(main())
