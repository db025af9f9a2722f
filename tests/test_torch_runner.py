"""The port's training run control on the CPU: step-directory checkpoints
(``x2i_torch/core/checkpointing.py``), the loop's save and auto-resume
(``train/runner.py``), the trace scope (``core/profiling.py``) and the
command line (``train/cli.py``), the counterparts of the JAX package's
(``tests/test_runner.py`` holds those).

* the checkpoint round trip (a module, an 8-bit optimizer state, ints and
  None) bit for bit, ``latest_step``, ``max_to_keep``, a save that dies
  leaves no step, a state of another shape is refused;
* a tiny distillation run (8-bit AdamW) and a tiny phase-2 run, each with
  two-step accumulation, saved in the middle of an accumulation and
  resumed: bit for bit the unbroken run (each step's noise is keyed by
  the step);
* ``python -m x2i_torch.train.cli`` with ``--device cpu``: ``distill``
  for 3 steps and then on to 5 from its checkpoint, with a trace;
  ``lightcontrol``; exit code 2 without ``--tiny``; ``--device cuda``
  raises where there is no card.
No JAX: these are the port's own contracts."""

import dataclasses
import logging
import os

import pytest
import torch
from torch import nn

from x2i_torch.core import checkpointing as ck
from x2i_torch.core.profiling import trace
from x2i_torch.train import cli
from x2i_torch.train import harness as tharness
from x2i_torch.train.optim8bit import AdamW8bit
from x2i_torch.train.runner import TrainLoop


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny steps' small ops on one thread: with the test run's
    workers on every core, torch's thread pool made them ten times
    slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass
class _State:
    net: nn.Module
    opt_state: object
    step: int = 0
    note: object = None


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    net = nn.Linear(130, 3)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = AdamW8bit(1e-2, 1.0, accumulate=2)
    state = _State(net, opt.init(list(net.parameters())))
    grads = [torch.randn(p.shape, generator=g) for p in net.parameters()]
    for _ in range(3):
        state.opt_state = opt.update(list(net.parameters()), grads,
                                     state.opt_state)
    state.step = 3
    return state


def _tree_eq(a, b):
    """Two ``to_tree`` trees equal bit for bit (tensors as bytes)."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.contiguous().view(torch.uint8),
            b.contiguous().view(torch.uint8)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_eq(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_tree_eq, a, b))
    return a == b


def test_checkpoint_round_trip(tmp_path):
    state = _state(0)
    assert state.opt_state.mini_step == 1          # mid accumulation
    mgr = ck.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, state)
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ck")) == ["3"]
    other = _state(1)
    restored = mgr.restore(template=other)
    assert restored.net is other.net              # loaded in place
    assert _tree_eq(ck.to_tree(restored), ck.to_tree(state))
    assert restored.opt_state.mu[0].dtype == torch.float8_e4m3fn
    assert restored.step == 3 and restored.note is None
    raw = mgr.restore(3)
    assert set(raw) == {"net", "opt_state", "step", "note"}
    mgr.close()
    # a tree is a snapshot: the state moving on leaves it as it was
    tree = ck.to_tree(state)
    with torch.no_grad():
        state.net.weight.add_(1.0)
        state.opt_state.acc[0].add_(1.0)
    assert _tree_eq(tree, raw)


def test_latest_step_and_max_to_keep(tmp_path):
    assert ck.latest_step(str(tmp_path / "none")) is None
    for name in ("2", "10", "abc", ".11-x"):
        os.makedirs(tmp_path / "d" / name)
    assert ck.latest_step(str(tmp_path / "d")) == 10
    mgr = ck.CheckpointManager(str(tmp_path / "k"), max_to_keep=2)
    state = _state(0)
    for step in (1, 2, 3, 4):
        mgr.save(step, state)
    assert sorted(os.listdir(tmp_path / "k")) == ["3", "4"]
    # a step already on disk is kept, as orbax keeps it
    state.step = 99
    mgr.save(4, state)
    assert mgr.restore(4)["step"] == 3


def test_a_save_that_dies_leaves_no_step(tmp_path, monkeypatch):
    mgr = ck.CheckpointManager(str(tmp_path / "k"))

    def boom(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", boom)
    with pytest.raises(OSError):
        mgr.save(5, _state(0))
    assert os.listdir(tmp_path / "k") == []
    assert mgr.restore() is None


def test_fill_refuses_another_shape(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "k"))
    mgr.save(1, _state(0))
    wrong = _state(0)
    wrong.opt_state.mu[0] = torch.zeros(3, 128)
    with pytest.raises(ValueError, match="does not fill"):
        mgr.restore(template=wrong)


def _repeat(batch):
    while True:
        yield batch


@pytest.mark.parametrize("trainer", ["distill", "lightcontrol"])
def test_resumed_run_is_the_unbroken_run(tmp_path, trainer):
    """Five steps with two-step accumulation and checkpoints every three
    steps: saved at step 3, the middle of an accumulation (and at 5); a
    run stopped at 3 and resumed by a new loop ends bit for bit where the
    unbroken one does."""
    def build():
        if trainer == "distill":
            return tharness.build_tiny_distill(
                batch_size=2, device="cpu", use_8bit_adam=True,
                gradient_accumulation_steps=2)[:3]
        return tharness.build_tiny_lightcontrol(
            batch_size=2, device="cpu", gradient_accumulation_steps=2)[:3]

    def loop(directory):
        step, state, batch = build()
        return TrainLoop(step, state, _repeat(batch), seed=7,
                         checkpoint_dir=str(tmp_path / directory),
                         checkpointing_steps=3)

    whole = loop("whole")
    whole.run(5)
    first = loop("broken")
    first.run(3)
    assert first.state.opt_state.mini_step == 1
    resumed = loop("broken")
    assert resumed.state.step == 3
    assert resumed.state.opt_state.mini_step == 1
    resumed.run(5)
    assert resumed.state.step == whole.state.step == 5
    assert _tree_eq(ck.to_tree(resumed.state), ck.to_tree(whole.state))
    assert sorted(os.listdir(tmp_path / "broken")) == ["3", "5"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    with trace(None):
        pass
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")


def test_cli_trains_checkpoints_and_resumes(tmp_path, caplog):
    out = str(tmp_path / "d")
    args = ["distill", "--tiny", "--synthetic", "--batch_size", "2",
            "--checkpointing_steps", "2", "--output_dir", out,
            "--device", "cpu"]
    assert cli.main(args + ["--max_train_steps", "3", "--trace_dir",
                            str(tmp_path / "trace")]) == 0
    assert sorted(os.listdir(out)) == ["2", "3"]
    assert len(os.listdir(tmp_path / "trace")) == 1     # the second step
    with caplog.at_level(logging.INFO, logger="x2i_torch.train"):
        assert cli.main(args + ["--max_train_steps", "5"]) == 0
    assert "resumed from step 3" in caplog.text
    assert sorted(os.listdir(out)) == ["2", "3", "4", "5"]
    assert cli.main(["lightcontrol", "--tiny", "--batch_size", "2",
                     "--max_train_steps", "2", "--checkpointing_steps",
                     "100", "--output_dir", str(tmp_path / "lc"),
                     "--device", "cpu"]) == 0
    assert os.listdir(tmp_path / "lc") == ["2"]


def test_cli_refuses_full_size_and_a_missing_card(tmp_path):
    assert cli.main(["distill", "--max_train_steps", "1"]) == 2
    assert cli.main(["lightcontrol", "--max_train_steps", "1"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["distill", "--tiny", "--synthetic",
                      "--max_train_steps", "1", "--output_dir",
                      str(tmp_path / "c")])
        assert not os.path.exists(tmp_path / "c" / "1")
