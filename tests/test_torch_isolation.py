"""The port stands alone: nothing under x2i_torch/, and not chip_smoke.py,
imports jax, flax, optax, orbax or the JAX package (x2i_tpu), at any level
of a module;
and, every kernel of the port being CUDA C++, none imports triton. The
machine with the card has no safetensors and no transformers: the port
reads safetensors itself and imports neither package when a module is
imported; the one import of transformers is the tokenizer loader's, inside
``build_pipeline_from_checkpoints``, for a caller who passes no tokenizer.
PIL, which the image preprocessing resizes with, is imported only inside
the functions that resize, so that the device half of the encoders runs
where it is missing. Checked on the syntax tree, so imports inside
functions count too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "x2i_tpu")
FILES = sorted((ROOT / "x2i_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path, top_level_only: bool = False):
    """The modules ``path`` imports; with ``top_level_only`` those it
    imports when it is imported (not inside a function's body)."""
    tree = ast.parse(path.read_text(), str(path))
    nodes = ast.walk(tree) if not top_level_only else _outside_functions(
        tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _outside_functions(node):
    yield node
    for child in ast.iter_child_nodes(node):
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
            yield from _outside_functions(child)


def test_the_port_has_modules_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"x2i_torch/pipeline.py", "x2i_torch/ops/flash_attention.py",
            "x2i_torch/ops/fused_glue.py", "x2i_torch/ops/quant.py",
            "x2i_torch/ops/int8_gemm.py", "x2i_torch/ops/cuda_lib.py",
            "x2i_torch/ops/kd.py", "x2i_torch/models/t5.py",
            "x2i_torch/models/clip.py", "x2i_torch/train/distill.py",
            "x2i_torch/train/single_chip.py", "x2i_torch/train/harness.py",
            "x2i_torch/train/runner.py", "x2i_torch/models/siglip.py",
            "x2i_torch/models/resampler.py", "x2i_torch/models/whisper_enc.py",
            "x2i_torch/models/minicpmo.py",
            "x2i_torch/data/minicpm_vision.py",
            "x2i_torch/models/controlnext.py",
            "x2i_torch/train/lightcontrol.py", "x2i_torch/train/optim.py",
            "x2i_torch/models/vae.py", "x2i_torch/convert/load.py",
            "x2i_torch/core/checkpointing.py", "x2i_torch/core/profiling.py",
            "x2i_torch/train/optim8bit.py", "x2i_torch/train/cli.py",
            "x2i_torch/cli.py", "x2i_torch/convert/cli.py",
            "x2i_torch/prompts.py", "x2i_torch/models/proj_variants.py",
            "x2i_torch/integrations/__init__.py",
            "x2i_torch/integrations/comfyui.py",
            "x2i_torch/integrations/comfyui_plugin/__init__.py",
            "chip_smoke.py"} <= names


def test_every_module_of_the_jax_package_has_its_counterpart():
    """Each .py file of x2i_tpu/ has one of the same path under
    x2i_torch/ (read as file names only: nothing of JAX is imported)."""
    def tree(pkg):
        return {p.relative_to(ROOT / pkg).as_posix()
                for p in (ROOT / pkg).rglob("*.py")}
    assert not tree("x2i_tpu") - tree("x2i_torch")


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_no_triton_import():
    bad = {path.relative_to(ROOT).as_posix(): m for path in FILES
           for m in _imports(path) if m.split(".")[0] == "triton"}
    assert not bad, f"these import triton: {bad}"


@pytest.mark.parametrize("package", ["safetensors", "transformers", "PIL"])
def test_no_module_level_import_of_packages_the_card_lacks(package):
    bad = {path.relative_to(ROOT).as_posix(): m for path in FILES
           for m in _imports(path, top_level_only=True)
           if m.split(".")[0] == package}
    assert not bad, f"these import {package} when imported: {bad}"


def test_the_only_lazy_transformers_import_is_the_tokenizer_loaders():
    users = {path.relative_to(ROOT).as_posix() for path in FILES
             for m in _imports(path) if m.split(".")[0] == "transformers"}
    assert users <= {"x2i_torch/convert/load.py"}
    assert not any(m.split(".")[0] == "safetensors"
                   for path in FILES for m in _imports(path))
