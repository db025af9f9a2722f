"""The port's ComfyUI nodes (``x2i_torch/integrations/comfyui.py``), their
plugin shim and the prompt banks (``x2i_torch/prompts.py``) against the
JAX package on the CPU: the npz proj checkpoint written by either package
and read by the other (the parameters bit for bit), ``MLLMLoader`` +
``ProjLoader`` + ``MLLMEncode`` on a bf16 InternVL2.5 fixture directory
against JAX's nodes on the same directory and file (the conditioning
within 2e-2 of its largest magnitude: both sides in bf16, rounding at
other points, as the hidden-state stacks of ``test_torch_checkpoint_dirs.
py`` do), the shim loaded by path as ComfyUI loads a custom node, and the
banks equal to JAX's."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoint_dirs import build_internvl_text_dir
from test_torch_params import random_tree
from x2i_tpu import prompts as jprompts
from x2i_tpu.core import config as jcfg
from x2i_tpu.integrations import comfyui as jnodes
from x2i_tpu.models.proj import Proj as JProj
from x2i_torch import prompts
from x2i_torch.core import config as tcfg
from x2i_torch.integrations import comfyui as nodes
from x2i_torch.models.proj import Proj
from x2i_torch.params import load_flax, random_init_

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJ_KW = dict(in_channels=3, input_dim=32, output_dim0=8, output_dim1=12)
COND_BAR = 2e-2


def _port_proj(dtype=torch.bfloat16, seed=0):
    proj = Proj(tcfg.ProjConfig(**PROJ_KW, dtype=dtype))
    return random_init_(proj, torch.Generator().manual_seed(seed))


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's file: JAX reads the same tree and config, and its
    ProjLoader builds a proj that applies."""
    proj = _port_proj(torch.float32)
    path = str(tmp_path / "p.npz")
    nodes.save_proj_checkpoint(path, nodes.proj_config_dict(proj.cfg), proj)
    config, tree = jnodes.load_proj_checkpoint(path)
    assert config == dict(PROJ_KW, kernel_size=5, norm_eps=1e-6,
                          use_scale=False, use_cnn=True, num_layers=2,
                          num_heads=12, head_dim=64, use_t5=False)
    back = load_flax(Proj(proj.cfg), tree)
    for k, v in proj.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    ((jproj, jparams),) = jnodes.ProjLoader().load(path)
    x = np.random.default_rng(0).standard_normal((1, 3, 4, 32))
    pooled, seq = jproj.apply(jparams, jnp.asarray(x, jnp.float32))
    assert pooled.shape == (1, 8) and seq.shape == (1, 4, 12)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """JAX's file (its own test's config dict, dtypes left out): the
    port's ProjLoader gives the bridge's proj of that tree, bit for bit,
    and the same projection as JAX's ProjLoader within the bf16 bar."""
    jc = jcfg.ProjConfig(**PROJ_KW, dtype=jnp.float32,
                         param_dtype=jnp.float32)
    tree = random_tree(JProj(jc).init, jnp.zeros((1, 3, 4, 32)))
    cfg = {k: v for k, v in dataclasses.asdict(jc).items()
           if k not in ("dtype", "param_dtype")}
    path = str(tmp_path / "j.npz")
    jnodes.save_proj_checkpoint(path, cfg, tree["params"])
    (proj,) = nodes.ProjLoader().load(path, device="cpu")
    assert proj.cfg == tcfg.ProjConfig(**cfg)
    want = load_flax(Proj(tcfg.ProjConfig(**cfg)), tree)
    for k, v in want.state_dict().items():
        assert torch.equal(proj.state_dict()[k], v), k
    x = np.random.default_rng(1).standard_normal((1, 3, 4, 32))
    ((jproj, jparams),) = jnodes.ProjLoader().load(path)
    _, jseq = jproj.apply(jparams, jnp.asarray(x, jnp.float32))
    with torch.inference_mode():
        _, seq = proj(torch.from_numpy(x).float())
    jseq = np.asarray(jseq, np.float32)
    assert np.abs(seq.float().numpy() - jseq).max() <= \
        COND_BAR * np.abs(jseq).max()


@pytest.fixture(scope="module")
def internvl(tmp_path_factory):
    root = tmp_path_factory.mktemp("nodes_internvl")
    proj = _port_proj()
    path = str(root / "proj.npz")
    nodes.save_proj_checkpoint(path, nodes.proj_config_dict(proj.cfg), proj)
    return build_internvl_text_dir(str(root)), path


def test_mllm_encode_matches_jax_nodes(internvl):
    mllm_dir, proj_path = internvl
    (mllm,) = nodes.MLLMLoader().load("internvl2.5", mllm_dir, device="cpu")
    (proj,) = nodes.ProjLoader().load(proj_path, device="cpu")
    ((embeds, extras),), = nodes.MLLMEncode().encode(
        mllm, proj, "a lighthouse at dusk")
    pooled = extras["pooled_output"]
    assert isinstance(embeds, torch.Tensor) and embeds.shape == (1, 512, 12)
    assert pooled.shape == (1, 8)
    with torch.inference_mode():
        want_pooled, want_embeds = proj(mllm({"prompt": "a lighthouse at "
                                                        "dusk"}))
    assert torch.equal(embeds, want_embeds)
    assert torch.equal(pooled, want_pooled)

    (jmllm,) = jnodes.MLLMLoader().load("internvl2.5", mllm_dir)
    (jproj,) = jnodes.ProjLoader().load(proj_path)
    ((jembeds, jextras),), = jnodes.MLLMEncode().encode(
        jmllm, jproj, "a lighthouse at dusk")
    for got, want in ((embeds, jembeds), (pooled, jextras["pooled_output"])):
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        err = np.abs(got.float().numpy() - want).max()
        assert err <= COND_BAR * np.abs(want).max(), err


def test_plugin_shim_loads_like_comfyui():
    """ComfyUI imports ``custom_nodes/<pkg>/__init__.py`` by its path, with
    no package context, and reads the two mappings."""
    shim = os.path.join(ROOT, "x2i_torch", "integrations", "comfyui_plugin",
                        "__init__.py")
    spec = importlib.util.spec_from_file_location(
        "custom_nodes.comfyui_x2i_torch", shim)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.NODE_CLASS_MAPPINGS is nodes.NODE_CLASS_MAPPINGS
    assert set(mod.NODE_CLASS_MAPPINGS) == set(
        mod.NODE_DISPLAY_NAME_MAPPINGS) == set(jnodes.NODE_CLASS_MAPPINGS)
    for name, cls in mod.NODE_CLASS_MAPPINGS.items():
        jcls = jnodes.NODE_CLASS_MAPPINGS[name]
        assert cls.INPUT_TYPES() == jcls.INPUT_TYPES()
        assert cls.RETURN_TYPES == jcls.RETURN_TYPES
        assert cls.FUNCTION == jcls.FUNCTION and hasattr(cls, cls.FUNCTION)
    assert nodes.PROJ_SIZE_CONFIGS == jnodes.PROJ_SIZE_CONFIGS
    assert nodes.MultiImagePaths().load("a", "", "b") == (["a", "b"],)
    assert nodes.LoadImagePath().load("a") == (["a"],)


def test_prompt_banks_equal_jax():
    assert prompts.TEXT2IMAGE_MULTILINGUAL == jprompts.TEXT2IMAGE_MULTILINGUAL
    assert (prompts.IMAGETEXT2IMAGE_INSTRUCTIONS
            == jprompts.IMAGETEXT2IMAGE_INSTRUCTIONS)
    assert prompts.text2image_bank() == jprompts.text2image_bank()
    assert [lang for lang, _ in prompts.text2image_bank()] == [
        "EN", "ZH", "DE", "FR", "JA", "VI"]
