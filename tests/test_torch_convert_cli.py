"""The port's conversion command line (``x2i_torch/convert/cli.py``)
against JAX's (``x2i_tpu/convert/cli.py``) on the CPU, on the same bf16
fixture directories: each kind (flux in bf16, w8, w8a8 and w4; vae; mllm
for Qwen2.5-VL and InternVL2.5; proj; t5; clip), the port's saved state
(``load_native``) equal bit for bit to JAX's ``load_native`` orbax tree
carried into a module of the same config by the bridge. JAX's command
line reads T5-XXL's 24 blocks and CLIP-L's 12 text blocks whatever the
directory holds, so those fixtures have that depth at tiny widths."""

import os

import pytest
import torch

from ckpt_fixtures import VOCAB_SIZE, build_family_checkpoints
from test_torch_checkpoint_dirs import _to_bf16, build_internvl_text_dir
from x2i_tpu.convert import cli as jcli
from x2i_torch.convert import cli as tcli
from x2i_torch.params import load_flax


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """kind -> (model, src) in bf16."""
    from transformers import (CLIPConfig, CLIPModel, T5Config,
                              T5EncoderModel)
    root = str(tmp_path_factory.mktemp("convert_cli"))
    flux, mllm, proj, model = build_family_checkpoints(root, "qwenvl")
    torch.manual_seed(1)
    t5 = T5EncoderModel(T5Config(
        vocab_size=VOCAB_SIZE, d_model=16, d_kv=4, d_ff=24, num_layers=24,
        num_heads=4, feed_forward_proj="gated-gelu", dropout_rate=0.0))
    t5.to(torch.bfloat16).save_pretrained(os.path.join(root, "t5"))
    clip = CLIPModel(CLIPConfig(
        text_config=dict(vocab_size=VOCAB_SIZE, hidden_size=16,
                         intermediate_size=32, num_hidden_layers=12,
                         num_attention_heads=2, max_position_embeddings=77,
                         bos_token_id=VOCAB_SIZE - 2,
                         eos_token_id=VOCAB_SIZE - 1),
        vision_config=dict(hidden_size=16, intermediate_size=32,
                           num_hidden_layers=1, num_attention_heads=2,
                           image_size=28, patch_size=7),
        projection_dim=8))
    clip.to(torch.bfloat16).save_pretrained(os.path.join(root, "clip"))
    _to_bf16(root)
    iv_root = str(tmp_path_factory.mktemp("convert_cli_internvl"))
    return {"flux": (model, flux), "vae": (model, flux),
            "mllm": (model, mllm), "proj": (model, proj),
            "mllm-internvl": ("x2i-internvl2.5-1b",
                              build_internvl_text_dir(iv_root)),
            "t5": (model, os.path.join(root, "t5")),
            "clip": (model, os.path.join(root, "clip"))}


@pytest.fixture
def saved(monkeypatch):
    """The modules the port's command line saves."""
    out, real = [], tcli.save_native

    def save(path, module):
        out.append(module)
        real(path, module)

    monkeypatch.setattr(tcli, "save_native", save)
    return out


CASES = [("flux", None), ("flux", "w8"), ("flux", "w8a8"), ("flux", "w4"),
         ("vae", None), ("mllm", None), ("mllm-internvl", None),
         ("proj", None), ("t5", None), ("clip", None)]


@pytest.mark.parametrize("kind,quantize", CASES,
                         ids=[f"{k}-{q or 'float'}" for k, q in CASES])
def test_saved_state_equals_jax_tree(dirs, tmp_path, saved, capsys, kind,
                                     quantize):
    model, src = dirs[kind]
    cli_kind = kind.split("-")[0]
    args = [cli_kind, "--src", src, "--model", model]
    if quantize:
        args += ["--quantize", quantize]
    port_dst, jax_dst = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tcli.main(args + ["--dst", port_dst, "--device", "cpu"]) == 0
    assert f"converted {cli_kind}:" in capsys.readouterr().out
    assert jcli.main(args + ["--dst", jax_dst]) == 0
    state = tcli.load_native(port_dst)
    (module,) = saved
    template = type(module)(module.cfg)
    if quantize:
        assert module.cfg.quantized == quantize
    want = load_flax(template, jcli.load_native(jax_dst)).state_dict()
    assert state.keys() == want.keys()
    for k, v in state.items():
        assert v.device.type == "cpu"
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    if quantize:
        assert any(v.dtype == torch.int8 for v in state.values())


def test_native_state_round_trip(tmp_path):
    """``save_native`` writes CPU tensors that ``load_native`` reads back
    with ``weights_only``; a module of the same config takes them."""
    from x2i_torch.core.config import ProjConfig
    from x2i_torch.models.proj import Proj
    proj = Proj(ProjConfig(in_channels=3, input_dim=16, output_dim0=8,
                           output_dim1=12))
    tcli.save_native(str(tmp_path / "p"), proj)
    assert sorted(os.listdir(tmp_path / "p")) == ["state.pt"]
    back = Proj(proj.cfg)
    back.load_state_dict(tcli.load_native(str(tmp_path / "p")))
    for k, v in proj.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
