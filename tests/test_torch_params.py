"""The weight bridge (x2i_torch/params.py): flax param trees of the JAX
package's tiny FLUX, Qwen2, Proj and VAE land, leaf for leaf, in the port's
modules (transposed where the layouts differ), and a tree that does not fit
raises."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x2i_tpu.core import config as jcfg
from x2i_tpu.diffusion.sampling import prepare_latent_image_ids
from x2i_tpu.models.flux import FluxTransformer2D as JFlux
from x2i_tpu.models.flux import chunk_single_scan_params
from x2i_tpu.models.proj import Proj as JProj
from x2i_tpu.models.qwen2 import Qwen2LM as JQwen2
from x2i_tpu.models.vae import AutoencoderKL as JVAE
from x2i_torch.core import config as tcfg
from x2i_torch.models.flux import FluxTransformer2D
from x2i_torch.models.proj import Proj
from x2i_torch.models.qwen2 import Qwen2LM
from x2i_torch.models.vae import Decoder
from x2i_torch.params import load_flax, random_init_


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch's ops on one thread in the modules that import this fixture:
    under the test run's workers, one on every core, each worker's thread
    pool on every core made the small ops of the tiny models several
    times slower (the thread pools' spinning waits)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_tree(init, *args, seed=0):
    """A flax param tree of ``init``'s structure (traced, never run) with
    numpy values: Dense/Conv kernels at std 1/sqrt(fan_in), biases 0.1,
    norm scales 1 + 0.1 * N(0, 1), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.key(0), *args)

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            fan_in = (np.prod(s.shape[:-1]) if len(s.shape) == 4
                      else s.shape[-2])
            return x / np.float32(np.sqrt(fan_in))
        if name == "bias":
            return np.float32(0.1) * x
        if name == "embedding":
            return x
        return np.float32(1.0) + np.float32(0.1) * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flux_tree(seed=0, cfg=None, s_img=16, s_txt=8):
    cfg = cfg or jcfg.tiny_flux_config()
    grid = int(2 * s_img ** 0.5)
    return random_tree(
        JFlux(cfg).init, jnp.zeros((1, s_img, cfg.in_channels)),
        jnp.zeros((1, s_txt, cfg.joint_attention_dim)),
        jnp.zeros((1, cfg.pooled_projection_dim)), jnp.zeros((1,)),
        prepare_latent_image_ids(grid, grid), jnp.zeros((s_txt, 3)),
        seed=seed)


def qwen2_tree(seed=0, cfg=None):
    cfg = cfg or jcfg.tiny_qwen2_config()
    return random_tree(JQwen2(cfg).init, jnp.zeros((1, 8), jnp.int32),
                       seed=seed)


def proj_cfgs(mode):
    kw = dict(in_channels=3, input_dim=16, output_dim0=8, output_dim1=12,
              use_scale=mode == "scale", use_cnn=mode == "cnn")
    return (jcfg.ProjConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            tcfg.ProjConfig(dtype=torch.float32, **kw))


def vae_cfgs():
    kw = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1,
              norm_num_groups=4)
    return (jcfg.VAEConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            tcfg.VAEConfig(dtype=torch.float32, **kw))


def _get(module, path):
    for key in path:
        module = module[int(key)] if key.isdigit() else getattr(module, key)
    return module


def assert_tree_in(module, tree, stacks=()):
    """Every flax leaf equals the parameter it should have landed in."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "params":
            keys = keys[1:]
        layers = [None]
        if keys[0] in stacks:
            layers = range(leaf.shape[0])
        for i in layers:
            mod_path = keys[:-1] if i is None else (
                [keys[0], str(i)] + [k for k in keys[1:-1] if k != "block"])
            owner = _get(module, mod_path)
            value = leaf if i is None else leaf[i]
            name = keys[-1]
            if name == "kernel" and isinstance(owner, torch.nn.Conv2d):
                got, value = owner.weight, np.transpose(value, (3, 2, 0, 1))
            elif name == "kernel":
                got, value = owner.weight, value.T
            elif name == "embedding":
                got = owner.weight
            else:
                got = getattr(owner, name)
            np.testing.assert_array_equal(got.detach().numpy(), value)


def test_flux_tree_round_trip():
    tree = flux_tree()
    model = load_flax(FluxTransformer2D(tcfg.tiny_flux_config()), tree)
    assert_tree_in(model, tree, stacks=("double_blocks", "single_blocks"))


def test_flux_chunked_single_stack():
    """single_blocks_{i} chunk stacks fill the same modules as the flat
    stack they were cut from."""
    tree = flux_tree(1)
    flat = load_flax(FluxTransformer2D(tcfg.tiny_flux_config()), tree)
    chunked = load_flax(FluxTransformer2D(tcfg.tiny_flux_config()),
                        chunk_single_scan_params(tree, 2))
    for a, b in zip(flat.parameters(), chunked.parameters()):
        assert torch.equal(a, b)


def test_qwen2_tree_round_trip():
    tree = qwen2_tree()
    model = load_flax(Qwen2LM(tcfg.tiny_qwen2_config()), tree)
    assert_tree_in(model, tree, stacks=("layers",))
    # q/k/v carry biases, o_proj none
    blk = model.layers[0]
    assert blk.q_proj.bias is not None and blk.o_proj.bias is None


@pytest.mark.parametrize("mode", ["scale", "cnn", "mean"])
def test_proj_tree_round_trip(mode):
    jc, tc = proj_cfgs(mode)
    tree = random_tree(JProj(jc).init, jnp.zeros((1, 3, 8, 16)))
    assert_tree_in(load_flax(Proj(tc), tree), tree)


def test_vae_decoder_tree_round_trip():
    jc, tc = vae_cfgs()
    vae = JVAE(jc)
    tree = random_tree(functools.partial(vae.init, method=vae.decode),
                       jnp.zeros((1, 4, 4, 16)))
    dec = tree["params"]["decoder"]
    assert_tree_in(load_flax(Decoder(tc), dec), dec)


def test_bridge_refuses_a_tree_that_does_not_fit():
    tree = qwen2_tree()
    params = tree["params"]
    extra = {**params, "lm_head": {"kernel": np.zeros((64, 512))}}
    with pytest.raises(KeyError, match="lm_head"):
        load_flax(Qwen2LM(tcfg.tiny_qwen2_config()), extra)
    missing = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        load_flax(Qwen2LM(tcfg.tiny_qwen2_config()), missing)
    wrong = jax.tree_util.tree_map(lambda a: a, params)
    wrong["embed_tokens"] = {"embedding": np.zeros((512, 32), np.float32)}
    with pytest.raises(ValueError, match="embed_tokens"):
        load_flax(Qwen2LM(tcfg.tiny_qwen2_config()), wrong)


def test_random_init_draws_from_the_generator():
    def draw(seed):
        return random_init_(Qwen2LM(tcfg.tiny_qwen2_config()),
                            torch.Generator().manual_seed(seed))
    a, b, c = draw(0), draw(0), draw(1)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.layers[0].q_proj.weight
    assert not torch.equal(w, c.layers[0].q_proj.weight)
    assert abs(w.std().item() - 64 ** -0.5) < 0.02       # 1/sqrt(fan_in)
    assert torch.equal(a.final_norm.scale, torch.ones(64))
    assert torch.equal(a.layers[0].q_proj.bias, torch.zeros(64))
