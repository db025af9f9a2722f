"""The port's data layer (``x2i_torch/data/{webdataset,native_tar,loader,
datamodule}.py``) against the JAX package's on the CPU. Host code on both
sides, so the comparisons are exact: shard lists, shard orders per seed
and host in both resample modes (and JAX's refusal of a duplicated
epoch), the samples of tar shards through the native reader and the
python one (a pax archive among them), decoded samples, a pipeline that
skips bad samples, the datamodules' batches (phase 1 on the same
tokenize callables; phase 2's two branches and its caption dropout with
the same stub ``qwen_process`` and seed) and the synthetic batches. Of
the port alone: the prefetch loader's errors, timeout and copy to the
CPU, the multiprocess loader's finite epochs and errors, the host from
``torch.distributed``, and a caption-only shard decoding without PIL.
The shards are written by the tests from numpy-seeded images and
captions."""

import io
import itertools
import json
import queue
import sys
import tarfile
import time

import numpy as np
import pytest
import torch
from PIL import Image

from x2i_tpu.data import datamodule as jdm
from x2i_tpu.data import loader as jloader
from x2i_tpu.data import native_tar as jnative
from x2i_tpu.data import webdataset as jwds
from x2i_torch.data import datamodule as tdm
from x2i_torch.data import loader as tloader
from x2i_torch.data import native_tar as tnative
from x2i_torch.data import webdataset as twds

CAPTIONS = ("a red fox in fresh snow", "a lighthouse at dusk",
            "一只猫在窗台上", "three boats, twelve gulls")


def _png(rng, px=16):
    buf = io.BytesIO()
    Image.fromarray((rng.random((px, px, 3)) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _add(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_shard(path, n, start=0, images=True, fmt=tarfile.GNU_FORMAT):
    """n samples: a json with caption_en / caption_zh, a txt and (with
    ``images``) a png, from ``default_rng(index)``."""
    with tarfile.open(path, "w", format=fmt) as tf:
        for i in range(start, start + n):
            rng = np.random.default_rng(i)
            cap = CAPTIONS[i % len(CAPTIONS)] + f" #{i}"
            _add(tf, f"{i:06d}.json", json.dumps(
                {"caption_en": cap, "caption_zh": "图" + cap}).encode())
            _add(tf, f"{i:06d}.txt", cap.encode())
            if images:
                _add(tf, f"{i:06d}.png", _png(rng))
    return path


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    for j in range(3):
        write_shard(str(root / f"{j:03d}.tar"), 5, start=5 * j)
    return str(root / "{000..002}.tar")


def _same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], Image.Image):
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]))
            else:
                assert g[k] == w[k]


def _same_batch(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("urls", [
    "a/{000..002}.tar", "b/{9..11}.tar", "x.tar",
    ["x.tar", "b/{01..02}.tar", "c/{0099..0101}-of.tar"]])
def test_expand_urls_is_jaxs(urls):
    assert twds.expand_urls(urls) == jwds.expand_urls(urls)


@pytest.mark.parametrize("resample", [True, False])
@pytest.mark.parametrize("seed, host, hosts", [(0, 0, 1), (7, 1, 3),
                                                (2024, 2, 3)])
def test_shard_sampler_order_is_jaxs(resample, seed, host, hosts):
    urls = [f"s/{i:03d}.tar" for i in range(10)]
    got = twds.ShardSampler(urls, seed, resample, host, hosts)
    want = jwds.ShardSampler(urls, seed, resample, host, hosts)
    n = 40 if resample else None
    assert (list(itertools.islice(got, n))
            == list(itertools.islice(want, n)))


def test_shard_sampler_refuses_a_duplicated_epoch_as_jax():
    for mod in (twds, jwds):
        with pytest.raises(ValueError, match="duplicated"):
            list(mod.ShardSampler(["only.tar"], resample=False,
                                  host_index=1, host_count=2))
    got = twds.ShardSampler(["a.tar", "b.tar"], 3, True, 2, 3)
    want = jwds.ShardSampler(["a.tar", "b.tar"], 3, True, 2, 3)
    assert (list(itertools.islice(got, 12))
            == list(itertools.islice(want, 12)))


def test_shard_sampler_takes_the_host_from_torch_distributed(monkeypatch):
    """A process group's rank and size stand where JAX reads
    jax.process_index() / process_count(); none -> host 0 of 1."""
    urls = [f"s/{i}.tar" for i in range(6)]
    assert twds.host_rank() == (0, 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    got = twds.ShardSampler(urls, seed=5, resample=False)
    assert (got.host_index, got.host_count) == (1, 2)
    assert list(got) == list(jwds.ShardSampler(urls, 5, False, 1, 2))


def test_tar_samples_native_and_python_are_jaxs(shards):
    paths = twds.expand_urls(shards)
    assert tnative.TAR_INDEX.loaded()
    assert tnative.index_tar(paths[0]) == jnative.index_tar(paths[0])
    want = list(jwds.tar_samples(iter(paths), use_native=False))
    assert len(want) == 15 and set(want[0]) == {"__key__", "__url__",
                                                "json", "txt", "png"}
    for native in (True, False):
        _same_samples(list(twds.tar_samples(iter(paths),
                                            use_native=native)), want)
        _same_samples(list(jwds.tar_samples(iter(paths),
                                            use_native=native)), want)


def test_native_index_grows_past_its_first_table(tmp_path, monkeypatch):
    path = write_shard(str(tmp_path / "big.tar"), 6, images=False)
    want = jnative.index_tar(path)
    monkeypatch.setattr(tnative, "FIRST_ENTRIES", 5)
    assert tnative.index_tar(path) == want and len(want) == 12
    assert tnative.index_tar(path, max_entries=7) == want[:7]


def test_pax_archive_takes_the_python_reader_as_jax(tmp_path):
    path = str(tmp_path / "pax.tar")
    with tarfile.open(path, "w", format=tarfile.PAX_FORMAT) as tf:
        _add(tf, "样本0.json", b'{"caption_en": "x"}')
        _add(tf, "a0.json", b"{}")
        _add(tf, "a0.txt", b"y")
    assert tnative.index_tar(path) is None
    got = list(twds.tar_samples(iter([path])))
    assert len(got) == 2
    _same_samples(got, list(jwds.tar_samples(iter([path]))))


def test_decode_sample_is_jaxs(shards):
    raw = list(twds.tar_samples(iter(twds.expand_urls(shards))))
    raw[0] = {**raw[0], "cls": b"\x01\x02", "caption": "already str"}
    for mode in ("RGB", "L"):
        _same_samples([twds.decode_sample(s, mode) for s in raw],
                      [jwds.decode_sample(s, mode) for s in raw])


def test_pipeline_skips_bad_samples_as_jax(tmp_path):
    path = str(tmp_path / "bad.tar")
    with tarfile.open(path, "w") as tf:
        for key, data in [("a.json", b'{"caption_en": "ok"}'),
                          ("b.json", b"{not json"),
                          ("c.txt", b"no json"),
                          ("d.json", b'{"caption_en": "ok 2"}')]:
            _add(tf, key, data)

    def run(mod):
        return list(mod.Pipeline(mod.tar_samples(iter([path])))
                    .decode().verify(["json"])
                    .map(lambda s: s["json"]["caption_en"]))

    assert run(twds) == run(jwds) == ["ok", "ok 2"]


def test_caption_shard_decodes_without_pil(tmp_path, monkeypatch):
    """json/txt-only samples never import PIL (the card's machine has
    none); an image member does."""
    path = write_shard(str(tmp_path / "c.tar"), 3, images=False)
    monkeypatch.setitem(sys.modules, "PIL", None)
    samples = [twds.decode_sample(s)
               for s in twds.tar_samples(iter([path]))]
    assert [s["txt"] for s in samples] == [
        s["json"]["caption_en"] for s in samples]
    with pytest.raises(ImportError):
        twds.decode_sample({"__key__": "k", "png": b"\x89PNG"})


def _tokenizer(n):
    def tok(s):
        ids = np.zeros(n, np.int64)
        toks = [ord(c) % 97 + 1 for c in s[:n]]
        ids[:len(toks)] = toks
        return ids, np.arange(n) < len(toks)
    return tok


def _distill_modules(urls, seed=0, batch_size=2):
    kw = dict(mllm_tokenize=_tokenizer(64), t5_tokenize=_tokenizer(32),
              clip_tokenize=lambda s: _tokenizer(12)(s)[0],
              chat_template=lambda s: f"<user>{s}<assistant>")
    return tuple(mod.DistillDataModule(mod.DistillDataConfig(
        urls=urls, batch_size=batch_size, text_seq_len=64, seed=seed), **kw)
        for mod in (tdm, jdm))


@pytest.mark.parametrize("seed", [0, 11])
def test_distill_batches_are_jaxs(shards, seed):
    """Six batches of the infinite resampled stream, bit for bit; the
    instruction dict and the family templates are JAX's."""
    port, ref = _distill_modules(shards, seed)
    got = list(itertools.islice(port.train_loader(), 6))
    want = list(itertools.islice(ref.train_loader(), 6))
    for g, w in zip(got, want):
        _same_batch(g, w)
    assert got[0]["mllm_ids"].shape == (2, 64)
    assert tdm.instruction_dict("a", "b", "c") == jdm.instruction_dict(
        "a", "b", "c")

    class Tok:
        @staticmethod
        def apply_chat_template(messages, tokenize, add_generation_prompt):
            return repr((messages, tokenize, add_generation_prompt))

    for model in ("x2i-internvl2.5-1b", "x2i-qwenvl2.5-7b",
                  "x2i-minicpm-o-2.6"):
        assert (tdm.family_chat_template(model, Tok)("hi")
                == jdm.family_chat_template(model, Tok)("hi"))


def test_lightcontrol_batches_are_jaxs(tmp_path):
    """Editing pairs (style_zh + png: the 256^2 condition) and
    self-reconstruction (128^2, the caption kept on a random.Random(seed)
    draw below caption_keep_prob), the same instructions in the same
    order, bit for bit batches."""
    path = str(tmp_path / "lc.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(8):
            rng = np.random.default_rng(100 + i)
            meta = ({"style_zh": f"风格{i}", "caption_en": "x"} if i % 3 == 0
                    else {"caption_zh": f"一只猫 {i}", "caption_en": "x"})
            img = Image.fromarray((rng.random((24, 20, 3)) * 255).astype(
                np.uint8))
            buf = io.BytesIO()
            img.save(buf, format="JPEG")
            _add(tf, f"{i:06d}.json", json.dumps(meta).encode())
            _add(tf, f"{i:06d}.jpg", buf.getvalue())
            if "style_zh" in meta:
                _add(tf, f"{i:06d}.png", _png(rng, 24))

    def make(mod, seen):
        def qwen_process(instruction, image):
            seen.append(instruction)
            return {"mllm_ids": np.frombuffer(
                instruction.encode()[:16].ljust(16), np.uint8).astype(
                np.int32), "cond_small": np.asarray(image)}
        return mod.LightControlDataModule(
            mod.DistillDataConfig(urls=path, batch_size=1, seed=3),
            qwen_process, caption_keep_prob=0.5, seed=9)

    seen_t, seen_j = [], []
    got = list(itertools.islice(make(tdm, seen_t).train_loader(), 12))
    want = list(itertools.islice(make(jdm, seen_j).train_loader(), 12))
    for g, w in zip(got, want):
        _same_batch(g, w)
    assert seen_t == seen_j
    assert any("风格" in s for s in seen_t)
    assert any("请描述这张图片" in s for s in seen_t)
    assert any("一只猫" in s for s in seen_t)
    assert {g["cond_small"].shape[1] for g in got} == {128, 256}


def test_synthetic_batches_are_jaxs():
    got = tdm.synthetic_distill_batches(2, 8, 4, seed=3)
    want = jdm.synthetic_distill_batches(2, 8, 4, seed=3)
    for g, w in itertools.islice(zip(got, want), 3):
        _same_batch(g, w)


def test_stack_collate_is_jaxs():
    samples = [{"a": np.full(3, i), "b": np.eye(2) * i, "__key__": str(i)}
               for i in range(3)]
    _same_batch(tloader.stack_collate(samples),
                jloader.stack_collate(samples))


def test_prefetch_loader_raises_the_producers_error_and_times_out():
    def gen():
        yield {"x": 1}
        raise RuntimeError("boom")

    out = []
    with pytest.raises(RuntimeError, match="boom"):
        for b in tloader.PrefetchLoader(gen()):
            out.append(b)
    assert out == [{"x": 1}]

    def slow():
        yield {"x": 1}
        time.sleep(2.0)
        yield {"x": 2}

    it = iter(tloader.PrefetchLoader(slow(), timeout=0.2))
    assert next(it) == {"x": 1}
    with pytest.raises(queue.Empty):
        next(it)


def test_prefetch_loader_hooks_and_copy_to_the_cpu():
    """The device hook (``Preprocess.device_preprocess``) then the copy:
    ``StreamCopy("cpu")`` gives CPU tensors equal to the numpy batch; the
    loader records each batch's host time and the consumer's wait."""
    class P(tloader.Preprocess):
        def has_device_preprocess(self):
            return True

        def device_preprocess(self, batch):
            return {**batch, "extra": np.int32([7])}

    batches = [{"ids": np.arange(6, dtype=np.int32).reshape(2, 3) + i,
                "mask": np.arange(6).reshape(2, 3) < i} for i in range(4)]
    loader = tloader.PrefetchLoader(batches, preprocess=P(),
                                    device_put=tloader.StreamCopy("cpu"))
    out = list(loader)
    assert len(out) == 4 and len(loader.host_s) == 4
    assert len(loader.wait_s) == 5          # the last wait meets the end
    for got, want in zip(out, batches):
        assert got["ids"].device.type == "cpu"
        assert got["ids"].dtype == torch.int32
        assert got["mask"].dtype == torch.bool
        for k in want:
            assert torch.equal(got[k], torch.from_numpy(want[k]))
        assert got["extra"].tolist() == [7]


def _worker_stream(worker_id, num_workers):
    return ({"w": worker_id, "i": i} for i in range(3))


def test_multiprocess_loader_finite_epochs_and_errors():
    loader = tloader.MultiprocessLoader(
        _worker_stream, num_workers=2,
        cpu_preprocess=lambda s: {**s, "p": np.ones(2)})
    out = list(loader)
    assert sorted((s["w"], s["i"]) for s in out) == [
        (w, i) for w in (0, 1) for i in range(3)]
    assert all(isinstance(s["p"], np.ndarray) for s in out)
    assert len(list(loader)) == 6            # a second epoch

    def broken(worker_id, num_workers):
        raise RuntimeError("worker boom")

    with pytest.raises(RuntimeError, match="data worker failed"):
        list(tloader.MultiprocessLoader(broken, num_workers=1))
