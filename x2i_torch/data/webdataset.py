"""WebDataset-style tar-shard input pipeline, the counterpart of
``x2i_tpu/data/webdataset.py``, with its semantics and its seeds.

The reference reads training data as webdataset tar shards through
ResampledShards -> tarfile_to_samples -> decode(pilrgb) -> key_verifier ->
map(preproc). The same stages are plain composable iterators here:

  * brace-expansion shard lists ("{00000..00099}.tar");
  * infinite resampling with per-host sharding: each host draws from its
    own slice of the shards with ``random.Random(seed + 17 * host)``, so
    the same seed and host give JAX's shard order. The host is the
    ``torch.distributed`` rank when a process group is initialized (JAX
    reads ``jax.process_index()``), else 0 of 1;
  * warn-and-continue error handling;
  * samples grouped by the webdataset convention: files sharing a basename
    before the first dot form one sample keyed by extension.

``tar_samples`` walks a shard with the native reader (``native_tar.py``)
where the archive allows it, else with the ``tarfile`` module.
``decode_sample`` imports PIL only for a sample with an image member, so
caption-only shards decode where PIL is missing.
"""

from __future__ import annotations

import io
import json
import logging
import os
import random
import re
import tarfile
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

log = logging.getLogger("x2i_torch.data")

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")
IMAGE_EXTS = ("jpg", "jpeg", "png", "webp", "bmp")


def expand_urls(urls) -> List[str]:
    """'a/{000..002}.tar' -> ['a/000.tar', 'a/001.tar', 'a/002.tar']."""
    if isinstance(urls, (list, tuple)):
        out: List[str] = []
        for u in urls:
            out.extend(expand_urls(u))
        return out
    m = _BRACE_RE.search(urls)
    if not m:
        return [urls]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    return [urls[:m.start()] + str(i).zfill(width) + urls[m.end():]
            for i in range(int(lo), int(hi) + 1)]


def host_rank() -> Tuple[int, int]:
    """(this host's index, the host count): the ``torch.distributed`` rank
    and world size when a process group is initialized, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardSampler:
    """Infinite (or single-epoch) shard stream with per-host sharding,
    like wds.ResampledShards: each draw is an independent uniform choice,
    so hosts never need coordination."""

    def __init__(self, urls, seed: int = 0, resample: bool = True,
                 host_index: Optional[int] = None,
                 host_count: Optional[int] = None):
        self.urls = expand_urls(urls)
        if not self.urls:
            raise ValueError("no shards")
        if host_index is None:
            host_index, host_count = host_rank()
        self.host_index = host_index
        self.host_count = host_count or 1
        self.resample = resample
        self.rng = random.Random(seed + 17 * self.host_index)

    def __iter__(self) -> Iterator[str]:
        mine = self.urls[self.host_index::self.host_count]
        if not mine:
            # fewer shards than hosts: resampling from the full list is the
            # wds.ResampledShards norm, but a single epoch would be the
            # same epoch on every host -- refuse that
            if not self.resample:
                raise ValueError(
                    f"ShardSampler: {len(self.urls)} shard(s) across "
                    f"{self.host_count} hosts leaves host "
                    f"{self.host_index} empty; a resample=False epoch "
                    f"would be duplicated per host. Provide >= host_count "
                    f"shards or use resample=True.")
            log.warning(
                "ShardSampler: %d shard(s) < %d hosts; host %d resamples "
                "from the full list (cross-host duplicates expected)",
                len(self.urls), self.host_count, self.host_index)
            mine = self.urls
        if self.resample:
            while True:
                yield self.rng.choice(mine)
        else:
            order = list(mine)
            self.rng.shuffle(order)
            yield from order


def warn_and_continue(exn: Exception) -> bool:
    log.warning("data pipeline error (continuing): %r", exn)
    return True


def group_members(members: Iterable[Tuple[str, Callable[[], bytes]]],
                  url: str) -> Iterator[Dict[str, Any]]:
    """(member name, read) pairs in archive order -> webdataset samples
    {"__key__", "__url__", "<ext>": bytes}: consecutive members with one
    basename before the first dot form a sample; names without a dot are
    skipped."""
    current_key = None
    sample: Dict[str, Any] = {}
    for name, read in members:
        base = os.path.basename(name)
        if "." not in base:
            continue
        key, ext = base.split(".", 1)
        data = read()
        if key != current_key:
            if current_key is not None and sample:
                yield sample
            current_key = key
            sample = {"__key__": key, "__url__": url}
        sample[ext.lower()] = data
    if current_key is not None and sample:
        yield sample


def _python_members(tf: tarfile.TarFile):
    for member in tf:
        if member.isfile():
            yield member.name, tf.extractfile(member).read


def tar_samples(shards: Iterable[str],
                handler: Callable[[Exception], bool] = warn_and_continue,
                use_native: bool = True) -> Iterator[Dict[str, Any]]:
    """Iterate tar shards, grouping member files into samples. Yields
    dicts {"__key__": basename, "__url__": shard, "<ext>": bytes, ...}.
    The native reader takes the shards it can index; the others (pax
    archives) go through ``tarfile``. A shard that fails is passed to
    ``handler``, which continues (True) or re-raises."""
    for shard in shards:
        try:
            if use_native:
                from x2i_torch.data.native_tar import native_tar_samples
                it = native_tar_samples(shard)
                if it is not None:
                    yield from it
                    continue
            with tarfile.open(shard, mode="r|*") as tf:
                yield from group_members(_python_members(tf), shard)
        except StopIteration:
            raise
        except Exception as exn:              # noqa: BLE001
            if not handler(exn):
                raise


def decode_sample(sample: Dict[str, Any],
                  image_mode: str = "RGB") -> Dict[str, Any]:
    """'pilrgb'-style decode: images -> PIL images in ``image_mode``, json
    -> its object, txt -> str, anything else as it is. PIL is imported
    only for a sample that has an image member."""
    out: Dict[str, Any] = {}
    for key, val in sample.items():
        if key.startswith("__") or not isinstance(val, (bytes, bytearray)):
            out[key] = val
            continue
        ext = key.split(".")[-1]
        if ext in IMAGE_EXTS:
            from PIL import Image
            out[key] = Image.open(io.BytesIO(val)).convert(image_mode)
        elif ext == "json":
            out[key] = json.loads(val)
        elif ext in ("txt", "text", "caption"):
            out[key] = val.decode("utf-8")
        else:
            out[key] = val
    return out


def key_verifier(required: Sequence[str],
                 handler: Callable[[Exception], bool] = warn_and_continue):
    def stage(samples):
        for s in samples:
            if all(k in s for k in required):
                yield s
            elif not handler(KeyError(
                    f"sample {s.get('__key__')} missing keys "
                    f"{set(required) - set(s)}")):
                raise KeyError(required)
    return stage


class Pipeline:
    """Composable stage pipeline. Stages are callables iter -> iter, or the
    convenience wrappers .map / .decode / .verify / .batch."""

    def __init__(self, source: Iterable):
        self.source = source
        self.stages: List[Callable] = []

    def compose(self, stage: Callable) -> "Pipeline":
        self.stages.append(stage)
        return self

    def map(self, fn: Callable,
            handler: Callable[[Exception], bool] = warn_and_continue
            ) -> "Pipeline":
        def stage(samples):
            for s in samples:
                try:
                    yield fn(s)
                except StopIteration:
                    raise
                except Exception as exn:      # noqa: BLE001
                    if not handler(exn):
                        raise
        return self.compose(stage)

    def decode(self, image_mode: str = "RGB") -> "Pipeline":
        return self.map(lambda s: decode_sample(s, image_mode))

    def verify(self, required: Sequence[str]) -> "Pipeline":
        return self.compose(key_verifier(required))

    def batch(self, batch_size: int, collate: Callable) -> "Pipeline":
        def stage(samples):
            buf = []
            for s in samples:
                buf.append(s)
                if len(buf) == batch_size:
                    yield collate(buf)
                    buf = []
        return self.compose(stage)

    def __iter__(self):
        it = iter(self.source)
        for stage in self.stages:
            it = stage(it)
        return it
