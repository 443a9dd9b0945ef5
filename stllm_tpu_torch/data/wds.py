"""Webdataset-style tar-shard pipeline on the stdlib ``tarfile``
(stllm_tpu/data/wds.py), for the CC-SBU and LAION image-text pretraining
sets: resampled shards, a shuffle buffer, a decode, a map. Files that share
a basename within a tar form one sample ({"jpg": bytes, "txt": bytes,
"json": bytes, "__key__": name}).

``decode_image`` needs cv2, imported when it is called. The card's machine
has no cv2, so these pipelines are host code; the port's tests run them on
the CPU.
"""

from __future__ import annotations

import json
import os
import tarfile
from glob import glob
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np


def expand_shards(urls) -> List[str]:
    """Accept a list, a glob pattern, or a brace range 'shard-{0000..0009}.tar'."""
    if isinstance(urls, (list, tuple)):
        return list(urls)
    if "{" in urls and ".." in urls:
        pre, rest = urls.split("{", 1)
        rng, post = rest.split("}", 1)
        lo, hi = rng.split("..")
        width = len(lo)
        return [f"{pre}{i:0{width}d}{post}" for i in range(int(lo), int(hi) + 1)]
    if any(c in urls for c in "*?["):
        return sorted(glob(urls))
    return [urls]


def tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Group tar members by key prefix (webdataset convention)."""
    with tarfile.open(path) as tf:
        current: Dict[str, bytes] = {}
        key: Optional[str] = None
        for member in tf:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            k, _, ext = base.partition(".")
            if key is not None and k != key and current:
                current["__key__"] = key
                yield current
                current = {}
            key = k
            fobj = tf.extractfile(member)
            if fobj is not None:
                current[ext] = fobj.read()
        if current:
            current["__key__"] = key
            yield current


def decode_image(data: bytes) -> np.ndarray:
    import cv2

    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if arr is None:
        raise IOError("image decode failed")
    return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)


class WebDatasetPipeline:
    """Resampled-shard infinite pipeline with a shuffle buffer.

    map_fn receives the raw sample dict and returns the final sample
    (or raises to skip)."""

    def __init__(self, urls, map_fn: Callable[[Dict], Dict],
                 shuffle_buffer: int = 1000, seed: int = 0,
                 resample: bool = True):
        self.shards = expand_shards(urls)
        if not self.shards:
            raise ValueError(f"no shards match {urls!r}")
        self.map_fn = map_fn
        self.shuffle_buffer = shuffle_buffer
        self.resample = resample
        self.rng = np.random.default_rng(seed)

    def _shard_iter(self) -> Iterator[str]:
        if self.resample:
            while True:
                yield self.shards[int(self.rng.integers(len(self.shards)))]
        else:
            yield from self.shards

    def __iter__(self) -> Iterator[Dict]:
        buf: List[Dict] = []
        for shard in self._shard_iter():
            for raw in tar_samples(shard):
                try:
                    sample = self.map_fn(raw)
                except Exception:  # noqa: BLE001 — skip undecodable samples
                    continue
                if self.shuffle_buffer <= 1:
                    yield sample
                    continue
                buf.append(sample)
                if len(buf) >= self.shuffle_buffer:
                    i = int(self.rng.integers(len(buf)))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            if not self.resample:
                break
        while buf:
            i = int(self.rng.integers(len(buf)))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()


def cc_sbu_map(vis_processor=None, text_processor=None) -> Callable[[Dict], Dict]:
    """CC-SBU sample: jpg + json{caption} (reference: cc_sbu_dataset.py:9-47)."""
    def fn(raw: Dict) -> Dict:
        image = decode_image(raw["jpg"])
        caption = json.loads(raw["json"])["caption"]
        if vis_processor:
            image = vis_processor(image)
        if text_processor:
            caption = text_processor(caption)
        return {"image": image, "answer": caption,
                "instruction_input": "<ImageHere> "}
    return fn


def laion_map(vis_processor=None, text_processor=None) -> Callable[[Dict], Dict]:
    """LAION sample: jpg + txt caption (reference: laion_dataset.py:12-30)."""
    def fn(raw: Dict) -> Dict:
        image = decode_image(raw["jpg"])
        caption = raw["txt"].decode("utf-8")
        if vis_processor:
            image = vis_processor(image)
        if text_processor:
            caption = text_processor(caption)
        return {"image": image, "answer": caption,
                "instruction_input": "<ImageHere> "}
    return fn
