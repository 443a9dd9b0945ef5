"""Dataset assembly utilities (stllm_tpu/data/data_utils.py; reference:
stllm/datasets/data_utils.py:33-195 — ChainDataset, move_to_cuda/prepare_sample,
reorg_datasets_by_split, concat_datasets; and base_dataset.py:40-72 —
ConcatDataset shared-key collation)."""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, List, Mapping, Sequence

import numpy as np
import torch

from stllm_tpu_torch.common.device import resolve_device

logger = logging.getLogger(__name__)


class ConcatDataset:
    """Concatenation of map datasets; collation keeps only the keys shared by
    every sample (reference: base_dataset.py:40-72)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        di = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[di][idx - int(self._offsets[di])]

    @staticmethod
    def shared_key_samples(samples: Sequence[Mapping]) -> List[Dict]:
        shared = set(samples[0])
        for s in samples[1:]:
            shared &= set(s)
        return [{k: s[k] for k in s if k in shared} for s in samples]


class ChainDataset:
    """Ratio-weighted chaining of iterable datasets (reference:
    data_utils.py:33-63 — webdataset chaining with sampling ratios)."""

    def __init__(self, datasets: Sequence, ratios: Sequence[float] = None,
                 seed: int = 0):
        self.datasets = list(datasets)
        if ratios is None:
            ratios = [1.0] * len(self.datasets)
        total = float(sum(ratios))
        self.ratios = [r / total for r in ratios]
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        its = [iter(d) for d in self.datasets]
        while True:
            i = int(self.rng.choice(len(its), p=self.ratios))
            yield next(its[i])


def prepare_sample(samples: Mapping, device=None) -> Dict:
    """Host batch -> tensors on ``device`` (the card unless the caller names
    another): the reference's move_to_cuda / prepare_sample,
    data_utils.py:83-96. Arrays, tensors and numbers move; other values
    (strings, lists) pass through."""
    dev = resolve_device(device)
    out = {}
    for k, v in samples.items():
        if isinstance(v, (np.ndarray, torch.Tensor, int, float, bool, np.number)):
            out[k] = torch.as_tensor(v, device=dev)
        else:
            out[k] = v
    return out


def reorg_datasets_by_split(datasets: Mapping[str, Mapping]) -> Dict[str, List]:
    """{name: {split: ds}} -> {split: [ds, ...]} (reference:
    data_utils.py:99-122)."""
    out: Dict[str, List] = {}
    for name, split_map in datasets.items():
        for split, ds in split_map.items():
            out.setdefault(split, []).append(ds)
    return out


def concat_datasets(datasets: Dict[str, List]) -> Dict[str, Any]:
    """Concatenate each split's map datasets; iterable datasets are chained
    (reference: data_utils.py:125-195)."""
    out: Dict[str, Any] = {}
    for split, ds_list in datasets.items():
        iterable = [d for d in ds_list if not hasattr(d, "__getitem__")]
        mapstyle = [d for d in ds_list if hasattr(d, "__getitem__")]
        if iterable and mapstyle:
            logger.warning("split %s mixes iterable and map datasets; "
                           "chaining iterables separately", split)
        if len(mapstyle) > 1:
            merged: Any = ConcatDataset(mapstyle)
        elif mapstyle:
            merged = mapstyle[0]
        else:
            merged = None
        if iterable:
            chained = ChainDataset(iterable) if len(iterable) > 1 else iterable[0]
            merged = chained if merged is None else (merged, chained)
        out[split] = merged
    return out
