"""Length-grouped index sampling (stllm_tpu/data/samplers_grouped.py), in
numpy: batches samples of similar token length (and of one modality) so the
packer pads less. Multimodal samples carry positive lengths, language-only
samples negative ones. The same ``np.random.Generator`` draws give the same
indices as the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    """Greedy split into num_chunks of equal count balancing summed length
    (reference: stllm_trainer.py:49-68)."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    num_indices_per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    chunk_lengths = [0] * num_chunks
    for index in indices:
        shortest = int(np.argmin(chunk_lengths))
        chunks[shortest].append(index)
        chunk_lengths[shortest] += lengths[index]
        if len(chunks[shortest]) == num_indices_per_chunk:
            chunk_lengths[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               rng: Optional[np.random.Generator] = None,
                               merge: bool = True) -> List[int]:
    rng = rng or np.random.default_rng()
    indices = rng.permutation(len(lengths)).tolist()
    mega = batch_size * world_size
    megabatches = [indices[i:i + mega] for i in range(0, len(lengths), mega)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    return [i for m in megabatches for batch in m for i in batch]


def get_modality_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                                        world_size: int,
                                        rng: Optional[np.random.Generator] = None
                                        ) -> List[int]:
    """Positive lengths = multimodal, negative = language-only; each
    megabatch is single-modality (reference: stllm_trainer.py:71-103)."""
    rng = rng or np.random.default_rng()
    if all(l != 0 for l in lengths) and (all(l > 0 for l in lengths)
                                         or all(l < 0 for l in lengths)):
        return get_length_grouped_indices([abs(l) for l in lengths],
                                          batch_size, world_size, rng)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mm_shuf = [mm[i] for i in rng.permutation(len(mm))]
    lang_shuf = [lang[i] for i in rng.permutation(len(lang))]
    mega = batch_size * world_size

    def to_megabatches(items):
        idx = [i for i, _ in items]
        ln = {i: l for i, l in items}
        grouped = get_length_grouped_indices(
            [ln[i] for i in idx], batch_size, world_size, rng, merge=False)
        remapped = [idx[g] for g in grouped]
        return [remapped[i:i + mega] for i in range(0, len(remapped), mega)]

    megabatches = to_megabatches(mm_shuf) + to_megabatches(lang_shuf)
    order = rng.permutation(len(megabatches))
    return [i for oi in order for i in megabatches[oi]]


class LengthGroupedSampler:
    """Iterates dataset indices grouped by (modality,) length."""

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Sequence[int], seed: int = 0,
                 group_by_modality: bool = False):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = list(lengths)
        self.group_by_modality = group_by_modality
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.lengths)

    def __iter__(self):
        if self.group_by_modality:
            return iter(get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, self.rng))
        return iter(get_length_grouped_indices(
            self.lengths, self.batch_size, self.world_size, self.rng))
