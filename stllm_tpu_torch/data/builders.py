"""Config-driven dataset builders (stllm_tpu/data/builders.py):
``BaseDatasetBuilder`` builds its processors by registry name and the split
datasets from ``build_info.storage``; the webdataset sets run on
``data/wds.py``. Each builder's default YAML is under
``configs/datasets/<name>/``.

Processors that resize take ``device``; a builder given ``device`` passes
it to each of its processors (the CUDA card when none is named).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

from stllm_tpu_torch.common.registry import Registry


class BaseDatasetBuilder:
    DATASET_CONFIG_DICT: Dict[str, str] = {}
    train_dataset_cls = None

    def __init__(self, cfg=None, device=None):
        from stllm_tpu_torch.common.config import load_yaml, wrap

        if cfg is None:
            root = Path(__file__).resolve().parent.parent
            defaults = load_yaml(root / self.default_config_path())
            name = next(iter(defaults.get("datasets", {})))
            cfg = wrap(defaults["datasets"][name])
        self.config = cfg
        self.device = device
        self.vis_processors = {"train": None, "eval": None}
        self.text_processors = {"train": None, "eval": None}

    @classmethod
    def default_config_path(cls, type: str = "default") -> str:
        return cls.DATASET_CONFIG_DICT[type]

    def build_processors(self) -> None:
        """Resolve processors by registry name (reference:
        base_dataset_builder.py:61-86); the image processors run on the
        builder's device."""
        def build(cfg):
            if cfg is None or cfg.get("name") is None:
                return None
            return Registry.get_processor_class(cfg["name"]).from_config(cfg)

        proc = self.config.get("vis_processor", {}) or {}
        for split in ("train", "eval"):
            cfg = proc.get(split)
            if cfg is not None and self.device is not None:
                cfg = {**cfg, "device": self.device}
            self.vis_processors[split] = build(cfg)
        tproc = self.config.get("text_processor", {}) or {}
        for split in ("train", "eval"):
            self.text_processors[split] = build(tproc.get(split))

    def build_datasets(self) -> Dict:
        self.build_processors()
        return self.build()

    def build(self) -> Dict:
        raise NotImplementedError


@Registry.register_builder("cc_sbu")
class CCSBUBuilder(BaseDatasetBuilder):
    DATASET_CONFIG_DICT = {"default": "configs/datasets/cc_sbu/defaults.yaml"}

    def build(self) -> Dict:
        from stllm_tpu_torch.data.wds import WebDatasetPipeline, cc_sbu_map

        storage = self.config["build_info"]["storage"]
        return {"train": WebDatasetPipeline(
            storage,
            cc_sbu_map(self.vis_processors["train"], self.text_processors["train"]),
        )}


@Registry.register_builder("laion")
class LaionBuilder(BaseDatasetBuilder):
    DATASET_CONFIG_DICT = {"default": "configs/datasets/laion/defaults.yaml"}

    def build(self) -> Dict:
        from stllm_tpu_torch.data.wds import WebDatasetPipeline, laion_map

        storage = self.config["build_info"]["storage"]
        return {"train": WebDatasetPipeline(
            storage,
            laion_map(self.vis_processors["train"], self.text_processors["train"]),
        )}


@Registry.register_builder("cc_sbu_align")
class CCSBUAlignBuilder(BaseDatasetBuilder):
    """Aligned caption split (json annotations + image dir, reference:
    image_text_pair_builder.py:75-105)."""

    DATASET_CONFIG_DICT = {"default": "configs/datasets/cc_sbu/align.yaml"}

    def build(self) -> Dict:
        from stllm_tpu_torch.data.datasets import ITImgTrainDataset

        storage = self.config["build_info"]["storage"]
        ann = os.path.join(storage, "filter_cap.json")
        return {"train": ITImgTrainDataset(
            [ann, os.path.join(storage, "image")],
            transform=self.vis_processors["train"])}
