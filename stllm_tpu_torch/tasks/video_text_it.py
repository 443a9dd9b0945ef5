"""Instruction-tuning tasks (stllm_tpu/tasks/video_text_it.py):
``video_text_it`` builds ITImg/ITVid datasets from ``available_corpus`` and
each dataset's config section; the ``simple`` prompt mode follows the
model's ``qformer_text_input``.
"""

from __future__ import annotations

from typing import Dict

from stllm_tpu_torch.common.registry import Registry
from stllm_tpu_torch.tasks.base_task import BaseTask


def get_media_type(dataset_info) -> str:
    return "video" if len(dataset_info) == 3 and dataset_info[2] == "video" else "image"


@Registry.register_task("image_text_pretrain")
class ImageTextPretrainTask(BaseTask):
    def evaluation(self, model, data_loader, **kwargs):  # noqa: D102
        return []       # the reference's pretraining task evaluates nothing


@Registry.register_task("video_text_it")
class VideoTextItTask(ImageTextPretrainTask):
    def build_datasets(self, cfg, transform=None, seed: int = 42) -> Dict:
        """{name: {"train": dataset}} for each entry of ``cfg.datasets_cfg``."""
        from stllm_tpu_torch.data.datasets import ITImgTrainDataset, ITVidTrainDataset
        from stllm_tpu_torch.data.instruction_data import available_corpus

        datasets: Dict = {}
        datasets_config = cfg.datasets_cfg
        assert len(datasets_config) > 0, "At least one dataset has to be specified."
        simple = cfg.model_cfg.get("qformer_text_input", False)
        for name in datasets_config:
            dataset_config = dict(datasets_config[name] or {})
            dataset_info = available_corpus[name]
            cls = (ITImgTrainDataset if get_media_type(dataset_info) == "image"
                   else ITVidTrainDataset)
            datasets[name] = {"train": cls(ann_file=dataset_info, simple=simple,
                                           transform=transform, seed=seed, **dataset_config)}
        return datasets
