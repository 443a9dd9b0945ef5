"""Instruction-tuning corpus registry (VideoChat2-IT layout), the port's
copy of stllm_tpu/data/instruction_data.py.

Same corpus keys and annotation layout as the reference's ``available_corpus``
(reference: stllm/datasets/datasets/instruction_data.py:24-191): each entry is
``[annotation_json, media_root]`` for images or
``[annotation_json, media_root, "video"]`` for videos. The reference hardcodes
'/Path/to/MVBench/VideoChat2-IT' and 'your_data_path/...' — here both roots
come from config/env (STLLM_ANNO_ROOT / STLLM_DATA_ROOT) so the same YAMLs
work unmodified once roots are set.
"""

from __future__ import annotations

import os
from typing import Dict, List

# (relative annotation path, relative media root[, "video"])
_CORPUS_SPEC: Dict[str, List[str]] = {
    # image
    "llava_full": ["image/llava/llava_full.json", "coco_caption"],
    "caption_coco": ["image/caption/coco/train.json", "coco_caption"],
    "caption_llava": ["image/caption/llava/train.json", "coco_caption"],
    "caption_minigpt4": ["image/caption/minigpt4/train.json", "minigpt4/image"],
    "caption_paragraph_captioning": [
        "image/caption/paragraph_captioning/train.json",
        "m3it/image-paragraph-captioning"],
    "caption_textcaps": ["image/caption/textcaps/train.json", "m3it/textcap"],
    "classification_imagenet": ["image/classification/imagenet/train.json", "m3it/imagenet"],
    "classification_coco_itm": ["image/classification/coco_itm/train.json", "m3it/coco-itm"],
    "conversation_llava": ["image/conversation/llava/train.json", "coco_caption"],
    "reasoning_clevr": ["image/reasoning/clevr/train.json", "m3it/clevr"],
    "reasoning_visual_mrc": ["image/reasoning/visual_mrc/train.json", "m3it/visual-mrc"],
    "reasoning_llava": ["image/reasoning/llava/train.json", "coco_caption"],
    "vqa_vqav2": ["image/vqa/vqav2/train.json", "m3it/vqa-v2"],
    "vqa_gqa": ["image/vqa/gqa/train.json", "m3it/gqa"],
    "vqa_okvqa": ["image/vqa/okvqa/train.json", "m3it/okvqa"],
    "vqa_a_okvqa": ["image/vqa/a_okvqa/train.json", "m3it/a-okvqa"],
    "vqa_viquae": ["image/vqa/viquae/train.json", "m3it/viquae"],
    "vqa_ocr_vqa": ["image/vqa/ocr_vqa/train.json", "m3it/ocr-vqa"],
    "vqa_text_vqa": ["image/vqa/text_vqa/train.json", "m3it/text-vqa"],
    "vqa_st_vqa": ["image/vqa/st_vqa/train.json", "m3it/st-vqa"],
    "vqa_docvqa": ["image/vqa/docvqa/train.json", "m3it/docvqa"],
    # video
    "caption_textvr": ["video/caption/textvr/train.json", "TextVR/Video", "video"],
    "caption_videochat": ["video/caption/videochat/train.json", "WebVid10M", "video"],
    "caption_webvid": ["video/caption/webvid/train.json", "WebVid2M", "video"],
    "caption_youcook2": ["video/caption/youcook2/train.json", "youcook2/split_videos", "video"],
    "classification_k710": ["video/classification/k710/train.json", "", "video"],
    "classification_ssv2": ["video/classification/ssv2/train.json", "video_pub/ssv2_video", "video"],
    "conversation_videochat1": ["video/conversation/videochat1/train_flat.json", "WebVid10M", "video"],
    "conversation_videochat2": ["video/conversation/videochat2/train.json", "internvid", "video"],
    "caption_videochatgpt": ["video/conversation/videochatgpt/train_full_flat.json",
                             "ANet/ANet_320p_fps30", "video"],
    "reasoning_next_qa": ["video/reasoning/next_qa/train.json", "nextqa", "video"],
    "reasoning_clevrer_qa": ["video/reasoning/clevrer_qa/train.json", "clevrer/video_train", "video"],
    "reasoning_clevrer_mc": ["video/reasoning/clevrer_mc/train.json", "clevrer/video_train", "video"],
    "vqa_ego_qa": ["video/vqa/ego_qa/train.json", "EgoQA/split_videos", "video"],
    "vqa_tgif_frame_qa": ["video/vqa/tgif_frame_qa/train.json", "tgif", "video"],
    "vqa_tgif_transition_qa": ["video/vqa/tgif_transition_qa/train.json", "tgif", "video"],
    "vqa_webvid_qa": ["video/vqa/webvid_qa/train.json", "WebVid2M", "video"],
}


def build_corpus(anno_root: str = None, data_root: str = None) -> Dict[str, List[str]]:
    """Materialize available_corpus with concrete roots."""
    anno_root = anno_root or os.environ.get("STLLM_ANNO_ROOT", "/data/VideoChat2-IT")
    data_root = data_root or os.environ.get("STLLM_DATA_ROOT", "/data")
    out = {}
    for name, spec in _CORPUS_SPEC.items():
        entry = [os.path.join(anno_root, spec[0]), os.path.join(data_root, spec[1])]
        if len(spec) == 3:
            entry.append("video")
        out[name] = entry
    return out


available_corpus = build_corpus()
