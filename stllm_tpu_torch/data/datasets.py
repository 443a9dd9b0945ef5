"""Instruction-tuning datasets (VideoChat2-IT format), the port's copy of
stllm_tpu/data/datasets.py.

Re-design of the reference IT datasets
(reference: stllm/datasets/datasets/image_video_itdatasets.py:168-319).
Behavior preserved:
  - prompt format: ``system + ###Human: <Video><ImageHere></Video> {q}
    ###Assistant: `` with the ' '-terminated end_signal, simple-mode inline
    instruction concatenation (process_qa, :223-250);
  - random QA-list shuffle per sample (:229-231);
  - per-annotation clip [start, end] windows and the optional "The video
    contains N frames sampled at T seconds." second message (:297-310 — the
    reference computes the seconds list in a commented line; we implement the
    intended behavior);
  - corrupt-media resilience: decode failures retry ``num_tries`` times with
    a random replacement index (:77-105), and any __getitem__ exception falls
    back to a random other sample (:263-266, :316-319).

Every such retry and fallback is counted in the dataset's ``retries``
(thread-safe: the loaders call ``__getitem__`` from a thread pool), so a
run can tell that a missing decoder turned every sample into retries.

Samples are plain dicts with NumPy frames (THWC); the device bridge is
stllm_tpu_torch.data.collate.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from stllm_tpu_torch.data.video_reader import VIDEO_READER_FUNCS

logger = logging.getLogger(__name__)


class ITImgTrainDataset:
    """Image instruction dataset (reference: ITImgTrainDataset, :168-266)."""

    media_type = "image"

    def __init__(
        self,
        ann_file: Sequence[str],
        transform=None,
        simple: bool = False,
        system: str = "",
        role: Tuple[str, str] = ("Human", "Assistant"),
        start_token: str = "<Image>",
        end_token: str = "</Image>",
        random_shuffle: bool = True,
        seed: Optional[int] = None,
    ):
        if len(ann_file) == 3 and ann_file[2] == "video":
            self.media_type = "video"
        self.label_file, self.data_root = ann_file[:2]
        with open(self.label_file) as f:
            self.anno = json.load(f)
        self.num_examples = len(self.anno)
        self.transform = transform

        if system and not system.endswith(" "):
            raise ValueError(
                "`system` must end with a single space so that the '###' "
                "turn separator that follows it tokenizes as one token "
                "(prompt-format requirement shared with the reference)."
            )
        self.begin_signal = "###"
        self.end_signal = " "
        self.start_token = start_token
        self.end_token = end_token
        self.system = system
        self.role = role
        self.random_shuffle = random_shuffle
        self.simple = simple
        self.rng = np.random.default_rng(seed)
        self._init_retries()

    def _init_retries(self) -> None:
        self.retries = 0
        self._retry_lock = threading.Lock()

    def _count_retry(self) -> None:
        with self._retry_lock:
            self.retries += 1

    def __len__(self) -> int:
        return self.num_examples

    def get_anno(self, index: int) -> Dict:
        record = self.anno[index]
        anno = {
            "image": os.path.join(self.data_root, record[self.media_type]),
            "qa": record["QA"],
        }
        window = {k: record[k] for k in ("start", "end") if k in record}
        if len(window) == 2:  # clip bounds only meaningful as a pair
            anno.update(window)
        return anno

    def _compose_prompt(self, question: str, instruction: str, msg: str) -> str:
        """Assemble the full conversation prompt, ending at the assistant cue.

        Two layouts (byte-identical to the reference's output strings,
        image_video_itdatasets.py:223-250 — pinned by
        tests/test_datasets.py golden strings):

          normal : {system}{instruction}###Human: <Video><ImageHere></Video>
                   {msg} {question} ###Assistant:
          simple : {system}<ImageHere>###Human: {instruction}{msg}{question}
                   ###Assistant:    (instruction inlined, no media tokens)
        """
        human, assistant = self.role
        sep, sp = self.begin_signal, self.end_signal
        if self.simple:
            turn = f"{instruction}{msg.rstrip()}{question}"
            return (f"{self.system}<ImageHere>"
                    f"{sep}{human}: {turn}{sp}{sep}{assistant}: ")
        media = f"{self.start_token}<ImageHere>{self.end_token}"
        turn = f"{media}{msg.rstrip()} {question}"
        return (f"{self.system}{instruction}"
                f"{sep}{human}: {turn}{sp}{sep}{assistant}: ")

    def process_qa(self, qa: List[Dict], msg: str = "") -> Tuple[str, str]:
        """Pick one QA pair (random when shuffling) and build its prompt."""
        pick = qa[0]
        if self.random_shuffle and len(qa) > 1:
            pick = qa[int(self.rng.integers(0, len(qa)))]
        instruction = pick.get("i") or ""
        if instruction:
            instruction += self.end_signal
        return self._compose_prompt(pick["q"], instruction, msg), pick["a"]

    def load_image(self, path: str) -> np.ndarray:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise IOError(f"failed to read image {path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return self.transform(img) if self.transform else img

    def __getitem__(self, index: int) -> Dict:
        try:
            ann = self.get_anno(index)
            image = self.load_image(ann["image"])
            instruction, answer = self.process_qa(ann["qa"])
            return {
                "image": image[None] if image.ndim == 3 else image,  # (1,H,W,C)
                "answer": answer,
                "image_id": index,
                "instruction_input": instruction,
            }
        except Exception as e:  # noqa: BLE001 — reference-style random fallback
            logger.warning("Caught exception %s when loading %s", e, index)
            self._count_retry()
            return self[int(self.rng.integers(0, len(self)))]


class ITVidTrainDataset(ITImgTrainDataset):
    """Video instruction dataset (reference: ITVidTrainDataset, :268-319)."""

    media_type = "video"

    def __init__(
        self,
        ann_file: Sequence[str],
        transform=None,
        simple: bool = False,
        num_frames: int = 4,
        video_reader_type: str = "decord",
        sample_type: str = "rand",
        num_tries: int = 3,
        system: str = "",
        role: Tuple[str, str] = ("Human", "Assistant"),
        start_token: str = "<Video>",
        end_token: str = "</Video>",
        add_second_msg: bool = False,
        random_shuffle: bool = True,
        seed: Optional[int] = None,
    ):
        super().__init__(
            ann_file, transform, simple=simple, system=system, role=role,
            start_token=start_token, end_token=end_token,
            random_shuffle=random_shuffle, seed=seed,
        )
        self.num_frames = num_frames
        self.video_reader = VIDEO_READER_FUNCS[video_reader_type]
        self.sample_type = sample_type
        self.num_tries = num_tries
        self.add_second_msg = add_second_msg
        self.max_num_frames = -1

    def get_anno(self, index: int) -> Dict:
        if "num_frames" in self.anno[index]:
            self.max_num_frames = self.anno[index]["num_frames"]
        return super().get_anno(index)

    def _load_video(self, index: int, path: str, clip):
        """Retry-with-random-replacement decode (reference: :77-105)."""
        for _ in range(self.num_tries):
            try:
                frames, frame_indices, duration = self.video_reader(
                    path, self.num_frames, self.sample_type,
                    max_num_frames=self.max_num_frames, clip=clip,
                    rng=self.rng,
                )
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "Caught exception %s when loading video %s, randomly "
                    "sample a new video as replacement", e, path,
                )
                self._count_retry()
                index = int(self.rng.integers(0, len(self)))
                ann = self.get_anno(index)
                path = ann["image"]
                clip = [ann["start"], ann["end"]] if "start" in ann else None
                continue
            if self.transform:
                frames = self.transform(frames)
            # seconds list for the second message (the reference's intended
            # computation, image_video_itdatasets.py:97 commented line)
            if duration and len(frame_indices):
                fps = max(frame_indices) / duration if duration > 0 else 1.0
                sec = [str(round(f / max(fps, 1e-6), 1)) for f in frame_indices]
            else:
                sec = [str(i) for i in range(len(frame_indices))]
            return frames, index, sec
        raise RuntimeError(
            f"Failed to fetch video after {self.num_tries} tries. "
            f"This might indicate that you have many corrupted videos."
        )

    def __getitem__(self, index: int) -> Dict:
        try:
            ann = self.get_anno(index)
            clip = [ann["start"], ann["end"]] if "start" in ann else None
            video, index, sec = self._load_video(index, ann["image"], clip)
            msg = ""
            if self.add_second_msg:
                msg = (f" The video contains {len(sec)} frames sampled at "
                       f"{', '.join(sec)} seconds. ")
            instruction, answer = self.process_qa(ann["qa"], msg)
            return {
                "image": video,
                "answer": answer,
                "image_id": index,
                "instruction_input": instruction,
                "video_len": sec,
            }
        except Exception as e:  # noqa: BLE001
            logger.warning("Caught exception %s when loading video idx %s", e, index)
            self._count_retry()
            return self[int(self.rng.integers(0, len(self)))]


def pre_text(text: str, pre: bool = True) -> str:
    """Caption cleanup for pretraining datasets (reference:
    stllm/datasets/datasets/utils.py pre_text — lowercase, strip punctuation)."""
    import re

    if not pre:
        return text
    text = re.sub(r"([,.'!?\"()*#:;~])", "", text.lower())
    text = text.replace("-", " ").replace("/", " ").replace("<person>", "person")
    text = re.sub(r"\s{2,}", " ", text)
    return text.rstrip("\n").strip(" ")


class PTImgTrainDataset(ITImgTrainDataset):
    """Caption pretraining dataset: (media, caption, idx) tuples
    (reference: image_video_itdatasets.py:107-145)."""

    media_type = "image"

    def __init__(self, ann_file: Sequence[str], transform=None,
                 pre_text: bool = True, seed: Optional[int] = None):
        if len(ann_file) == 3 and ann_file[2] == "video":
            self.media_type = "video"
        self.label_file, self.data_root = ann_file[:2]
        with open(self.label_file) as f:
            self.anno = json.load(f)
        self.num_examples = len(self.anno)
        self.transform = transform
        self.pre_text = pre_text
        self.rng = np.random.default_rng(seed)
        self._init_retries()

    def get_anno(self, index: int) -> Dict:
        filename = self.anno[index][self.media_type]
        return {"image": os.path.join(self.data_root, filename),
                "caption": self.anno[index]["caption"]}

    def __getitem__(self, index: int):
        try:
            ann = self.get_anno(index)
            image = self.load_image(ann["image"])
            caption = pre_text(ann["caption"], self.pre_text)
            return image, caption, index
        except Exception as e:  # noqa: BLE001
            logger.warning("Caught exception %s when loading %s", e, index)
            self._count_retry()
            return self[int(self.rng.integers(0, len(self)))]


class PTVidTrainDataset(PTImgTrainDataset):
    """(reference: image_video_itdatasets.py:147-166)"""

    media_type = "video"

    def __init__(self, ann_file: Sequence[str], transform=None,
                 num_frames: int = 4, video_reader_type: str = "decord",
                 sample_type: str = "rand", num_tries: int = 3,
                 pre_text: bool = True, seed: Optional[int] = None):
        super().__init__(ann_file, transform, pre_text=pre_text, seed=seed)
        self.num_frames = num_frames
        self.video_reader = VIDEO_READER_FUNCS[video_reader_type]
        self.sample_type = sample_type
        self.num_tries = num_tries
        self.max_num_frames = -1

    def __getitem__(self, index: int):
        try:
            ann = self.get_anno(index)
            frames, _, _ = self.video_reader(
                ann["image"], self.num_frames, self.sample_type,
                max_num_frames=self.max_num_frames, rng=self.rng)
            if self.transform:
                frames = self.transform(frames)
            caption = pre_text(ann["caption"], self.pre_text)
            return frames, caption, index
        except Exception as e:  # noqa: BLE001
            logger.warning("Caught exception %s when loading %s", e, index)
            self._count_retry()
            return self[int(self.rng.integers(0, len(self)))]
