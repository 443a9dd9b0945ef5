"""MVBench multiple-choice eval harness: the port of
stllm_tpu/evalharness/mvbench.py (reference: stllm/test/mvbench/mv_bench.py +
mv_bench_infer.py + stllm/conversation/mvbench_conversation.py).

The 20-task table, the frame indexing (bounded clips and the fps-1 adaptive
count), the qa_template option formatting, the prompt layout (with the kept
tail "Best option:(" as the Assistant prefix), greedy decoding and the
check_ans letter match are the reference's; together they reproduce its
published protocol.

A reference quirk is kept on purpose: its entry script computes
``all_token = ~(video_input == 'mean')`` (mv_bench_infer.py:69), and ``~bool``
is always truthy in Python, so the reference ALWAYS feeds all frame tokens.
``all_token`` defaults to True to match the behaviour actually shipped.

Three routes give the same predictions: ``infer_mvbench`` one video at a
time, ``infer_mvbench_batch`` over same-length groups (``encode_img_mapped``,
right-padded prompts in one generate) and ``infer_mvbench_serving`` through
the continuous ``VideoQAServer``, which yields in completion order.

    python -m stllm_tpu_torch.evalharness.mvbench --cfg-path CFG \
        --anno-path JSON_DIR --data-root VIDEO_DIR --output_dir OUT \
        --output_name NAME [--cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stllm_tpu_torch.data.processors import ChatVideoEvalProcessor
from stllm_tpu_torch.data.samplers import mvbench_frame_indices
from stllm_tpu_torch.models.generation import GenerationConfig, UnsupportedRequest, generate
from stllm_tpu_torch.models.stllm import encode_img, encode_img_mapped, resolve_auto_merge

# (json file, media prefix under data_root, data type, has [start,end] bound)
# reference: mv_bench.py:24-45
DATA_LIST: Dict[str, Tuple[str, str, str, bool]] = {
    "Action Sequence": ("action_sequence.json", "star/Charades_v1_480/", "video", True),
    "Action Prediction": ("action_prediction.json", "star/Charades_v1_480/", "video", True),
    "Action Antonym": ("action_antonym.json", "ssv2_video/", "video", False),
    "Fine-grained Action": ("fine_grained_action.json", "Moments_in_Time_Raw/videos/", "video", False),
    "Unexpected Action": ("unexpected_action.json", "FunQA_test/test/", "video", False),
    "Object Existence": ("object_existence.json", "clevrer/video_validation/", "video", False),
    "Object Interaction": ("object_interaction.json", "star/Charades_v1_480/", "video", True),
    "Object Shuffle": ("object_shuffle.json", "perception/videos/", "video", False),
    "Moving Direction": ("moving_direction.json", "clevrer/video_validation/", "video", False),
    "Action Localization": ("action_localization.json", "sta/sta_video/", "video", True),
    "Scene Transition": ("scene_transition.json", "scene_qa/video/", "video", False),
    "Action Count": ("action_count.json", "perception/videos/", "video", False),
    "Moving Count": ("moving_count.json", "clevrer/video_validation/", "video", False),
    "Moving Attribute": ("moving_attribute.json", "clevrer/video_validation/", "video", False),
    "State Change": ("state_change.json", "perception/videos/", "video", False),
    "Fine-grained Pose": ("fine_grained_pose.json", "nturgbd/", "video", False),
    "Character Order": ("character_order.json", "perception/videos/", "video", False),
    "Egocentric Navigation": ("egocentric_navigation.json", "vlnqa/", "video", False),
    "Episodic Reasoning": ("episodic_reasoning.json", "tvqa/frames_fps3_hq/", "frame", True),
    "Counterfactual Inference": ("counterfactual_inference.json", "clevrer/video_validation/", "video", False),
}

SYSTEM = (
    "Carefully watch the video and pay attention to the cause and sequence of "
    "events, the detail and movement of objects, and the action and pose of "
    "persons. Based on your observations, select the best option that "
    "accurately addresses the question.\n"
)
QUESTION_PROMPT = "\nOnly give the best option."
ANSWER_PROMPT = "Best option:("
RETURN_PROMPT = "("


class MVBenchDataset:
    """Iterates (video frames, question, answer, task_type) samples
    (reference: MVBench_dataset, mv_bench.py:49-218)."""

    def __init__(self, anno_dir: str, data_root: str = "",
                 data_list: Dict = None, num_segments: int = 8,
                 resolution: int = 224, specified_item: Optional[str] = None,
                 normalize: bool = False, device=None):
        # normalize=False (default): frames stay uint8; encode_img
        # CLIP-normalizes them on the device. ``device`` runs the resize
        # (the card unless the caller names another)
        data_list = data_list or DATA_LIST
        if specified_item:
            data_list = {specified_item: data_list[specified_item]}
        self.data_list: List[Dict] = []
        for task, (fname, prefix, dtype, bound) in data_list.items():
            with open(os.path.join(anno_dir, fname)) as f:
                for data in json.load(f):
                    self.data_list.append({
                        "task_type": task,
                        "prefix": os.path.join(data_root, prefix) if data_root else prefix,
                        "data_type": dtype,
                        "bound": bound,
                        "data": data,
                    })
        self.num_segments = num_segments
        self.transform = ChatVideoEvalProcessor(image_size=resolution,
                                                normalize=normalize, device=device)

    def __len__(self) -> int:
        return len(self.data_list)

    def __str__(self) -> str:
        """Per-task counts + random-accuracy summary (reference:
        mv_bench.py:86-108). The reference's accounting adds a stray
        ``1/option_list[k]`` per task into ``correct``; reproduced verbatim
        so the printed numbers match."""
        len_list: Dict[str, int] = {}
        option_list: Dict[str, int] = {}
        for data in self.data_list:
            t = data["task_type"]
            len_list[t] = len_list.get(t, 0) + 1
            option_list[t] = option_list.get(t, 0) + len(
                data["data"]["candidates"])
        correct = 0.0
        total = 0
        res = f"There are {len(self.data_list)} videos as follow:\n"
        for k, v in len_list.items():
            correct += len_list[k]
            total += option_list[k]
            res += (f"{v} for {k} ({option_list[k]} options => "
                    f"{len_list[k]/option_list[k]*100:.2f}%)\n")
            correct = correct + 1 / option_list[k]
        res += f"Total random accuracy: {correct/total*100:.2f}%"
        return res.rstrip()

    # -- readers (reference: mv_bench.py:140-185) --------------------------

    def read_video(self, path: str, bound=None) -> np.ndarray:
        from stllm_tpu_torch.data.video_reader import open_video

        vr = open_video(path)
        try:
            max_frame = len(vr) - 1
            fps = float(vr.get_avg_fps())
            idx = mvbench_frame_indices(bound, fps, max_frame, first_idx=0,
                                        num_segments=self.num_segments)
            return vr.get_batch(idx)
        finally:
            vr.close()

    def read_gif(self, path: str, bound=None, fps: float = 25) -> np.ndarray:
        import imageio

        gif = imageio.get_reader(path)
        frames_all = [np.asarray(f) for f in gif]
        max_frame = len(frames_all) - 1
        idx = set(mvbench_frame_indices(bound, fps, max_frame, first_idx=0,
                                        num_segments=self.num_segments).tolist())
        out = []
        for i, f in enumerate(frames_all):
            if i in idx:
                if f.ndim == 2:
                    f = np.stack([f] * 3, -1)
                elif f.shape[-1] == 4:
                    import cv2

                    f = cv2.cvtColor(f, cv2.COLOR_RGBA2RGB)
                out.append(f)
        return np.stack(out)

    def read_frame(self, path: str, bound=None, fps: float = 3) -> np.ndarray:
        import cv2

        max_frame = len(os.listdir(path))
        idx = mvbench_frame_indices(bound, fps, max_frame, first_idx=1,
                                    num_segments=self.num_segments)
        out = []
        for i in idx:
            img = cv2.imread(os.path.join(path, f"{i:05d}.jpg"))
            out.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        return np.stack(out)

    # -- formatting (reference: mv_bench.py:187-198) -----------------------

    @staticmethod
    def qa_template(data: Dict) -> Tuple[str, str]:
        question = f"Question: {data['question']}\n"
        question += "Options:\n"
        answer = data["answer"]
        answer_idx = -1
        for idx, c in enumerate(data["candidates"]):
            question += f"({chr(ord('A') + idx)}) {c}\n"
            if c == answer:
                answer_idx = idx
        question = question.rstrip()
        answer = f"({chr(ord('A') + answer_idx)}) {answer}"
        return question, answer

    def __getitem__(self, idx: int) -> Dict:
        item = self.data_list[idx]
        bound = None
        if item["bound"]:
            bound = (item["data"]["start"], item["data"]["end"])
        path = os.path.join(item["prefix"], item["data"]["video"])
        reader = {"video": self.read_video, "gif": self.read_gif,
                  "frame": self.read_frame}[item["data_type"]]
        frames = self.transform(reader(path, bound))
        question, answer = self.qa_template(item["data"])
        return {
            "video": frames,
            "video_path": path,
            "question": question,
            "answer": answer,
            "task_type": item["task_type"],
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def mvbench_prompt(system: str, question: str, answer_prompt: Optional[str]) -> str:
    """The EasyDict chat flow flattened: Human turn carries the video tag and
    the question; the final Assistant turn keeps ``answer_prompt`` WITHOUT a
    trailing separator (get_prompt2, mvbench_conversation.py:14-26)."""
    ret = system + "###"
    ret += "Human" + ": " + "<Video><VideoHere></Video>\n" + question + "\n" + "###"
    if answer_prompt:
        ret += "Assistant" + ": " + answer_prompt
    else:
        ret += "Assistant" + ":"
    return ret


def _qformer_ids(chat, question: str):
    """The question's Q-Former ids (1, L) on the chat's device, or None."""
    if not (chat.cfg.qformer_text_input and chat.qformer_tokenizer is not None):
        return None
    ids = chat.qformer_tokenizer.encode(question, add_special_tokens=True)
    return torch.tensor([ids[: chat.max_qformer_len]], dtype=torch.int32, device=chat.device)


def _question(system: str, sample: Dict, question_prompt: str, system_llm: bool) -> str:
    return (system + sample["question"] + question_prompt
            if system_llm else sample["question"] + question_prompt)


def _prompt_row(chat, video_emb: torch.Tensor, prompt: str, ask_simple: bool) -> torch.Tensor:
    """One sample's (S, D) prompt embeddings around its (V, D) video tokens:
    simple mode puts the video first and BOS inside the trailing text
    (get_context_emb_sim); otherwise the text segments sit either side of
    <VideoHere>."""
    if ask_simple:
        ids = chat.llama_tokenizer.encode(prompt.split("</Video>\n")[1],
                                          add_special_tokens=True)
        return torch.cat([video_emb, chat._embed_ids(ids)[0].to(video_emb.dtype)])
    pre, suf = (chat._embed_ids(chat.llama_tokenizer.encode(s, add_special_tokens=(i == 0)))[0]
                for i, s in enumerate(prompt.split("<VideoHere>")))
    return torch.cat([pre.to(video_emb.dtype), video_emb, suf.to(video_emb.dtype)])


def infer_mvbench(
    chat,                       # stllm_tpu_torch.conversation.Chat
    data_sample: Dict,
    system: str = SYSTEM,
    question_prompt: str = QUESTION_PROMPT,
    answer_prompt: Optional[str] = ANSWER_PROMPT,
    return_prompt: str = RETURN_PROMPT,
    system_llm: bool = True,
    all_token: bool = True,
    ask_simple: bool = False,
    max_new_tokens: int = 100,
) -> str:
    """Encode once, build the MVBench prompt, greedy-decode
    (reference: infer_mvbench, mv_bench.py:229-283)."""
    frames = torch.as_tensor(data_sample["video"], device=chat.device)[None]  # (1, T, H, W, C)
    cfg = resolve_auto_merge(chat.cfg, data_sample["video"][None])
    q_ids = _qformer_ids(chat, data_sample["question"])
    q_mask = None if q_ids is None else torch.ones_like(q_ids)
    emb = encode_img(chat.params, frames, cfg, q_ids, q_mask)    # (1, T, Q, D)
    t, q = emb.shape[1], emb.shape[2]
    video_emb = emb.reshape(t * q, -1) if all_token else emb.mean(dim=1)[0]

    question = _question(system, data_sample, question_prompt, system_llm)
    prompt = mvbench_prompt(system, question, answer_prompt)
    embs = _prompt_row(chat, video_emb, prompt, ask_simple)[None]

    gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False)
    out = generate(chat.params["llama"], embs, llama_cfg=chat.cfg.llama, gen=gen)
    return _strip_and_tail(list(out[0]), chat.llama_tokenizer, return_prompt)


def _strip_and_tail(tokens: List[int], llama_tokenizer, return_prompt: str) -> str:
    if tokens and tokens[0] == 0:
        tokens = tokens[1:]
    if tokens and tokens[0] == 1:
        tokens = tokens[1:]
    text = llama_tokenizer.decode(tokens)
    text = text.split("###")[0]
    text = text.split("Assistant:")[-1].strip()
    return return_prompt + text.strip().split("\n")[0]


def infer_mvbench_batch(
    chat,
    samples: List[Dict],
    system: str = SYSTEM,
    question_prompt: str = QUESTION_PROMPT,
    answer_prompt: Optional[str] = ANSWER_PROMPT,
    return_prompt: str = RETURN_PROMPT,
    system_llm: bool = True,
    all_token: bool = True,
    ask_simple: bool = False,
    max_new_tokens: int = 100,
) -> List[str]:
    """Batched greedy inference over samples with EQUAL frame counts: the
    videos are encoded one after another (encode_img_mapped), the prompts
    right-padded and decoded as one batch (per-row KV lengths, per-row stop
    sequences). The same predictions as per-sample infer_mvbench."""
    b = len(samples)
    frames_np = np.stack([s["video"] for s in samples])  # (B, T, H, W, C)
    frames = torch.as_tensor(frames_np, device=chat.device)

    q_ids = q_mask = None
    if chat.cfg.qformer_text_input and chat.qformer_tokenizer is not None:
        enc = [chat.qformer_tokenizer.encode(s["question"], add_special_tokens=True)
               [: chat.max_qformer_len] for s in samples]
        ql = max(len(e) for e in enc)
        ids = np.zeros((b, ql), np.int32)
        mask = np.zeros((b, ql), np.int32)
        for i, e in enumerate(enc):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        q_ids = torch.as_tensor(ids, device=chat.device)
        q_mask = torch.as_tensor(mask, device=chat.device)

    # an "auto" merge level resolves once over the whole stacked batch
    cfg = resolve_auto_merge(chat.cfg, frames_np)
    emb = encode_img_mapped(chat.params, frames, cfg, q_ids, q_mask)
    t, q = emb.shape[1], emb.shape[2]
    video_emb = emb.reshape(b, t * q, -1) if all_token else emb.mean(dim=1)

    rows = [_prompt_row(chat, video_emb[i],
                        mvbench_prompt(system, _question(system, s, question_prompt, system_llm),
                                       answer_prompt), ask_simple)
            for i, s in enumerate(samples)]
    max_len = max(r.shape[0] for r in rows)
    embs = torch.zeros((b, max_len, rows[0].shape[-1]), dtype=video_emb.dtype,
                       device=chat.device)
    attn = torch.zeros((b, max_len), dtype=torch.int32, device=chat.device)
    for i, r in enumerate(rows):
        embs[i, : r.shape[0]] = r
        attn[i, : r.shape[0]] = 1

    gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False)
    out = generate(chat.params["llama"], embs, attn, llama_cfg=chat.cfg.llama, gen=gen)
    return [_strip_and_tail(list(toks), chat.llama_tokenizer, return_prompt) for toks in out]


def infer_mvbench_serving(
    chat,
    samples,                    # iterable of MVBench examples
    slots: int = 4,
    max_len: int = 1024,
    chunk: int = 16,
    system: str = SYSTEM,
    question_prompt: str = QUESTION_PROMPT,
    answer_prompt: Optional[str] = ANSWER_PROMPT,
    return_prompt: str = RETURN_PROMPT,
    system_llm: bool = True,
    all_token: bool = True,
    ask_simple: bool = False,
    max_new_tokens: int = 100,
    window: Optional[int] = None,
    stats: Optional[Dict[str, int]] = None,
):
    """Stream samples through ``pipeline_serving.VideoQAServer``: encodes are
    admitted lazily into free decode slots and every resident answer
    advances through one shared decode chunk.

    Yields ``(example, pred)`` in COMPLETION order; predictions are
    token-identical to per-sample infer_mvbench. At most ``window`` (default
    ``2*slots``) samples are materialized ahead of the decoder. A sample
    whose prompt exceeds ``max_len`` (the server raises UnsupportedRequest)
    runs through infer_mvbench instead; ``stats["overlong"]`` counts those
    when a dict is given.
    """
    from stllm_tpu_torch.pipeline_serving import VideoQAServer

    # infer_mvbench's all_token flag lays video tokens out as (t*q) or mean
    # whatever the trained video_input mode; apply_video_input with
    # 'all'/'mean' reproduces those layouts exactly, so the serving cfg is
    # pinned to match
    cfg = dataclasses.replace(chat.cfg, video_input="all" if all_token else "mean")
    gen = GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False)
    srv = VideoQAServer(chat.params, cfg, slots=slots, max_len=max_len, chunk=chunk)
    window = window or 2 * slots
    pending: Dict[int, Dict] = {}
    it = iter(enumerate(samples))
    exhausted = False

    def build(example: Dict):
        frames = torch.as_tensor(example["video"], device=chat.device)[None]
        question = _question(system, example, question_prompt, system_llm)
        prompt = mvbench_prompt(system, question, answer_prompt)
        if ask_simple:
            # the video comes FIRST; BOS rides inside the trailing text
            pre = []
            suf = chat.llama_tokenizer.encode(prompt.split("</Video>\n")[1],
                                              add_special_tokens=True)
        else:
            segs = prompt.split("<VideoHere>")
            pre = chat.llama_tokenizer.encode(segs[0], add_special_tokens=True)
            suf = chat.llama_tokenizer.encode(segs[1], add_special_tokens=False)
        return frames, [pre], [suf], _qformer_ids(chat, example["question"])

    while True:
        while not exhausted and len(pending) < window:
            try:
                rid, example = next(it)
            except StopIteration:
                exhausted = True
                break
            frames, pre, suf, q_ids = build(example)
            try:
                srv.submit(rid, frames, pre, suf, gen, qformer_text_ids=q_ids)
            except UnsupportedRequest:
                # the prompt exceeds the server's max_len: this one sample
                # runs the per-sample path instead of aborting the eval
                if stats is not None:
                    stats["overlong"] = stats.get("overlong", 0) + 1
                yield example, infer_mvbench(
                    chat, example, system=system,
                    question_prompt=question_prompt,
                    answer_prompt=answer_prompt, return_prompt=return_prompt,
                    system_llm=system_llm, all_token=all_token,
                    ask_simple=ask_simple, max_new_tokens=max_new_tokens)
                continue
            pending[rid] = example
        if not pending:
            return
        for req in srv.step():
            example = pending.pop(req.rid)
            yield example, _strip_and_tail(list(req.tokens), chat.llama_tokenizer,
                                           return_prompt)


def check_ans(pred: str, gt: str) -> bool:
    """Option-letter match (reference: mv_bench.py:285-300)."""
    pred_list = pred.lower().split(" ")
    pred_option = pred_list[0]
    gt_list = gt.lower().split(" ")
    gt_option, gt_content = gt_list[0], " ".join(gt_list[1:])
    if gt_content and gt_content[-1] == ".":
        gt_content = gt_content[:-1]
    if pred_option.replace(".", "") in gt_option:
        return True
    if gt_option in pred_option:
        return True
    return False


def run_mvbench(
    chat,
    dataset: MVBenchDataset,
    output_dir: Optional[str] = None,
    output_name: str = "mvbench",
    ask_simple: bool = False,
    system_llm: bool = True,
    all_token: bool = True,
    verbose: bool = True,
    batch_size: int = 1,
    shard: Optional[Tuple[int, int]] = None,
    serving_slots: Optional[int] = None,
    serving_max_len: int = 1024,
    stats: Optional[Dict[str, int]] = None,
) -> Dict:
    """Accuracy accumulation + JSON dump (reference: mv_bench_infer.py:68-118).

    ``batch_size > 1`` groups samples with the same frame count and runs
    infer_mvbench_batch — same predictions, one encoder/decoder pass per
    group instead of per video.

    ``serving_slots=N`` streams the whole split through the continuous
    video-QA server instead (infer_mvbench_serving): encodes interleave
    with a shared N-slot decode, no same-frame-count grouping needed;
    same predictions, scored in completion order; ``stats`` goes to
    infer_mvbench_serving, which counts its per-sample fallbacks there.

    ``shard=(rank, world)`` evaluates every world-th sample — multi-host
    eval in the reference's style (DistributedSampler + rank-sharded JSON,
    base_task.py:248-286); pass each host's result_list to
    tasks.base_task.BaseTask.save_result to merge."""
    correct = total = 0
    acc_dict: Dict[str, List[int]] = {}
    res_list = []

    def score(example: Dict, pred: str) -> None:
        nonlocal correct, total
        task = example["task_type"]
        acc_dict.setdefault(task, [0, 0])
        acc_dict[task][1] += 1
        total += 1
        gt = example["answer"]
        res_list.append({"pred": pred, "gt": gt})
        if check_ans(pred=pred, gt=gt):
            acc_dict[task][0] += 1
            correct += 1
        if verbose:
            print(f"{task}: pred={pred!r} gt={gt!r} "
                  f"acc={acc_dict[task][0] / acc_dict[task][1] * 100:.2f}% "
                  f"total={correct / total * 100:.2f}%")

    rank, world = shard if shard else (0, 1)
    indices = range(rank, len(dataset), world)

    if serving_slots:
        for example, pred in infer_mvbench_serving(
                chat, (dataset[i] for i in indices), slots=serving_slots,
                max_len=serving_max_len, ask_simple=ask_simple,
                system_llm=system_llm, all_token=all_token, stats=stats):
            score(example, pred)
    elif batch_size <= 1:
        for i in indices:
            example = dataset[i]
            pred = infer_mvbench(chat, example, ask_simple=ask_simple,
                                 system_llm=system_llm, all_token=all_token)
            score(example, pred)
    else:
        buckets: Dict[int, List[Dict]] = {}

        def flush(t: int) -> None:
            batch = buckets.pop(t, [])
            if not batch:
                return
            preds = infer_mvbench_batch(chat, batch, ask_simple=ask_simple,
                                        system_llm=system_llm,
                                        all_token=all_token)
            for ex, pred in zip(batch, preds):
                score(ex, pred)

        for i in indices:
            example = dataset[i]
            t = example["video"].shape[0]
            buckets.setdefault(t, []).append(example)
            if len(buckets[t]) >= batch_size:
                flush(t)
        for t in list(buckets):
            flush(t)
    result = {"acc_dict": {**{k: v for k, v in acc_dict.items()},
                           "Total Acc": f"{correct / max(total, 1) * 100:.2f}%"},
              "res_list": res_list}
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, f"{output_name}.json"), "w") as f:
            json.dump(result, f)
    return result


def main():
    """CLI mirroring the reference entry script (reference: mv_bench_infer.py:20-42).
    Runs on the CUDA card, or on the CPU with ``--cpu``."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg-path", required=True)
    parser.add_argument("--ckpt-path", default=None)
    parser.add_argument("--anno-path", required=True)
    parser.add_argument("--data-root", default="")
    parser.add_argument("--num-frames", type=int, default=100)
    parser.add_argument("--specified_item", default=None)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", required=True)
    parser.add_argument("--options", nargs="+", default=None)
    parser.add_argument("--system_llm", action="store_false")
    parser.add_argument("--ask_simple", action="store_true")
    parser.add_argument("--batch-size", type=int, default=1,
                        help="group same-frame-count videos per device pass")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()

    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.common.registry import registry
    from stllm_tpu_torch.models.zoo import ensure_tokenizers

    cfg = Config(args.cfg_path, options=args.options)
    model_cfg = cfg.model_cfg
    if args.ckpt_path:
        model_cfg["ckpt"] = args.ckpt_path
    model = registry.get_model_class(model_cfg["arch"]).from_config(
        model_cfg, device="cpu" if args.cpu else None)
    ensure_tokenizers(model)
    chat = model.chat()
    all_token = model_cfg.get("video_input") != "mean"  # see module docstring
    resolution = 224
    if isinstance(model_cfg.get("vit"), dict):
        resolution = model_cfg["vit"].get("image_size", 224)
    dataset = MVBenchDataset(args.anno_path, args.data_root,
                             num_segments=args.num_frames,
                             resolution=resolution,
                             specified_item=args.specified_item, device=model.device)
    run_mvbench(chat, dataset, output_dir=args.output_dir,
                output_name=args.output_name, ask_simple=args.ask_simple,
                system_llm=args.system_llm, all_token=all_token,
                batch_size=args.batch_size)


if __name__ == "__main__":
    main()
