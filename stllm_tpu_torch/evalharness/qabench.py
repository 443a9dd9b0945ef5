"""Open-ended VideoQA and VideoChatGPT-Bench inference loops: the port of
stllm_tpu/evalharness/qabench.py (reference: stllm/test/qabench/{msvd,msrvtt,
activitynet}_qa.py:94-123, stllm/test/vcgbench/videochatgpt_benchmark_
general.py:86-120 and _consist.py:90-120).

Per sample: Chat.upload_video with the question as Q-Former text, a beam-5
answer without sampling (the simple prompt, so the reference's forced
repetition_penalty 1.5), and a JSON dump of the predictions that the GPT
judges (gpt_eval.py) read. ``run_videoqa(batch_videos=N)`` advances N
videos' beams in one device program with the same predictions.

    python -m stllm_tpu_torch.evalharness.qabench --bench videoqa \
        --cfg-path CFG --gt_file GT.json --video_dir VIDEOS \
        --output_dir OUT --output_name NAME [--batch-videos N] [--cpu]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

VIDEO_FORMATS = [".mp4", ".avi", ".mov", ".mkv"]


def _find_video(video_dir: str, name: str) -> Optional[str]:
    cand = os.path.join(video_dir, name)
    if os.path.splitext(name)[1]:
        return cand if os.path.exists(cand) else None
    for fmt in VIDEO_FORMATS:
        p = cand + fmt
        if os.path.exists(p):
            return p
    return None


def _answer(chat, conv_template, video_path: str, question: str, num_frames: int,
            system: bool, num_beams: int = 5, max_new_tokens: int = 300) -> str:
    conv = conv_template.copy()
    img_list: List = []
    chat.upload_video(video_path, conv, img_list, num_frames, question)
    chat.ask(question, conv)
    text, _ = chat.answer(conv=conv, img_list=img_list, num_beams=num_beams, do_sample=False,
                          temperature=1.0, system=system, max_new_tokens=max_new_tokens,
                          max_length=2000)
    return text


def _answer_group(chat, conv_template, items, num_frames: int, num_beams: int,
                  max_new_tokens: int = 300) -> List[str]:
    """Beam answers for [(video_path, question), ...]: encode each video,
    then advance every group's beams in one device program
    (Chat.answer_batched). Per item the answer equals _answer's."""
    convs, img_lists = [], []
    for path, question in items:
        conv = conv_template.copy()
        img_list: List = []
        chat.upload_video(path, conv, img_list, num_frames, question)
        chat.ask(question, conv)
        convs.append(conv)
        img_lists.append(img_list)
    return chat.answer_batched(convs, img_lists, num_beams=num_beams,
                               max_new_tokens=max_new_tokens, system=False)


def run_videoqa(chat, conv_template, gt_file: str, video_dir: str, output_dir: str,
                output_name: str, num_frames: int = 64, num_beams: int = 5,
                verbose: bool = True, batch_videos: int = 1) -> List[Dict]:
    """MSVD / MSRVTT / ActivityNet zero-shot QA: dump {id, question,
    answer, pred} (reference: msvd_qa.py:94-123; answer() with
    system=False). ``batch_videos > 1`` groups that many videos per beam
    program, with the same answers; the reference decodes one video at a
    time."""
    with open(gt_file) as f:
        gt = json.load(f)
    os.makedirs(output_dir, exist_ok=True)
    out: List[Dict] = []
    pending: List[Dict] = []

    def flush():
        preds = _answer_group(chat, conv_template,
                              [(r["_path"], r["question"]) for r in pending],
                              num_frames, num_beams)
        for rec, pred in zip(pending, preds):
            rec.pop("_path")
            rec["pred"] = pred
            out.append(rec)
            if verbose:
                print(f"[{len(out)}/{len(gt)}] {rec['id']}: {pred!r}")
        pending.clear()

    for sample in gt:
        video_name = sample.get("video_name", sample.get("video"))
        qid = sample.get("question_id", sample.get("id"))
        question = sample["question"]
        rec = {"id": qid, "question": question, "answer": sample["answer"]}
        path = _find_video(video_dir, video_name)
        if path is None:
            if verbose:
                print(f"missing video {video_name}, skipped")
            continue
        if batch_videos > 1:
            rec["_path"] = path
            pending.append(rec)
            if len(pending) == batch_videos:
                flush()
            continue
        rec["pred"] = _answer(chat, conv_template, path, question, num_frames, system=False,
                              num_beams=num_beams)
        out.append(rec)
        if verbose:
            print(f"[{len(out)}/{len(gt)}] {qid}: {rec['pred']!r}")
    if pending:
        flush()
    with open(os.path.join(output_dir, f"{output_name}.json"), "w") as f:
        json.dump(out, f)
    return out


def run_vcgbench_general(chat, conv_template, gt_file: str, video_dir: str, output_dir: str,
                         output_name: str, num_frames: int = 64, num_beams: int = 5,
                         verbose: bool = True) -> List[Dict]:
    """Single-question VCG-Bench (generic, detail, context, temporal;
    reference: videochatgpt_benchmark_general.py:86-120; system prompt kept)."""
    with open(gt_file) as f:
        gt = json.load(f)
    os.makedirs(output_dir, exist_ok=True)
    out: List[Dict] = []
    for sample in gt:
        rec = dict(sample)
        path = _find_video(video_dir, sample["video_name"])
        if path is None:
            if verbose:
                print(f"missing video {sample['video_name']}, skipped")
            continue
        rec["pred"] = _answer(chat, conv_template, path, sample["Q"], num_frames, system=True,
                              num_beams=num_beams)
        out.append(rec)
        if verbose:
            print(f"[{len(out)}/{len(gt)}] {rec['pred']!r}")
    with open(os.path.join(output_dir, f"{output_name}.json"), "w") as f:
        json.dump(out, f)
    return out


def run_vcgbench_consistency(chat, conv_template, gt_file: str, video_dir: str,
                             output_dir: str, output_name: str, num_frames: int = 64,
                             num_beams: int = 5, verbose: bool = True) -> List[Dict]:
    """Q1/Q2 consistency pairs -> pred1/pred2
    (reference: videochatgpt_benchmark_consist.py:90-120)."""
    with open(gt_file) as f:
        gt = json.load(f)
    os.makedirs(output_dir, exist_ok=True)
    out: List[Dict] = []
    for sample in gt:
        rec = dict(sample)
        path = _find_video(video_dir, sample["video_name"])
        if path is None:
            continue
        for i, q in enumerate((sample["Q1"], sample["Q2"]), start=1):
            rec[f"pred{i}"] = _answer(chat, conv_template, path, q, num_frames, system=True,
                                      num_beams=num_beams)
        out.append(rec)
        if verbose:
            print(f"[{len(out)}/{len(gt)}] consist pair done")
    with open(os.path.join(output_dir, f"{output_name}.json"), "w") as f:
        json.dump(out, f)
    return out


def main():
    """One CLI for the reference's qabench and vcgbench scripts (reference:
    stllm/test/qabench/msvd_qa.py:28-57, stllm/test/vcgbench/
    videochatgpt_benchmark_*.py; --bench selects the loop). Runs on the CUDA
    card, or on the CPU with ``--cpu``."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--bench", choices=["videoqa", "vcg_general", "vcg_consistency"],
                        default="videoqa")
    parser.add_argument("--cfg-path", required=True)
    parser.add_argument("--ckpt-path", default=None)
    parser.add_argument("--gt_file", required=True)
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", required=True)
    parser.add_argument("--num-frames", type=int, default=64)
    parser.add_argument("--num-beams", type=int, default=5)
    parser.add_argument("--batch-videos", type=int, default=1,
                        help="videoqa only: beam-decode this many videos per device program "
                             "(answers identical to --batch-videos 1)")
    parser.add_argument("--options", nargs="+", default=None)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()

    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.common.registry import registry
    from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0, CONV_VIDEO_Vicuna0
    from stllm_tpu_torch.models.zoo import ensure_tokenizers

    if args.options:
        parser.error("--options: dotlist overrides are not ported yet")
    model_cfg = Config(args.cfg_path).model_cfg
    if args.ckpt_path:
        model_cfg["ckpt"] = args.ckpt_path
    model = registry.get_model_class(model_cfg["arch"]).from_config(
        model_cfg, device="cpu" if args.cpu else None)
    ensure_tokenizers(model)
    image_size = 224
    if isinstance(model_cfg.get("vit"), dict):
        image_size = model_cfg["vit"].get("image_size", 224)
    chat = model.chat(image_size=image_size)
    conv = (CONV_instructblip_Vicuna0 if "instructblip" in str(model_cfg.get("model_type", ""))
            else CONV_VIDEO_Vicuna0)
    run = {"videoqa": run_videoqa, "vcg_general": run_vcgbench_general,
           "vcg_consistency": run_vcgbench_consistency}[args.bench]
    kw = {"batch_videos": args.batch_videos} if args.bench == "videoqa" else {}
    run(chat, conv, args.gt_file, args.video_dir, args.output_dir, args.output_name,
        num_frames=args.num_frames, num_beams=args.num_beams, **kw)


if __name__ == "__main__":
    main()
