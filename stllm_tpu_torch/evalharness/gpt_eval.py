"""GPT-3.5 judge harness for VideoQA / VideoChatGPT-Bench: the port's own
copy of stllm_tpu/evalharness/gpt_eval.py (reference:
stllm/test/gpt_evaluation/evaluate_activitynet_qa.py and
evaluate_benchmark_{1..5}_*.py). The rubric prompts are the reference's
VERBATIM: judge scores are prompt-sensitive, so parity needs the exact text
(its typos too, like "{''score': 4.8}").

The LLM call is injectable: pass ``judge_fn(messages) -> str`` (tests pass a
fake; ``make_openai_judge()`` builds the real one and is the only place that
imports ``openai``). The per-key loop is resumable: one json per sample in
output_dir, completed keys skipped on re-runs, as the reference's loop over
incomplete files (:125-148).

    python -m stllm_tpu_torch.evalharness.gpt_eval --rubric NAME \
        --pred_path PRED.json --output_dir DIR --api_key KEY
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

Messages = List[Dict[str, str]]


@dataclasses.dataclass(frozen=True)
class Rubric:
    name: str
    system: str
    user_template: Callable[[Dict], str]
    has_pred: bool = False  # yes/no accuracy tracked (activitynet only)


def _qa_user(intro_scores: str) -> Callable[[Dict], str]:
    def fmt(qa: Dict) -> str:
        return (
            "Please evaluate the following video-based question-answer pair:\n\n"
            f"Question: {qa['q']}\n"
            f"Correct Answer: {qa['a']}\n"
            f"Predicted Answer: {qa['pred']}\n\n"
            + intro_scores
        )
    return fmt


ACTIVITYNET_QA = Rubric(
    name="activitynet_qa",
    system=(
        "You are an intelligent chatbot designed for evaluating the correctness of generative outputs for question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine if they match meaningfully. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the meaningful match between the predicted answer and the correct answer.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Evaluate the correctness of the prediction compared to the answer."
    ),
    user_template=_qa_user(
        "Provide your evaluation only as a yes/no and score where the score is an integer value between 0 and 5, with 5 indicating the highest meaningful match. "
        "Please generate the response in the form of a Python dictionary string with keys 'pred' and 'score', where value of 'pred' is  a string of 'yes' or 'no' and value of 'score' is in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {'pred': 'yes', 'score': 4.8}."
    ),
    has_pred=True,
)

CORRECTNESS = Rubric(
    name="correctness",
    system=(
        "You are an intelligent chatbot designed for evaluating the factual accuracy of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine if they are factually consistent. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the factual consistency between the predicted answer and the correct answer. The predicted answer should not contain any misinterpretations or misinformation.\n"
        "- The predicted answer must be factually accurate and align with the video content.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Evaluate the factual accuracy of the prediction compared to the answer."
    ),
    user_template=_qa_user(
        "Provide your evaluation only as a factual accuracy score where the factual accuracy score is an integer value between 0 and 5, with 5 indicating the highest level of factual consistency. "
        "Please assign a score of 0 when the meaning of Predicted Answer is similar to 'I don't know'."
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the factual accuracy score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {''score': 4.8}."
    ),
)

DETAILED_ORIENTATION = Rubric(
    name="detailed_orientation",
    system=(
        "You are an intelligent chatbot designed for evaluating the detail orientation of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine its level of detail, considering both completeness and specificity. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Check if the predicted answer covers all major points from the video. The response should not leave out any key aspects.\n"
        "- Evaluate whether the predicted answer includes specific details rather than just generic points. It should provide comprehensive information that is tied to specific elements of the video.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Provide a single evaluation score that reflects the level of detail orientation of the prediction, considering both completeness and specificity."
    ),
    user_template=_qa_user(
        "Provide your evaluation only as a detail orientation score where the detail orientation score is an integer value between 0 and 5, with 5 indicating the highest level of detail orientation. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the detail orientation score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {''score': 4.8}."
    ),
)

CONTEXT = Rubric(
    name="context",
    system=(
        "You are an intelligent chatbot designed for evaluating the contextual understanding of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine if the generated response aligns with the overall context of the video content. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Evaluate whether the predicted answer aligns with the overall context of the video content. It should not provide information that is out of context or misaligned.\n"
        "- The predicted answer must capture the main themes and sentiments of the video.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Provide your evaluation of the contextual understanding of the prediction compared to the answer."
    ),
    user_template=_qa_user(
        "Provide your evaluation only as a contextual understanding score where the contextual understanding score is an integer value between 0 and 5, with 5 indicating the highest level of contextual understanding. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is contextual understanding score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {''score': 4.8}."
    ),
)

TEMPORAL = Rubric(
    name="temporal",
    system=(
        "You are an intelligent chatbot designed for evaluating the temporal understanding of generative outputs for video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct answer and determine if they correctly reflect the temporal sequence of events in the video content. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the temporal consistency between the predicted answer and the correct answer. The predicted answer should correctly reflect the sequence of events or details as they are presented in the video content.\n"
        "- Consider synonyms or paraphrases as valid matches, but only if the temporal order is maintained.\n"
        "- Evaluate the temporal accuracy of the prediction compared to the answer."
    ),
    user_template=_qa_user(
        "Provide your evaluation only as a temporal accuracy score where the temporal accuracy score is an integer value between 0 and 5, with 5 indicating the highest level of temporal consistency. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the temporal accuracy score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {''score': 4.8}."
    ),
)


def _consistency_user(qa: Dict) -> str:
    return (
        "Please evaluate the following video-based question-answer pair:\n\n"
        f"Question 1: {qa['q1']}\n"
        f"Question 2: {qa['q2']}\n"
        f"Correct Answer: {qa['a']}\n"
        f"Predicted Answer to Question 1: {qa['pred1']}\n"
        f"Predicted Answer to Question 2: {qa['pred2']}\n\n"
        "Provide your evaluation only as a consistency score where the consistency score is an integer value between 0 and 5, with 5 indicating the highest level of consistency. "
        "Please generate the response in the form of a Python dictionary string with keys 'score', where its value is the consistency score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the Python dictionary string. "
        "For example, your response should look like this: {''score': 4.8}."
    )


CONSISTENCY = Rubric(
    name="consistency",
    system=(
        "You are an intelligent chatbot designed for evaluating the consistency of generative outputs for similar video-based question-answer pairs. "
        "You will be given two very similar questions, a common answer common to both the questions and predicted answers for the two questions ."
        "Your task is to compare the predicted answers for two very similar question, with a common correct answer and determine if they are consistent. Here's how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the consistency between the two predicted answers and the correct answer. Both predicted answers should correspond to the correct answer and to each other, and should not contain any contradictions or significant differences in the conveyed information.\n"
        "- Both predicted answers must be consistent with each other and the correct answer, in terms of the information they provide about the video content.\n"
        "- Consider synonyms or paraphrases as valid matches, but only if they maintain the consistency in the conveyed information.\n"
        "- Evaluate the consistency of the two predicted answers compared to the correct answer."
    ),
    user_template=_consistency_user,
)

RUBRICS = {r.name: r for r in (
    ACTIVITYNET_QA, CORRECTNESS, DETAILED_ORIENTATION, CONTEXT, TEMPORAL,
    CONSISTENCY,
)}


def make_openai_judge(api_key: str, model: str = "gpt-3.5-turbo"):
    """Production judge backend (requires the openai package + network)."""
    import openai

    client = openai.OpenAI(api_key=api_key)

    def judge(messages: Messages) -> str:
        completion = client.chat.completions.create(model=model, messages=messages)
        return completion.choices[0].message.content

    return judge


def build_prediction_set(pred_file: str, rubric: Rubric) -> Dict[str, Dict]:
    """Prediction JSON -> {key: qa_set} (reference main(): id-keyed dicts)."""
    with open(pred_file) as f:
        preds = json.load(f)
    out = {}
    for i, sample in enumerate(preds):
        key = str(sample.get("id", sample.get("video_name", i)))
        if rubric.name == "consistency":
            out[key] = {"q1": sample["Q1"], "q2": sample["Q2"],
                        "a": sample["A"], "pred1": sample["pred1"],
                        "pred2": sample["pred2"]}
        elif "Q" in sample:
            out[key] = {"q": sample["Q"], "a": sample["A"], "pred": sample["pred"]}
        else:
            out[key] = {"q": sample["question"], "a": sample["answer"],
                        "pred": sample["pred"]}
    return out


def annotate(
    rubric: Rubric,
    prediction_set: Dict[str, Dict],
    output_dir: str,
    judge_fn: Callable[[Messages], str],
    max_rounds: int = 3,
    verbose: bool = True,
    workers: int = 8,
) -> None:
    """Resumable per-sample judging: one <key>.json per sample; re-runs skip
    completed keys; samples within a round fan out over a thread pool (the
    judge is network-bound — reference uses multiprocessing.Pool,
    evaluate_activitynet_qa.py:125-148). ``workers=1`` runs sequentially."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(output_dir, exist_ok=True)

    def judge_one(key: str) -> None:
        qa = prediction_set[key]
        messages = [
            {"role": "system", "content": rubric.system},
            {"role": "user", "content": rubric.user_template(qa)},
        ]
        try:
            response = judge_fn(messages)
            response_dict = ast.literal_eval(response)
            # write-then-rename so a crash never leaves a truncated .json
            # that the resume scan would treat as done
            tmp = os.path.join(output_dir, f".{key}.tmp")
            with open(tmp, "w") as f:
                json.dump([response_dict, qa], f)
            os.replace(tmp, os.path.join(output_dir, f"{key}.json"))
        except Exception as e:  # noqa: BLE001 — mirror reference resilience
            if verbose:
                print(f"Error processing '{key}': {e}")

    for _ in range(max_rounds):
        done = {f[:-5] for f in os.listdir(output_dir) if f.endswith(".json")}
        todo = [k for k in prediction_set if k not in done]
        if not todo:
            return
        if workers <= 1:
            for key in todo:
                judge_one(key)
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(judge_one, todo))


def combine_and_score(output_dir: str, output_json: Optional[str] = None,
                      has_pred: bool = False) -> Dict:
    """Merge per-sample judgments; average score (+ yes/no accuracy)
    (reference: evaluate_activitynet_qa.py:154-196)."""
    combined = {}
    for fn in os.listdir(output_dir):
        if fn.endswith(".json"):
            with open(os.path.join(output_dir, fn)) as f:
                combined[fn[:-5]] = json.load(f)
    if output_json:
        with open(output_json, "w") as f:
            json.dump(combined, f)
    score_sum = count = yes = no = 0
    for result in combined.values():
        r = result[0]
        if isinstance(r, list):
            r = r[0]
        count += 1
        score_sum += int(r["score"])
        if has_pred:
            p = str(r.get("pred", "")).lower()
            if "yes" in p:
                yes += 1
            elif "no" in p:
                no += 1
    out = {"count": count, "average_score": score_sum / max(count, 1)}
    if has_pred:
        out["accuracy"] = yes / max(yes + no, 1)
        out["yes_count"] = yes
        out["no_count"] = no
    return out


def evaluate(
    rubric_name: str,
    pred_file: str,
    output_dir: str,
    judge_fn: Callable[[Messages], str],
    output_json: Optional[str] = None,
    workers: int = 8,
) -> Dict:
    rubric = RUBRICS[rubric_name]
    preds = build_prediction_set(pred_file, rubric)
    annotate(rubric, preds, output_dir, judge_fn, workers=workers)
    return combine_and_score(output_dir, output_json, has_pred=rubric.has_pred)


def main():
    """CLI mirroring the reference judge scripts' arguments
    (reference: evaluate_activitynet_qa.py main() argparse — --pred_path,
    --output_dir, --output_json, --api_key, --num_tasks)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--rubric", choices=sorted(RUBRICS), required=True)
    parser.add_argument("--pred_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_json", default=None)
    parser.add_argument("--api_key", default=None)
    parser.add_argument("--model", default="gpt-3.5-turbo")
    parser.add_argument("--num_tasks", type=int, default=8,
                        help="concurrent judge requests (reference's "
                             "multiprocessing pool size)")
    args = parser.parse_args()

    if not args.api_key:
        raise SystemExit("--api_key required (GPT judge needs OpenAI access)")
    judge = make_openai_judge(args.api_key, args.model)
    result = evaluate(args.rubric, args.pred_path, args.output_dir, judge,
                      args.output_json, workers=args.num_tasks)
    for k, v in result.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
