"""One-command MVBench replication gate: convert -> parity -> MVBench
(script/replicate_mvbench.py of the JAX package, through the port).

Three gated stages, stopping at the first failure:

  1. convert   build the model from the experiment YAML with the given
               checkpoint paths (``registry.get_model_class(arch).from_config``
               reads the reference's formats: convert/from_torch.py), then
               ``ensure_tokenizers``.
  2. parity    (a) the port's full-size golden suite
                   (tests/test_torch_golden_full_size.py: full-width layers
                   against the JAX package in fp32, and against HF when
                   ``transformers`` imports); it needs JAX as its oracle, so
                   on a machine without JAX the stage fails unless
                   ``--skip-golden-suite``;
               (b) ``--record-golden FILE.npz`` / ``--golden FILE.npz``: the
                   lm-head logits at the last of 4 x 16 recorded prompt ids,
                   top-1 agreement 1.0 and max |diff| <= 5e-2. The file is
                   the JAX script's format (``input_ids`` int32 (4, 16),
                   ``logits`` fp32), so goldens recorded by either package
                   verify in the other;
               (c) ``--parity-llama``: the LLaMA directory reloaded in HF
                   transformers, logits compared directly (fails when
                   ``transformers`` does not import).
  3. mvbench   the 20-task harness (evalharness/mvbench.py) and its
               per-task and Total Acc table; ``--tome`` and
               ``--serving-slots`` score the token-merge level or the served
               route instead of the per-sample path.

Real run (weights on disk; the card unless --cpu):
  python -m stllm_tpu_torch.replicate_mvbench \\
    --cfg config/instructblipbase_stllm_qa.yaml \\
    --llama /ckpts/vicuna-7b-v1.1 \\
    --qformer /ckpts/instruct_blip_vicuna7b_trimmed.pth \\
    --ckpt /ckpts/stllm_instructblip_qa.pth \\
    --anno /data/MVBench/json --data-root /data/MVBench/video \\
    --out-dir results/mvbench

Dry run (no weights: tiny files in the reference's on-disk formats and a
one-task MVBench layout, then all three stages and the --tome auto and
--serving-slots 2 arms):
  python -m stllm_tpu_torch.replicate_mvbench --dry-run [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from stllm_tpu_torch.common.config import Config
from stllm_tpu_torch.common.registry import registry
from stllm_tpu_torch.convert.to_reference import hf_llama_state, save_hf_shards
from stllm_tpu_torch.data.samplers import mvbench_frame_indices
from stllm_tpu_torch.evalharness.mvbench import MVBenchDataset, run_mvbench
from stllm_tpu_torch.models.llama import LlamaConfig, init_llama, llama_forward, lm_head
from stllm_tpu_torch.models.zoo import ensure_tokenizers
from stllm_tpu_torch.ops.tome import level_kwargs
from stllm_tpu_torch.train.step import tree_paths

REPO = Path(__file__).resolve().parent.parent

GOLDEN_PROMPTS = 4          # recorded prompts in --record-golden mode
GOLDEN_LEN = 16
GOLDEN_ATOL = 5e-2          # bf16 lm-head logits against recorded fp32
DRYRUN_FRAMES, DRYRUN_SIZE = 40, 64


def log(stage: str, msg: str) -> None:
    print(f"[replicate:{stage}] {msg}", flush=True)


def cv2_available() -> bool:
    return importlib.util.find_spec("cv2") is not None


def _dryrun_clip() -> np.ndarray:
    """The dry run's clip: 40 flat 64x64 frames of rising grey."""
    return np.stack([np.full((DRYRUN_SIZE, DRYRUN_SIZE, 3), 10 + 5 * i, np.uint8)
                     for i in range(DRYRUN_FRAMES)])


def _hf_llama_config(cfg) -> dict:
    """config.json of an HF LlamaForCausalLM directory for a port LlamaConfig."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.heads,
            "num_key_value_heads": cfg.heads, "intermediate_size": cfg.intermediate,
            "max_position_embeddings": cfg.max_positions, "rms_norm_eps": cfg.rms_eps,
            "rope_theta": cfg.rope_theta, "hidden_act": "silu",
            "tie_word_embeddings": False, "torch_dtype": "float32"}


def synthesize_dryrun(root: str):
    """Tiny fixtures in the reference's formats (script/replicate_mvbench.py's
    dry run), written without ``transformers``: an HF LLaMA directory
    (``pytorch_model-*.bin`` shards and config.json) at
    config/tiny_debug.yaml's LLaMA dims, a reference-named ST-LLM ``.pth``
    (the llm_proj -> llama_proj and ln_vision families and the residual
    module), and a one-task MVBench layout ('Scene Transition':
    scene_transition.json + scene_qa/video/a.mp4). The mp4 is written with
    cv2 where it imports; without cv2 no clip is written and the clip's
    frames are returned, for the harness to read from memory.
    Returns (llama_dir, ckpt, anno, media, clips or None)."""
    log("dryrun", f"synthesizing tiny checkpoints + MVBench layout in {root}")
    lcfg = LlamaConfig(vocab_size=4096, hidden=32, num_layers=2, heads=2, intermediate=64,
                       max_positions=1024, dtype=torch.float32)
    llama = init_llama(torch.Generator().manual_seed(0), lcfg)
    llama_dir = os.path.join(root, "vicuna-tiny")
    save_hf_shards(hf_llama_state(llama), llama_dir)
    with open(os.path.join(llama_dir, "config.json"), "w") as f:
        json.dump(_hf_llama_config(lcfg), f, indent=2)

    # dims follow config/tiny_debug.yaml: qformer.hidden 16, llama.hidden 32,
    # vit.width 32, residual_size 2 -> down/up project 32 <-> 8
    rng = np.random.default_rng(0)
    d_llm, d_q, d_vit = 32, 16, 32
    state = {
        "model.stllm_model.llm_proj.weight": rng.normal(size=(d_llm, d_q)),
        "model.stllm_model.llm_proj.bias": rng.normal(size=(d_llm,)),
        "model.stllm_model.ln_vision.weight": rng.normal(size=(d_vit,)),
        "model.stllm_model.ln_vision.bias": np.zeros(d_vit),
        "model.stllm_model.down_proj.weight": rng.normal(size=(d_llm // 4, d_llm)),
        "model.stllm_model.down_proj.bias": np.zeros(d_llm // 4),
        "model.stllm_model.up_proj.weight": rng.normal(size=(d_llm, d_llm // 4)),
        "model.stllm_model.up_proj.bias": np.zeros(d_llm),
    }
    ckpt = os.path.join(root, "stllm_tiny.pth")
    torch.save({"model": {k: torch.from_numpy(v.astype(np.float32)) for k, v in state.items()}},
               ckpt)

    anno = os.path.join(root, "json")
    media = os.path.join(root, "video")
    video_dir = os.path.join(media, "scene_qa", "video")
    os.makedirs(anno)
    os.makedirs(video_dir)
    clip, clips = _dryrun_clip(), None
    if cv2_available():
        import cv2

        vw = cv2.VideoWriter(os.path.join(video_dir, "a.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10, (DRYRUN_SIZE, DRYRUN_SIZE))
        for frame in clip:
            vw.write(frame)
        vw.release()
    else:
        clips = {"a.mp4": (clip, 10.0)}
        log("dryrun", "cv2 does not import: no mp4 is written, the harness reads the "
                      "clip's frames from memory")
    with open(os.path.join(anno, "scene_transition.json"), "w") as f:
        json.dump([
            {"video": "a.mp4", "question": "What happens first?",
             "candidates": ["fade", "cut", "wipe"], "answer": "cut"},
            {"video": "a.mp4", "question": "How many scenes?",
             "candidates": ["one", "two"], "answer": "two"},
        ], f)
    return llama_dir, ckpt, anno, media, clips


def stage_convert(args):
    options = list(args.options or [])
    for key, val in (("llama_model", args.llama), ("ckpt", args.ckpt),
                     ("q_former_model", args.qformer), ("vit_model_path", args.vit)):
        if val:
            options.append(f"model.{key}={val}")
    cfg = Config(args.cfg, options=options)
    model_cfg = cfg.model_cfg
    log("convert", f"building {model_cfg['arch']}/{model_cfg.get('model_type')} "
                   f"from {args.cfg} on {args.device}")
    model = registry.get_model_class(model_cfg["arch"]).from_config(model_cfg,
                                                                    device=args.device)
    ensure_tokenizers(model)
    n_params = sum(p.numel() for _, p in tree_paths(model.params))
    log("convert", f"OK — {len(model.params)} param families, "
                   f"{n_params / 1e6:.1f}M parameters")
    return cfg, model


def golden_logits(model, ids: np.ndarray) -> np.ndarray:
    """fp32 lm-head logits at the last position of each row of ``ids``."""
    llama = model.params["llama"]
    device = llama["embed_tokens"].device
    with torch.no_grad():
        hidden, _ = llama_forward(llama, input_ids=torch.as_tensor(ids, device=device),
                                  cfg=model.cfg.llama)
        return lm_head(llama, hidden)[:, -1].float().cpu().numpy()


def stage_parity(args, model) -> bool:
    ok = True
    if not args.skip_golden_suite:
        suite = REPO / "tests" / "test_torch_golden_full_size.py"
        if importlib.util.find_spec("jax") is None:
            log("parity", f"FAIL — the golden suite ({suite.name}) holds the port against "
                          "the JAX package, which does not import here; pass "
                          "--skip-golden-suite to go on without it")
            return False
        log("parity", f"running the golden suite ({suite.name}, -m slow; JAX fp32 oracle)")
        r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "slow", str(suite)],
                           cwd=REPO)
        if r.returncode != 0:
            log("parity", "FAIL — golden suite did not pass")
            return False
        log("parity", "golden suite OK")

    if args.record_golden:
        vocab = model.cfg.llama.vocab_size
        ids = np.random.default_rng(0).integers(0, vocab, (GOLDEN_PROMPTS, GOLDEN_LEN)
                                                ).astype(np.int32)
        np.savez(args.record_golden, input_ids=ids, logits=golden_logits(model, ids))
        log("parity", f"recorded {GOLDEN_PROMPTS} golden prompts -> {args.record_golden}")

    if args.golden:
        rec = np.load(args.golden)
        ids, want = rec["input_ids"], rec["logits"]
        got = golden_logits(model, ids)
        top1 = (got.argmax(-1) == want.argmax(-1)).mean()
        maxdiff = float(np.abs(got - want).max())
        log("parity", f"recorded goldens: top1 agreement {top1:.3f}, "
                      f"max |logit diff| {maxdiff:.4g}")
        if top1 < 1.0 or maxdiff > GOLDEN_ATOL:
            log("parity", "FAIL — converted model diverges from recorded goldens")
            ok = False

    if args.parity_llama and args.llama:
        if importlib.util.find_spec("transformers") is None:
            log("parity", "FAIL — --parity-llama reloads the LLaMA directory in HF "
                          "transformers, which does not import here")
            return False
        log("parity", f"direct HF-vs-converted logit check on {args.llama}")
        from transformers import LlamaForCausalLM

        hf = LlamaForCausalLM.from_pretrained(args.llama).eval()
        ids = np.random.default_rng(0).integers(0, hf.config.vocab_size, (1, 8))
        with torch.no_grad():
            want = hf(torch.from_numpy(ids)).logits[:, -1].float().numpy()
        got = golden_logits(model, ids)
        top1 = (got.argmax(-1) == want.argmax(-1)).mean()
        log("parity", f"HF direct: top1 agreement {top1:.3f}, "
                      f"max |logit diff| {float(np.abs(got - want).max()):.4g}")
        if top1 < 1.0:
            log("parity", "FAIL — converted llama diverges from HF")
            ok = False

    if ok:
        log("parity", "OK")
    return ok


def apply_tome(args, model) -> bool:
    """--tome LEVEL|auto: the token-merge level under test goes into the
    model config, so the run scores the level a throughput claim rides on.
    Returns False when a named level cannot apply to this geometry (the
    tiny trunk): the run is then unmerged."""
    vit = model.cfg.vit
    if not args.tome:
        if vit.merge_level:     # reset after a previous arm
            model.cfg = dataclasses.replace(model.cfg,
                                            vit=dataclasses.replace(vit, merge_level=""))
        return True
    if args.tome == "auto":
        model.cfg = dataclasses.replace(model.cfg,
                                        vit=dataclasses.replace(vit, merge_level="auto"))
        log("mvbench", "token merging: auto (per-video redundancy selector)")
        return True
    if vit.seq_len != 257:
        log("mvbench", f"--tome {args.tome}: named levels are defined for the full EVA-ViT-g "
                       "geometry (257 tokens/frame); this model is smaller — running unmerged")
        return False
    model.cfg = dataclasses.replace(model.cfg,
                                    vit=dataclasses.replace(vit, **level_kwargs(args.tome)))
    log("mvbench", f"token merging: {args.tome}")
    return True


def mvbench_dataset(args, resolution: int, clips=None):
    """The harness's dataset; with ``clips`` ({file name: (uint8 frames, fps)})
    ``read_video`` gathers the sample's frames from memory with the
    harness's own frame indices instead of decoding a file."""
    kw = dict(num_segments=args.num_frames, resolution=resolution,
              specified_item=args.specified_item, device=args.device)
    if clips is None:
        return MVBenchDataset(args.anno, args.data_root, **kw)
    class InMemory(MVBenchDataset):
        def read_video(self, path, bound=None):
            clip, fps = clips[os.path.basename(path)]
            idx = mvbench_frame_indices(bound, fps, len(clip) - 1, first_idx=0,
                                        num_segments=self.num_segments)
            return clip[idx]

    return InMemory(args.anno, args.data_root, **kw)


def stage_mvbench(args, cfg, model, clips=None) -> bool:
    model_cfg = cfg.model_cfg
    apply_tome(args, model)
    resolution = 224
    if isinstance(model_cfg.get("vit"), dict):
        resolution = model_cfg["vit"].get("image_size", 224)
    chat = model.chat(image_size=resolution)
    dataset = mvbench_dataset(args, resolution, clips)
    log("mvbench", f"{len(dataset)} samples ("
                   f"{'task ' + args.specified_item if args.specified_item else '20-task protocol'})")
    if args.serving_slots:
        log("mvbench", f"streaming through the continuous QA server "
                       f"(slots={args.serving_slots})")
    result = run_mvbench(chat, dataset, output_dir=args.out_dir, output_name=args.output_name,
                         all_token=model_cfg.get("video_input") != "mean",
                         batch_size=args.batch_size, serving_slots=args.serving_slots or None)
    acc = result["acc_dict"]
    log("mvbench", "per-task accuracy:")
    for task, v in acc.items():
        if task != "Total Acc":
            log("mvbench", f"  {task}: {v[0]}/{v[1]}")
    log("mvbench", f"Total Acc: {acc['Total Acc']} (reference headline: 54.9% — ST-LLM "
                   "paper Table 4 / mv_bench_infer.py protocol)")
    return True


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default=str(REPO / "config" / "instructblipbase_stllm_qa.yaml"))
    p.add_argument("--llama", help="HF Vicuna directory")
    p.add_argument("--qformer", help="instruct_blip_vicuna7b_trimmed.pth")
    p.add_argument("--vit", help="eva_vit_g .pth (optional; qformer ckpt may cover it)")
    p.add_argument("--ckpt", help="ST-LLM release checkpoint .pth")
    p.add_argument("--anno", help="MVBench json/ directory")
    p.add_argument("--data-root", default="", help="MVBench video root")
    p.add_argument("--out-dir", default="results/mvbench")
    p.add_argument("--output-name", default="mvbench")
    p.add_argument("--num-frames", type=int, default=100,
                   help="fps-1 adaptive cap, reference default")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--specified_item", default=None)
    p.add_argument("--tome", default=None,
                   help="token-merge level to score (a named level or 'auto')")
    p.add_argument("--serving-slots", type=int, default=0,
                   help="stream the eval through the continuous QA server "
                        "(pipeline_serving.VideoQAServer) with N slots")
    p.add_argument("--options", nargs="+", default=None,
                   help="extra dotlist config overrides")
    p.add_argument("--golden", help="recorded-golden .npz to verify against (either "
                                    "package's recording)")
    p.add_argument("--record-golden", help="record goldens .npz from this model")
    p.add_argument("--parity-llama", action="store_true",
                   help="also reload the llama dir in HF transformers and compare logits")
    p.add_argument("--skip-golden-suite", action="store_true")
    p.add_argument("--dry-run", action="store_true",
                   help="synthesize tiny weights + a one-task MVBench layout and drive "
                        "all three stages")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = p.parse_args(argv)
    args.device = "cpu" if args.cpu else "cuda"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log("convert", "FAIL — no CUDA device; pass --cpu to run on the CPU")
        return 1
    tmp, clips = None, None
    if args.dry_run:
        tmp = tempfile.TemporaryDirectory(prefix="replicate_dryrun_")
        llama_dir, ckpt, anno, media, clips = synthesize_dryrun(tmp.name)
        args.cfg = str(REPO / "config" / "tiny_debug.yaml")
        args.llama, args.ckpt = llama_dir, ckpt
        args.anno, args.data_root = anno, media
        args.num_frames, args.specified_item = 4, "Scene Transition"
        args.out_dir = os.path.join(tmp.name, "out")
        # tiny: the direct HF check is free where transformers imports
        args.parity_llama = importlib.util.find_spec("transformers") is not None
        if not args.parity_llama:
            log("dryrun", "transformers does not import: the direct HF check is left out")
        args.skip_golden_suite = True     # full-width suite: -m slow, on its own
        if not args.golden and not args.record_golden:
            # record, then verify: both golden paths run
            args.record_golden = os.path.join(tmp.name, "goldens.npz")
    try:
        cfg, model = stage_convert(args)
        if not stage_parity(args, model):
            return 1
        if args.dry_run and args.record_golden and not args.golden:
            args.golden, args.record_golden = args.record_golden, None
            if not stage_parity(args, model):
                return 1
        if not args.anno:
            log("mvbench", "skipped (no --anno given)")
        else:
            if not stage_mvbench(args, cfg, model, clips):
                return 1
            if args.dry_run:
                # both extra arms end to end: the token-merge dispatch ('auto'
                # resolves per video; the tiny geometry runs unmerged) and the
                # served eval
                log("dryrun", "arm 2/3: --tome auto")
                args.tome, args.output_name = "auto", "mvbench_tome"
                if not stage_mvbench(args, cfg, model, clips):
                    return 1
                log("dryrun", "arm 3/3: --serving-slots 2")
                args.tome, args.serving_slots = None, 2
                args.output_name = "mvbench_serving"
                if not stage_mvbench(args, cfg, model, clips):
                    return 1
        log("done", "all stages passed")
        return 0
    finally:
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    sys.exit(main())
