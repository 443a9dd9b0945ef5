"""The UI-free core of the chat demos (stllm_tpu/demo_core.py).

Both front ends, ``demo_web`` (a stdlib HTTP page) and ``demo_gradio``
(gradio wiring), build the same model and Chat and run the same
question-answer semantics. The gradio handlers are plain functions over
(chat, state) here, so their behaviour is tested although gradio is not
installed: every question re-encodes the uploaded video with the question
as the Q-Former text input, and the sliders map to num_segments, num_beams
and temperature.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def build_chat(cfg_path: str, ckpt_path: Optional[str] = None, options=None, device=None):
    """YAML config -> model -> Chat, tokenizers ensured: the one
    construction path of every demo. ``device``: the CUDA card unless the
    caller names another ("cpu"). A ``ckpt_path`` that exists raises, as
    ``STLLM.from_config`` does for every weight path: loading weights is
    not ported yet."""
    import stllm_tpu_torch.data  # noqa: F401  (registers processors)
    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.common.device import resolve_device
    from stllm_tpu_torch.common.registry import registry
    from stllm_tpu_torch.models.zoo import ensure_tokenizers

    dev = resolve_device(device)
    cfg = Config(cfg_path, options=options)
    model_cfg = cfg.model_cfg
    if ckpt_path:
        model_cfg["ckpt"] = ckpt_path
    model = registry.get_model_class(model_cfg["arch"]).from_config(model_cfg, device=dev)
    ensure_tokenizers(model)
    vit_cfg = model_cfg.get("vit")
    size = vit_cfg.get("image_size", 224) if isinstance(vit_cfg, dict) else 224
    return model.chat(image_size=size)


def gradio_upload(video: Optional[str], num_segments: int) -> Tuple[Dict, str]:
    """Upload handler: returns (state, status message). The video is only
    recorded; it is encoded per question."""
    if not video:
        return {}, "Choose a video first."
    from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0

    state = {"conv": CONV_instructblip_Vicuna0.copy(), "img_list": [],
             "video": video, "num_segments": int(num_segments)}
    return state, "Video received — ask a question."


def gradio_ask(chat, question: str, num_beams: int, temperature: float,
               chatbot: List, state: Optional[Dict],
               max_new_tokens: int = 300) -> Tuple[List, Optional[Dict]]:
    """Question handler: re-encode the video with the question as Q-Former
    text, ask, answer. Returns (chatbot', state)."""
    if not state or state.get("video") is None:
        return chatbot + [[question, "Please upload a video first."]], state
    conv = state["conv"]
    img_list = state["img_list"]
    img_list.clear()
    conv.messages.clear()
    chat.upload_video(state["video"], conv, img_list, state["num_segments"], text=question)
    chat.ask(question, conv)
    answer, _ = chat.answer(conv=conv, img_list=img_list, num_beams=int(num_beams),
                            do_sample=False, temperature=float(temperature),
                            max_new_tokens=max_new_tokens, max_length=2000)
    return chatbot + [[question, answer]], state
