"""Gradio chat demo (the root demo_gradio.py of the JAX package).

Needs the optional ``gradio`` package:
    python -m stllm_tpu_torch.demo_gradio --cfg-path config/... [--cpu]

Upload a video, ask questions; every question re-encodes the video with the
question as the Q-Former text, and sliders set the beam count, the
temperature and the number of sampled segments. The model-facing logic
lives in ``stllm_tpu_torch/demo_core.py`` (shared with ``demo_web``); this
file is wiring only.
"""

import argparse
import functools


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Gradio demo")
    parser.add_argument("--cfg-path", default="config/instructblipbase_stllm_conversation.yaml")
    parser.add_argument("--ckpt-path", default=None)
    parser.add_argument("--options", nargs="+", default=None)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--server-port", type=int, default=7860)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("stllm_tpu_torch.demo_gradio needs the optional 'gradio' package; "
                         "for a page without it use stllm_tpu_torch.demo_web")
    from stllm_tpu_torch.demo_core import build_chat, gradio_ask, gradio_upload

    chat = build_chat(args.cfg_path, ckpt_path=args.ckpt_path, options=args.options,
                      device="cpu" if args.cpu else None)

    def upload(video, num_segments, state):
        new_state, status = gradio_upload(video, num_segments)
        return new_state or state, status

    with gr.Blocks() as demo:
        gr.Markdown("# ST-LLM video chat")
        state = gr.State()
        with gr.Row():
            with gr.Column():
                video = gr.Video()
                num_segments = gr.Slider(4, 96, value=64, step=4, label="num segments")
                num_beams = gr.Slider(1, 10, value=5, step=1, label="beams")
                temperature = gr.Slider(0.1, 2.0, value=1.0, step=0.1, label="temperature")
                upload_btn = gr.Button("Upload")
                status = gr.Textbox(label="status")
            with gr.Column():
                chatbot = gr.Chatbot()
                question = gr.Textbox(label="question")
        upload_btn.click(upload, [video, num_segments, state], [state, status])
        question.submit(functools.partial(gradio_ask, chat),
                        [question, num_beams, temperature, chatbot, state], [chatbot, state])
    demo.launch(server_port=args.server_port)


if __name__ == "__main__":
    main()
