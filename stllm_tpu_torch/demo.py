"""Single-video QA demo (the root demo.py of the JAX package).

Usage:
  python -m stllm_tpu_torch.demo --cfg-path config/tiny_debug.yaml --cpu \\
      --video-path clip.mp4 --question "Why is it funny?"

It runs on the CUDA card unless given ``--cpu``. With the default
conversation config and no weights it runs the full-size model on random
weights with toy tokenizers (gibberish answers, every code path).
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Demo")
    parser.add_argument("--cfg-path", default="config/instructblipbase_stllm_conversation.yaml",
                        help="path to configuration file.")
    parser.add_argument("--ckpt-path", default=None, help="path to STLLM conversation weights.")
    parser.add_argument("--video-path", default="example/BaoguoMa.mp4")
    parser.add_argument("--image-path", default=None,
                        help="single-image QA instead of video (1-frame path)")
    parser.add_argument("--question", default="Tell me why this video looks so funny?")
    parser.add_argument("--num-frames", type=int, default=64)
    parser.add_argument("--num-beams", type=int, default=5)
    parser.add_argument("--max-new-tokens", type=int, default=300)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--options", nargs="+", help="override config options, key=value")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0
    from stllm_tpu_torch.demo_core import build_chat

    print("Initializing Chat")
    chat = build_chat(args.cfg_path, ckpt_path=args.ckpt_path, options=args.options,
                      device="cpu" if args.cpu else None)
    print("Initialization Finished")

    conv = CONV_instructblip_Vicuna0.copy()
    img_list = []
    if args.image_path:
        import cv2

        img = cv2.cvtColor(cv2.imread(args.image_path), cv2.COLOR_BGR2RGB)
        chat.upload_img(img, conv, img_list)
    else:
        chat.upload_video(args.video_path, conv, img_list, args.num_frames, text=args.question)
    chat.ask("###Human: " + args.question + " ###Assistant: ", conv)
    answer, _ = chat.answer(conv=conv, img_list=img_list, num_beams=args.num_beams,
                            do_sample=False, temperature=1.0,
                            max_new_tokens=args.max_new_tokens, max_length=2000)
    print(answer)
    return answer


if __name__ == "__main__":
    main()
