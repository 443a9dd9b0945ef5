from stllm_tpu_torch.conversation.conversation import (
    CONV_instructblip_Vicuna0,
    CONV_VIDEO_LLama2,
    CONV_VIDEO_Vicuna0,
    CONV_VISION_LLama2,
    CONV_VISION_Vicuna0,
    Chat,
    Conversation,
    EasyDict,
    SeparatorStyle,
)

__all__ = [
    "CONV_instructblip_Vicuna0",
    "CONV_VIDEO_LLama2",
    "CONV_VIDEO_Vicuna0",
    "CONV_VISION_LLama2",
    "CONV_VISION_Vicuna0",
    "Chat",
    "Conversation",
    "SeparatorStyle",
]
