"""Models package (stllm_tpu/models/__init__.py). Importing registers the
model zoo (registration by import side effect) and re-exports the public
names (``distill_draft`` stays in ``models.distill``: it imports the
trainer, which imports this package); ``model_zoo`` prints the
architectures and their model types."""

from stllm_tpu_torch.models import zoo as _zoo  # noqa: F401  (registry side effect)
from stllm_tpu_torch.models.generation import GenerationConfig, beam_search, generate  # noqa: F401
from stllm_tpu_torch.models.llama import (  # noqa: F401
    VICUNA_7B,
    KVCache,
    LlamaConfig,
    init_llama,
    llama_forward,
    lm_head,
)
from stllm_tpu_torch.models.lora import add_lora, merge_lora  # noqa: F401
from stllm_tpu_torch.models.speculative import speculative_generate  # noqa: F401
from stllm_tpu_torch.models.qformer import (  # noqa: F401
    INSTRUCT_BLIP_QFORMER,
    QFormerConfig,
    init_qformer,
    qformer_forward,
)
from stllm_tpu_torch.models.stllm import (  # noqa: F401
    STLLMConfig,
    encode_img,
    encode_img_mapped,
    encode_video_for_inference,
    init_stllm,
    stllm_forward,
)
from stllm_tpu_torch.models.vit import EVA_VIT_G, ViTConfig, init_vit, vit_forward  # noqa: F401
from stllm_tpu_torch.models.zoo import (  # noqa: F401
    STLLM,
    build_stllm_config,
    ensure_tokenizers,
    load_model_and_preprocess,
)


class ModelZoo:
    """Printable arch / model-type table."""

    def __str__(self) -> str:
        from stllm_tpu_torch.common.registry import Registry

        lines = ["=" * 50,
                 f"{'Architectures':<30} {'Types'}",
                 "=" * 50]
        for name in Registry.list_models():
            cls = Registry.get_model_class(name)
            types = ", ".join(getattr(cls, "PRETRAINED_MODEL_CONFIG_DICT", {}))
            lines.append(f"{name:<30} {types}")
        return "\n".join(lines)


model_zoo = ModelZoo()
