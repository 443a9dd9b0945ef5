from stllm_tpu_torch.runners.runner_base import RunnerBase  # noqa: F401  (registration)
