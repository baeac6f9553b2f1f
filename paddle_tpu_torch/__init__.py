"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu's serving path.

GPT serving (bucketed prefill + paged decode) on an NVIDIA Hopper card,
with hand-written CUDA kernels for flash-attention forward and paged
attention (``csrc/``). Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version. Imports torch, never jax, and nothing of ``paddle_tpu``.
"""
from .models.gpt import GPTConfig, GPTForCausalLM
from .serving import SamplingParams, ServingConfig, ServingEngine

__all__ = ["GPTConfig", "GPTForCausalLM", "SamplingParams", "ServingConfig",
           "ServingEngine"]
