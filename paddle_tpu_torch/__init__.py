"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

GPT serving (bucketed prefill + paged decode, optionally with int8
weights and int8 KV pools) and ERNIE pretraining
(``ErnieForPretraining.pretraining_loss``, ``loss.backward()``, an
``AdamW`` step) on an NVIDIA Hopper card, with hand-written CUDA kernels
for flash attention (forward with dropout and sliding window, and the two
backward kernels) and paged attention over fp or int8 pools (``csrc/``). Entry points run on the
CUDA card unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain PyTorch version. Imports torch, never jax,
and nothing of ``paddle_tpu``.
"""
from .models.ernie import ErnieConfig, ErnieForPretraining
from .models.gpt import GPTConfig, GPTForCausalLM
from .optimizer import AdamW
from .serving import SamplingParams, ServingConfig, ServingEngine

__all__ = ["AdamW", "ErnieConfig", "ErnieForPretraining", "GPTConfig",
           "GPTForCausalLM", "SamplingParams", "ServingConfig",
           "ServingEngine"]
