from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel, RMSNorm, StackedLlamaDecoder,
    llama_7b, llama_13b, llama_tiny)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "RMSNorm",
           "StackedLlamaDecoder", "llama_tiny", "llama_7b", "llama_13b"]
