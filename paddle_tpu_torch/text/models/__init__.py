from .bert import (  # noqa: F401
    BertConfig, BertForPretraining, BertModel, BertPretrainingCriterion,
    bert_base, bert_large, bert_tiny, ernie_base)
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel, RMSNorm, StackedLlamaDecoder,
    llama_7b, llama_13b, llama_tiny)
from .transformer import (  # noqa: F401
    CrossEntropyCriterion, TransformerConfig, TransformerModel,
    beam_translate, greedy_translate, transformer_base, transformer_big,
    transformer_tiny)

__all__ = ["BertConfig", "BertForPretraining", "BertModel",
           "BertPretrainingCriterion", "bert_base", "bert_large",
           "bert_tiny", "ernie_base",
           "LlamaConfig", "LlamaForCausalLM", "LlamaModel", "RMSNorm",
           "StackedLlamaDecoder", "llama_tiny", "llama_7b", "llama_13b",
           "CrossEntropyCriterion", "TransformerConfig", "TransformerModel",
           "beam_translate", "greedy_translate", "transformer_base",
           "transformer_big", "transformer_tiny"]
