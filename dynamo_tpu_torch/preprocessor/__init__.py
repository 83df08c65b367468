"""OpenAI-request preprocessor: templating + tokenization -> PreprocessedRequest.

Parity: reference ``lib/llm/src/preprocessor.rs:92-424``
(``OpenAIPreprocessor::{new, preprocess_request}``) and
``preprocessor/prompt/template/*`` (minijinja chat templating from HF
``chat_template``).
"""

from dynamo_tpu_torch.preprocessor.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.preprocessor.template import PromptFormatter
from dynamo_tpu_torch.preprocessor.tokenizer import DecodeStream, HfTokenizer

__all__ = ["OpenAIPreprocessor", "PromptFormatter", "HfTokenizer", "DecodeStream"]
