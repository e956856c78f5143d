"""Port of :mod:`apex_tpu.models` (GPT at tp=1: training forward and decode
branch; the T5-class encoder-decoder's training forward; BERT's padded MLM
training forward)."""

from apex_tpu_torch.models.bert import BertConfig, BertModel  # noqa: F401
from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,  # noqa: F401
                                       param_leaves)
from apex_tpu_torch.models.t5 import (EncoderDecoderModel,  # noqa: F401
                                      T5Config)
