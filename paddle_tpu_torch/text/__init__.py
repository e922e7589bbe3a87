"""paddle.text parity: the NLP model zoo (the JAX package's datasets
are not ported yet)."""
from .models import (BertForPretraining, BertModel,  # noqa: F401
                     ErnieForPretraining, ErnieModel, GPTForCausalLM,
                     GPTModel, bert_base, ernie_base, gpt2_small,
                     gpt3_1p3b, gpt_tiny)
