"""paddle.text parity: the NLP model zoo and the datasets."""
from .models import (BertForPretraining, BertModel,  # noqa: F401
                     ErnieForPretraining, ErnieModel, GPTForCausalLM,
                     GPTModel, bert_base, ernie_base, gpt2_small,
                     gpt3_1p3b, gpt_tiny)
from .datasets import (Conll05st, Imdb, Imikolov, Movielens,  # noqa: F401
                       UCIHousing, WMT14, WMT16)
