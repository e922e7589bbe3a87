"""BERT / ERNIE encoder with the pretraining heads.

Port of the BERT half of ``paddle_tpu/text/models.py``: post-LN encoder,
flash attention, MLM decoder tied to the word embedding (one
``nn.Parameter`` registered under both ``bert.embeddings.word.weight``
and ``cls.decoder_weight``, as the reference's names go). GPT is not
ported yet.
"""
from __future__ import annotations

import torch

from .. import nn
from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from ..nn import functional as F
from ..nn import initializer


def _embedding(num, dim, std=0.02):
    return nn.Embedding(num, dim,
                        weight_attr=nn.ParamAttr(
                            initializer=initializer.Normal(0.0, std)))


class BertEmbeddings(Layer):
    def __init__(self, vocab_size, d_model, max_position=512,
                 type_vocab_size=2, dropout=0.1, eps=1e-12):
        super().__init__()
        self.word = _embedding(vocab_size, d_model)
        self.position = _embedding(max_position, d_model)
        self.token_type = _embedding(type_vocab_size, d_model)
        self.ln = nn.LayerNorm(d_model, epsilon=eps)
        self.dropout = dropout

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape[0], input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(
                s, dtype=torch.int64, device=input_ids.device).expand(b, s)
        x = self.word(input_ids) + self.position(position_ids)
        if token_type_ids is not None:
            x = x + self.token_type(token_type_ids)
        x = self.ln(x)
        if self.dropout:
            x = F.dropout(x, self.dropout, training=self.training)
        return x


class BertPooler(Layer):
    def __init__(self, d_model):
        super().__init__()
        self.dense = nn.Linear(d_model, d_model)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class BertModel(Layer):
    """Post-LN encoder trunk (BERT-base defaults).

    forward(input_ids, token_type_ids=None, attention_mask=None) ->
    (sequence_output [B, S, D], pooled_output [B, D]).
    attention_mask: [B, S] with 1 = attend, 0 = pad."""

    def __init__(self, vocab_size=30522, d_model=768, num_layers=12,
                 nhead=12, d_ffn=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, activation="gelu"):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, d_model, max_position,
                                         type_vocab_size, dropout)
        enc_layer = nn.TransformerEncoderLayer(
            d_model, nhead, d_ffn, dropout=dropout, activation=activation,
            normalize_before=False)
        self.encoder = nn.TransformerEncoder(enc_layer, num_layers)
        self.pooler = BertPooler(d_model)
        self.d_model = d_model
        self.vocab_size = vocab_size

    @staticmethod
    def _expand_mask(attention_mask):
        if attention_mask is None:
            return None
        m = nn.to_variable(attention_mask)
        return torch.where(m[:, None, None, :] > 0, 0.0, -1e30).to(
            torch.float32)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        x = self.encoder(x, src_mask=self._expand_mask(attention_mask))
        return x, self.pooler(x)


class BertPretrainingHeads(Layer):
    def __init__(self, d_model, vocab_size, embedding_weight=None):
        super().__init__()
        self.transform = nn.Linear(d_model, d_model)
        self.ln = nn.LayerNorm(d_model)
        self.decoder_weight = embedding_weight  # tied
        self.decoder_bias = self.create_parameter((vocab_size,),
                                                  is_bias=True)
        self.seq_relationship = nn.Linear(d_model, 2)

    def forward(self, sequence_output, pooled_output):
        h = self.ln(F.gelu(self.transform(sequence_output)))
        scores = trace_op(
            "matmul_v2", {"X": [h], "Y": [self.decoder_weight]},
            {"trans_y": True}, out_slots=["Out"])[0]
        scores = scores + self.decoder_bias
        nsp = self.seq_relationship(pooled_output)
        return scores, nsp


class BertForPretraining(Layer):
    """MLM + NSP heads (ERNIE-style pretraining objective)."""

    def __init__(self, **bert_kwargs):
        super().__init__()
        self.bert = BertModel(**bert_kwargs)
        self.cls = BertPretrainingHeads(
            self.bert.d_model, self.bert.vocab_size,
            embedding_weight=self.bert.embeddings.word.weight)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        mlm_scores, nsp_scores = self.cls(seq, pooled)
        if masked_lm_labels is None:
            return mlm_scores, nsp_scores
        b, s = masked_lm_labels.shape[0], masked_lm_labels.shape[1]
        flat_labels = masked_lm_labels.reshape((b * s, 1))
        # per-masked-token mean: sum of non-ignored losses / count of
        # non-ignored positions (paddle/HF MLM semantics)
        mlm_sum = F.cross_entropy(
            mlm_scores.reshape((b * s, self.bert.vocab_size)),
            flat_labels, ignore_index=-1, reduction="sum")
        dev = flat_labels.device
        valid = trace_op("not_equal", {
            "X": [flat_labels],
            "Y": [torch.tensor(-1, dtype=torch.int64, device=dev)]},
            out_slots=["Out"])[0]
        count = trace_op("reduce_sum",
                         {"X": [trace_op("cast", {"X": [valid]},
                                         {"out_dtype": "float32"},
                                         out_slots=["Out"])[0]]},
                         {"reduce_all": True}, out_slots=["Out"])[0]
        count = trace_op("elementwise_max", {
            "X": [count],
            "Y": [torch.tensor(1.0, dtype=torch.float32, device=dev)]},
            out_slots=["Out"])[0]
        loss = mlm_sum / count
        if next_sentence_label is not None:
            loss = loss + F.cross_entropy(nsp_scores, next_sentence_label)
        return loss


# ERNIE is architecture-identical to BERT at this snapshot
ErnieModel = BertModel
ErnieForPretraining = BertForPretraining


def bert_base(**kw):
    return BertModel(**kw)


def ernie_base(**kw):
    """ERNIE-1.0 base: BERT-base widths over ERNIE's 18,000-token vocab
    (ref ``paddle_tpu/text/models.py:317-318``)."""
    return BertModel(vocab_size=kw.pop("vocab_size", 18000), **kw)
