"""Text model zoo: GPT-style causal LM and BERT/ERNIE encoders.

Port of ``paddle_tpu/text/models.py``: the pre-LN GPT decoder (causal
flash attention, a KV cache through ``GPTDecoderBlock(cache=...)``, an
optional MoE MLP) with its LM head tied to the token embedding, and the
post-LN BERT encoder with the pretraining heads, whose MLM decoder is
tied to the word embedding (one ``nn.Parameter`` registered under both
``bert.embeddings.word.weight`` and ``cls.decoder_weight``, as the
reference's names go). Position ids are made on the input's device, not
from host data as in the reference, so a forward waits for no copy.
"""
from __future__ import annotations

import torch

from .. import nn
from ..distributed.moe import MoELayer
from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from ..nn import functional as F
from ..nn import initializer


def _embedding(num, dim, std=0.02):
    return nn.Embedding(num, dim,
                        weight_attr=nn.ParamAttr(
                            initializer=initializer.Normal(0.0, std)))


def _positions(input_ids):
    """[B, S] int64 positions 0..S-1 on the ids' device."""
    b, s = input_ids.shape[0], input_ids.shape[1]
    return torch.arange(s, dtype=torch.int64,
                        device=input_ids.device).expand(b, s)


class GPTDecoderBlock(Layer):
    """Pre-LN decoder block: LN→causal MHA→residual, LN→MLP→residual.
    ``moe`` switches the MLP to a MoELayer. With ``cache`` (a
    ``nn.MultiHeadAttention.Cache``) forward returns ``(x, new_cache)``."""

    def __init__(self, d_model, nhead, d_ffn, dropout=0.0, moe=False,
                 num_experts=8, moe_top_k=2, activation="gelu",
                 sp_axis=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model)
        self.attn = nn.MultiHeadAttention(d_model, nhead, dropout=dropout,
                                          causal=True, sp_axis=sp_axis)
        self.ln2 = nn.LayerNorm(d_model)
        self.is_moe = moe
        if moe:
            self.mlp = MoELayer(d_model, d_ffn, num_experts,
                                top_k=moe_top_k, activation=activation)
        else:
            self.fc1 = nn.Linear(d_model, d_ffn)
            self.fc2 = nn.Linear(d_ffn, d_model)
        self.dropout = dropout
        self.activation = activation

    def forward(self, x, cache=None):
        h = self.ln1(x)
        if cache is not None:
            a, cache = self.attn(h, attn_mask=None, cache=cache)
        else:
            a = self.attn(h)
        x = x + a
        h = self.ln2(x)
        if self.is_moe:
            h = self.mlp(h)
        else:
            h = self.fc2(getattr(F, self.activation)(self.fc1(h)))
        if self.dropout:
            h = F.dropout(h, self.dropout, training=self.training)
        x = x + h
        if cache is not None:
            return x, cache
        return x


class GPTModel(Layer):
    """Decoder-only LM trunk. forward(input_ids [B, S]) -> [B, S, D]."""

    def __init__(self, vocab_size, d_model=768, num_layers=12, nhead=12,
                 d_ffn=None, max_position=2048, dropout=0.0, moe=False,
                 num_experts=8, moe_top_k=2, sp_axis=None):
        super().__init__()
        d_ffn = d_ffn or 4 * d_model
        self.wte = _embedding(vocab_size, d_model)
        self.wpe = _embedding(max_position, d_model)
        self.blocks = nn.LayerList([
            GPTDecoderBlock(d_model, nhead, d_ffn, dropout, moe=moe,
                            num_experts=num_experts, moe_top_k=moe_top_k,
                            sp_axis=sp_axis)
            for _ in range(num_layers)])
        self.ln_f = nn.LayerNorm(d_model)
        self.d_model = d_model
        self.vocab_size = vocab_size
        self.dropout = dropout

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = _positions(input_ids)
        x = self.wte(input_ids) + self.wpe(position_ids)
        if self.dropout:
            x = F.dropout(x, self.dropout, training=self.training)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)

    def aux_losses(self):
        return [blk.mlp.aux_loss for blk in self.blocks
                if blk.is_moe and blk.mlp.aux_loss is not None]


class GPTForCausalLM(Layer):
    """LM head tied to the token embedding; loss = next-token CE
    (+ the MoE aux losses, weighted, when experts are enabled)."""

    def __init__(self, vocab_size, d_model=768, num_layers=12, nhead=12,
                 d_ffn=None, max_position=2048, dropout=0.0, moe=False,
                 num_experts=8, moe_top_k=2, aux_loss_weight=0.01,
                 sp_axis=None):
        super().__init__()
        self.gpt = GPTModel(vocab_size, d_model, num_layers, nhead, d_ffn,
                            max_position, dropout, moe, num_experts,
                            moe_top_k, sp_axis=sp_axis)
        self.aux_loss_weight = aux_loss_weight

    def forward(self, input_ids, labels=None):
        h = self.gpt(input_ids)
        # tied lm head: logits = h @ wte^T
        logits = trace_op(
            "matmul_v2", {"X": [h], "Y": [self.gpt.wte.weight]},
            {"trans_y": True}, out_slots=["Out"])[0]
        if labels is None:
            return logits
        b, s = labels.shape[0], labels.shape[1]
        shift_logits = logits[:, :-1, :].reshape(
            ((s - 1) * b, self.gpt.vocab_size))
        shift_labels = labels[:, 1:].reshape(((s - 1) * b, 1))
        loss = F.cross_entropy(shift_logits, shift_labels)
        for aux in self.gpt.aux_losses():
            loss = loss + self.aux_loss_weight * aux
        return logits, loss


# ---------------------------------------------------------------------------
# BERT / ERNIE encoder
# ---------------------------------------------------------------------------
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
        if position_ids is None:
            position_ids = _positions(input_ids)
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


def gpt_tiny(vocab_size=1024, **kw):
    return GPTForCausalLM(vocab_size, d_model=128, num_layers=2, nhead=4,
                          max_position=512, **kw)


def gpt2_small(vocab_size=50257, **kw):
    return GPTForCausalLM(vocab_size, d_model=768, num_layers=12, nhead=12,
                          max_position=1024, **kw)


def gpt3_1p3b(vocab_size=50257, **kw):
    """GPT-3 XL (Brown et al. 2020, Table 2.1): d 2048, 24 layers, 16
    heads of 128, d_ffn 8192, context 2048."""
    return GPTForCausalLM(vocab_size, d_model=2048, num_layers=24,
                          nhead=16, max_position=2048, **kw)


def bert_base(**kw):
    return BertModel(**kw)


def ernie_base(**kw):
    """ERNIE-1.0 base: BERT-base widths over ERNIE's 18,000-token vocab
    (ref ``paddle_tpu/text/models.py:317-318``)."""
    return BertModel(vocab_size=kw.pop("vocab_size", 18000), **kw)
