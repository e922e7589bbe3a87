"""Loss ops beyond the softmax cross-entropy family.

Port of every op type of ``paddle_tpu/ops/loss_ops.py`` (ref:
paddle/fluid/operators/: bce_loss_op.cc, kldiv_loss_op.cc,
log_loss_op.cc, hinge_loss_op.h, rank_loss_op.h, margin_rank_loss_op.h,
bpr_loss_op.h, nll_loss_op.h, center_loss_op.h, cos_sim_op.h,
minus_op.cc, dist_op.cc, label_smooth_op.cc,
detection/sigmoid_focal_loss_op.cu, hierarchical_sigmoid_op.h,
nce_op.h), elementwise and reduction torch code differentiated by
autograd. ``nce`` draws its negatives from the port's generators
(``core/rng``), so its draws are not the reference's (threefry and
Philox never draw alike); its loss is the reference's formula on them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import rng
from ..core.enforce import InvalidArgumentError, enforce
from ..core.registry import register_op


@register_op("bce_loss", non_differentiable_inputs=("Label",))
def bce_loss(inputs, attrs):
    """ref: bce_loss_op.cc: binary cross entropy on probabilities, x
    clipped to [1e-12, 1 - 1e-12]."""
    x, label = inputs["X"][0], inputs["Label"][0]
    x = x.clamp(1e-12, 1.0 - 1e-12)
    return {"Out": [-(label * torch.log(x)
                      + (1.0 - label) * torch.log1p(-x))]}


@register_op("kldiv_loss", non_differentiable_inputs=("Target",))
def kldiv_loss(inputs, attrs):
    """ref: kldiv_loss_op.cc: target * (log(target) - x), 0 where
    target <= 0; reduction none / sum / mean / batchmean."""
    x, target = inputs["X"][0], inputs["Target"][0]
    reduction = attrs.get("reduction", "mean")
    raw = target * (torch.log(target.clamp_min(1e-30)) - x)
    raw = torch.where(target > 0, raw, 0.0)
    if reduction == "none":
        out = raw
    elif reduction == "sum":
        out = raw.sum()
    elif reduction == "batchmean":
        out = raw.sum() / x.shape[0]
    else:
        out = raw.mean()
    return {"Loss": [out]}


@register_op("log_loss", non_differentiable_inputs=("Labels",))
def log_loss(inputs, attrs):
    pred, label = inputs["Predicted"][0], inputs["Labels"][0]
    eps = float(attrs.get("epsilon", 1e-4))
    return {"Loss": [-label * torch.log(pred + eps)
                     - (1.0 - label) * torch.log(1.0 - pred + eps)]}


@register_op("hinge_loss", non_differentiable_inputs=("Labels",))
def hinge_loss(inputs, attrs):
    """ref: hinge_loss_op.h: max(0, 1 - pred * (2 label - 1))."""
    pred, label = inputs["Logits"][0], inputs["Labels"][0]
    return {"Loss": [torch.clamp_min(1.0 - pred * (2.0 * label - 1.0),
                                     0.0)]}


@register_op("rank_loss", non_differentiable_inputs=("Label",))
def rank_loss(inputs, attrs):
    """ref: rank_loss_op.h: softplus(L - R) - label * (L - R)."""
    d = inputs["Left"][0] - inputs["Right"][0]
    return {"Out": [F.softplus(d) - inputs["Label"][0] * d]}


@register_op("margin_rank_loss", non_differentiable_inputs=("Label",))
def margin_rank_loss(inputs, attrs):
    """ref: margin_rank_loss_op.h: max(0, -label (x1 - x2) + margin) and
    the Activated mask."""
    label, x1, x2 = inputs["Label"][0], inputs["X1"][0], inputs["X2"][0]
    raw = -label * (x1 - x2) + float(attrs.get("margin", 0.0))
    return {"Out": [torch.clamp_min(raw, 0.0)],
            "Activated": [(raw > 0).to(x1.dtype)]}


@register_op("bpr_loss", non_differentiable_inputs=("Label",))
def bpr_loss(inputs, attrs):
    """ref: bpr_loss_op.h: the mean over the negatives j != label of
    -log(sigmoid(x_label - x_j)) = softplus(x_j - x_label)."""
    x, label = inputs["X"][0], inputs["Label"][0]
    x2 = x.reshape(-1, x.shape[-1])
    lab = label.reshape(-1).long()
    c = x2.shape[1]
    pos = x2.gather(1, lab[:, None])
    mask = torch.arange(c, device=x.device)[None, :] != lab[:, None]
    loss = (F.softplus(x2 - pos) * mask).sum(dim=1, keepdim=True) / (c - 1)
    return {"Y": [loss.reshape(label.shape)]}


@register_op("nll_loss", non_differentiable_inputs=("Label", "Weight"))
def nll_loss(inputs, attrs):
    """ref: nll_loss_op.h: negative log likelihood over log-probs X [N, C,
    ...] with class weights and ignore_index; Total_weight is the sum of
    the weights taken (the divisor of reduction "mean")."""
    x, label = inputs["X"][0], inputs["Label"][0]
    weight = (inputs.get("Weight") or [None])[0]
    ignore = int(attrs.get("ignore_index", -100))
    reduction = attrs.get("reduction", "mean")
    n, c = x.shape[0], x.shape[1]
    x2 = x.reshape(n, c, -1)
    lab2 = label.reshape(n, x2.shape[2]).long()
    safe = lab2.clamp(0, c - 1)
    picked = x2.gather(1, safe[:, None, :])[:, 0]
    w = weight[safe] if weight is not None else torch.ones_like(picked)
    w = w * (lab2 != ignore)
    per = -picked * w
    total = w.sum()
    if reduction == "none":
        out = per.reshape(label.shape)
    elif reduction == "sum":
        out = per.sum()
    else:
        out = per.sum() / total.clamp_min(1e-12)
    return {"Out": [out], "Total_weight": [total]}


@register_op("sigmoid_focal_loss",
             non_differentiable_inputs=("Label", "FgNum"))
def sigmoid_focal_loss(inputs, attrs):
    """ref: detection/sigmoid_focal_loss_op.cu: RetinaNet's focal loss on
    logits X [N, C]; Label [N, 1] in 0..C (0 background, class d positive
    where label == d + 1, -1 ignored); FgNum [1] the normaliser."""
    x = inputs["X"][0]
    label = inputs["Label"][0].reshape(-1).long()
    fg = inputs["FgNum"][0].reshape(-1)[0].to(x.dtype)
    gamma = float(attrs.get("gamma", 2.0))
    alpha = float(attrs.get("alpha", 0.25))
    d = torch.arange(x.shape[1], device=x.device)[None, :]
    g = label[:, None]
    c_pos = (g == d + 1).to(x.dtype)
    c_neg = ((g != -1) & (g != d + 1)).to(x.dtype)
    fg_num = fg.clamp_min(1.0)
    p = torch.sigmoid(x)
    term_pos = torch.pow(1.0 - p, gamma) * torch.log(p.clamp_min(1e-38))
    pos = (x >= 0).to(x.dtype)
    # log(1 - p) for logits, stable on both sides
    term_neg = torch.pow(p, gamma) * (
        -x * pos - torch.log1p(torch.exp(x - 2.0 * x * pos)))
    out = -c_pos * term_pos * (alpha / fg_num) \
        - c_neg * term_neg * ((1.0 - alpha) / fg_num)
    return {"Out": [out]}


@register_op("center_loss",
             non_differentiable_inputs=("Label", "CenterUpdateRate"))
def center_loss(inputs, attrs):
    """ref: center_loss_op.h: 0.5 ||x - center_label||^2 a sample; with
    ``need_update`` the centres move toward their class means, scaled by
    the rate over 1 + the class count."""
    x = inputs["X"][0]
    label = inputs["Label"][0].reshape(-1).long()
    centers = inputs["Centers"][0]
    rate = inputs["CenterUpdateRate"][0].reshape(-1)[0]
    diff = x - centers[label]
    loss = 0.5 * torch.square(diff).sum(dim=1, keepdim=True)
    if attrs.get("need_update", False):
        onehot = F.one_hot(label, centers.shape[0]).to(x.dtype)
        count = onehot.sum(dim=0)
        centers_out = centers + rate * (onehot.T @ diff) / (
            1.0 + count)[:, None]
    else:
        centers_out = centers
    return {"Loss": [loss], "SampleCenterDiff": [diff],
            "CentersOut": [centers_out]}


@register_op("cos_sim")
def cos_sim(inputs, attrs):
    """ref: cos_sim_op.h: row-wise cosine similarity; Y may have one row
    broadcast against X's batch."""
    x, y = inputs["X"][0], inputs["Y"][0]
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    dot = torch.sum(x * y, dim=-1, keepdim=True)
    return {"Out": [dot / (xn * yn)], "XNorm": [xn], "YNorm": [yn]}


@register_op("dist")
def dist(inputs, attrs):
    """ref: dist_op.cc: the p-norm of the broadcast difference, 0-d
    (p = inf / -inf: the largest / smallest |x - y|; p = 0: the count of
    nonzero differences)."""
    x, y = inputs["X"][0], inputs["Y"][0]
    p = float(attrs.get("p", 2.0))
    d = torch.abs(x - y)
    if p == float("inf"):
        out = d.amax()
    elif p == float("-inf"):
        out = d.amin()
    elif p == 0:
        out = (d != 0).to(x.dtype).sum()
    else:
        out = torch.pow(torch.pow(d, p).sum(), 1.0 / p)
    return {"Out": [out.reshape(())]}


@register_op("minus")
def minus(inputs, attrs):
    """ref: minus_op.cc."""
    return {"Out": [inputs["X"][0] - inputs["Y"][0]]}


@register_op("label_smooth", non_differentiable_inputs=("PriorDist",))
def label_smooth(inputs, attrs):
    """ref: label_smooth_op.cc: (1 - eps) label + eps prior (uniform
    1 / num_classes without PriorDist)."""
    x = inputs["X"][0]
    prior = (inputs.get("PriorDist") or [None])[0]
    eps = float(attrs.get("epsilon", 0.0))
    smooth = prior.reshape((1,) * (x.ndim - 1) + (-1,)) \
        if prior is not None else 1.0 / x.shape[-1]
    return {"Out": [(1.0 - eps) * x + eps * smooth]}


@register_op("hierarchical_sigmoid",
             non_differentiable_inputs=("Label", "PathTable", "PathCode"),
             intermediate_outputs=("PreOut", "W_Out"))
def hierarchical_sigmoid(inputs, attrs):
    """Hierarchical softmax (ref: hierarchical_sigmoid_op.h and
    math/matrix_bit_code.h SimpleCode): by default the complete binary
    tree over num_classes leaves (code c = label + num_classes, weight
    row (c >> (bit + 1)) - 1, branch bit (c >> bit) & 1, code length
    floor(log2 c)); PathTable / PathCode give a tree of their own."""
    x, w = inputs["X"][0], inputs["W"][0]
    label = inputs["Label"][0].reshape(-1).long()
    bias = (inputs.get("Bias") or [None])[0]
    path = (inputs.get("PathTable") or [None])[0]
    code = (inputs.get("PathCode") or [None])[0]
    num_classes = int(attrs.get("num_classes", w.shape[0] + 1))
    if path is not None:
        idx = path.long()
        bits = code.to(torch.float32)
        valid = idx >= 0
        idx = idx.clamp_min(0)
    else:
        max_len = int(num_classes - 1).bit_length()
        c = label + num_classes
        b = torch.arange(max_len, device=x.device)
        idx = (c[:, None] >> (b[None, :] + 1)) - 1
        bits = ((c[:, None] >> b[None, :]) & 1).to(torch.float32)
        lengths = torch.floor(torch.log2(c.to(torch.float32))).long()
        valid = b[None, :] < lengths[:, None]
        idx = idx.clamp(0, w.shape[0] - 1)
    pre = torch.einsum("nd,nld->nl", x, w[idx])
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx]
    pre = pre.clamp(-40.0, 40.0)
    loss_bits = torch.clamp_min(pre, 0.0) - pre * bits + torch.log1p(
        torch.exp(-torch.abs(pre)))
    cost = torch.where(valid, loss_bits, 0.0).sum(dim=1, keepdim=True)
    return {"Out": [cost], "PreOut": [pre], "W_Out": [w]}


@register_op("nce", non_differentiable_inputs=("Label", "SampleWeight",
                                               "CustomDistProbs",
                                               "CustomDistAlias",
                                               "CustomDistAliasProbs"),
             intermediate_outputs=("SampleLogits", "SampleLabels"))
def nce(inputs, attrs):
    """Noise-contrastive estimation (ref: nce_op.h): k uniform negatives
    a row, cost -log(o / (o + kq)) for the true classes and -log(kq / (o
    + kq)) for each negative, o = sigmoid(logit), q = 1 / total. The
    negatives are drawn on the CPU from ``core/rng``'s generator for the
    op's ``seed`` and moved, so a seed draws the same on every device;
    SampleLabels returns them."""
    x, label, w = inputs["Input"][0], inputs["Label"][0], inputs["Weight"][0]
    bias = (inputs.get("Bias") or [None])[0]
    sampler = attrs.get("sampler", 0)
    enforce(sampler in (0, "uniform"),
            f"nce: only the uniform sampler is implemented, got "
            f"{sampler!r} (log_uniform/custom_dist would silently train "
            "the wrong objective)", InvalidArgumentError)
    enforce(not inputs.get("CustomDistProbs"),
            "nce: custom noise distributions are not supported",
            InvalidArgumentError)
    k = int(attrs.get("num_neg_samples", 10))
    total = int(attrs.get("num_total_classes", w.shape[0]))
    n = x.shape[0]
    num_true = label.shape[1] if label.ndim > 1 else 1
    label = label.reshape(n, num_true).long()
    if x.device.type == "meta":            # shape inference draws nothing
        noise = torch.empty((n, k), dtype=torch.int64, device="meta")
    else:
        gen = rng.random_generator(int(attrs.get("seed", 0)), "cpu")
        noise = torch.randint(0, total, (n, k), generator=gen).to(x.device)
    sampled = torch.cat([label, noise], dim=1)        # [N, T + K]
    logits = torch.einsum("nd,nsd->ns", x, w[sampled])
    if bias is not None:
        logits = logits + bias.reshape(-1)[sampled]
    o = torch.sigmoid(logits)
    b = (1.0 / total) * k
    cost_true = -torch.log(o / (o + b) + 1e-20)
    cost_noise = -torch.log(b / (o + b) + 1e-20)
    is_true = torch.arange(sampled.shape[1], device=x.device)[None, :] \
        < num_true
    per_row = torch.where(is_true, cost_true, cost_noise).sum(
        dim=1, keepdim=True)
    sw = (inputs.get("SampleWeight") or [None])[0]
    if sw is not None:
        per_row = per_row * sw.reshape(n, 1)
    return {"Cost": [per_row], "SampleLogits": [logits],
            "SampleLabels": [sampled]}
