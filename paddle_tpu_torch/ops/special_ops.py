"""Model-family ops: rank_attention (CTR ranking), tree_conv (TBCNN),
var_conv_2d (text matching), pyramid_hash (text hash embedding) and
bilateral_slice (HDRNet).

Port of ``paddle_tpu/ops/special_ops.py``: the same static-shape gathers,
masks and einsums, which torch runs on cuBLAS and its own kernels.
``tree_conv`` builds its patches on the host from the edge set (one
host read), as the reference's tree2col does. ``pyramid_hash`` is the
reference's multiplicative 32-bit hash, computed in int64 with the
products taken modulo 2^32 (torch has no uint32 arithmetic).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.enforce import InvalidArgumentError, enforce, host_only
from ..core.registry import register_op


# -------------------------------------------------------- rank_attention
@register_op("rank_attention",
             intermediate_outputs=("InputHelp", "InsRank"),
             non_differentiable_inputs=("RankOffset",))
def rank_attention(inputs, attrs):
    """X [N, D]; RankOffset [N, 1 + 2 * MaxRank]: the instance's rank
    (1-based, <= 0 invalid), then (rank_k, index_k) pairs; RankParam
    [MaxRank^2 * D, P], a [D, P] block for each (rank, rank) pair:
    Out[i] = sum_k valid_k * X[index_k] @ block(rank_i, rank_k)."""
    x = inputs["X"][0]
    offs = inputs["RankOffset"][0].to(torch.int64)
    param = inputs["RankParam"][0]
    max_rank = int(attrs.get("MaxRank", 3))
    n, d = x.shape
    p = param.shape[-1]
    enforce(offs.shape[1] == 1 + 2 * max_rank,
            f"rank_attention: RankOffset must be [N, {1 + 2 * max_rank}]",
            InvalidArgumentError)
    enforce(param.shape[0] == max_rank * max_rank * d,
            f"rank_attention: RankParam must be [{max_rank * max_rank * d}"
            f", P]", InvalidArgumentError)
    ins_rank = offs[:, 0]
    lower = ins_rank - 1
    faster = offs[:, 1::2] - 1
    index = offs[:, 2::2]
    valid = (lower[:, None] >= 0) & (faster >= 0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x_exp = torch.where(valid[:, :, None], x[index.clamp(0, n - 1)], zero)
    blocks = param.reshape(max_rank * max_rank, d, p)
    sel = (lower[:, None] * max_rank + faster.clamp_min(0)).clamp(
        0, max_rank * max_rank - 1)
    w = torch.where(valid[:, :, None, None], blocks[sel], zero.to(
        param.dtype))
    return {"Out": [torch.einsum("nkd,nkdp->np", x_exp, w)],
            "InputHelp": [x_exp.reshape(n, max_rank * d)],
            "InsRank": [ins_rank.to(x.dtype)]}


# ------------------------------------------------------------ tree_conv
def _tree_patches(edges: np.ndarray, num_nodes: int, max_depth: int):
    """Host-side tree2col (ref: operators/math/tree2col.cc): each node's
    patch is its subtree cut at ``max_depth``, each member weighted by
    continuous-binary-tree coefficients (eta_t, eta_l, eta_r). Returns
    (indices [N, M], etas [N, M, 3], mask [N, M])."""
    children = {}
    for a, b in edges:
        a, b = int(a), int(b)
        if a < 0 or b < 0:
            continue
        children.setdefault(a, []).append(b)
    patches = []
    for root in range(num_nodes):
        patch = [(root, 1, 1, 1)]
        frontier = [(root, 1)]
        while frontier:
            node, depth = frontier.pop(0)
            if depth >= max_depth:
                continue
            kids = children.get(node, [])
            for ci, k in enumerate(kids):
                patch.append((k, depth + 1, ci + 1, len(kids)))
                frontier.append((k, depth + 1))
        patches.append(patch)
    m = max(len(pp) for pp in patches)
    idx = np.zeros((num_nodes, m), np.int64)
    etas = np.zeros((num_nodes, m, 3), np.float32)
    mask = np.zeros((num_nodes, m), np.float32)
    for i, pp in enumerate(patches):
        depth_max = max(dd for _, dd, _, _ in pp)
        for j, (node, depth, pos, nsib) in enumerate(pp):
            idx[i, j] = node
            mask[i, j] = 1.0
            eta_t = (depth - 1) / (depth_max - 1) if depth_max > 1 else 1.0
            eta_t = 1.0 - eta_t
            if nsib > 1:
                eta_r = (1.0 - eta_t) * (pos - 1) / (nsib - 1)
            else:
                eta_r = (1.0 - eta_t) * 0.5
            etas[i, j] = (eta_t, (1.0 - eta_t) - eta_r, eta_r)
    return idx, etas, mask


@register_op("tree_conv", non_differentiable_inputs=("EdgeSet",))
def tree_conv(inputs, attrs):
    """NodesVector [B, N, D], EdgeSet [B, E, 2] (parent -> child, -1
    pads), Filter [D, 3, out, channels] -> Out [B, N, out, channels]."""
    nodes, w = inputs["NodesVector"][0], inputs["Filter"][0]
    edges = host_only(inputs["EdgeSet"][0], "tree_conv")
    max_depth = int(attrs.get("max_depth", 2))
    n = nodes.shape[1]
    outs = []
    for g in range(nodes.shape[0]):
        idx, etas, mask = _tree_patches(edges[g], n, max_depth)
        coef = torch.from_numpy(etas * mask[:, :, None]).to(
            nodes.device, nodes.dtype)
        patch = nodes[g][torch.from_numpy(idx).to(nodes.device)]
        outs.append(torch.einsum("nmc,nmd,dcof->nof", coef, patch, w))
    return {"Out": [torch.stack(outs)]}


# ----------------------------------------------------------- var_conv_2d
@register_op("var_conv_2d", non_differentiable_inputs=("ROW", "COLUMN"))
def var_conv_2d(inputs, attrs):
    """Conv over per-instance variable-size maps: X [B, C, Hmax, Wmax]
    with ROW / COLUMN [B] valid sizes; positions past them are zeroed
    before and after the conv."""
    x = inputs["X"][0]
    rows = inputs["ROW"][0].to(torch.int64)
    cols = inputs["COLUMN"][0].to(torch.int64)
    w = inputs["W"][0]
    oc = int(attrs.get("OutputChannel", w.shape[0]))
    kh, kw = int(attrs.get("KernelH", 3)), int(attrs.get("KernelW", 3))
    sh, sw = int(attrs.get("StrideH", 1)), int(attrs.get("StrideW", 1))
    b, c, h, wd = x.shape
    dev = x.device

    def valid(hh, ww, r, cc):
        return ((torch.arange(hh, device=dev)[None, :, None] <
                 r[:, None, None]) &
                (torch.arange(ww, device=dev)[None, None, :] <
                 cc[:, None, None]))[:, None]

    xm = x * valid(h, wd, rows, cols).to(x.dtype)
    xm = F.pad(xm, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    out = F.conv2d(xm, w.reshape(oc, c, kh, kw), stride=(sh, sw))
    mo = valid(out.shape[2], out.shape[3], (rows + sh - 1) // sh,
               (cols + sw - 1) // sw)
    return {"Out": [out * mo.to(out.dtype)]}


# ---------------------------------------------------------- pyramid_hash
_M32 = 0xFFFFFFFF


def _mix(h):
    """The reference's 32-bit finalizer on int64 values in [0, 2^32)."""
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & _M32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


@register_op("pyramid_hash", intermediate_outputs=("DropPos",
                                                   "X_Temp_Out"),
             non_differentiable_inputs=("X",))
def pyramid_hash(inputs, attrs):
    """Hash n-gram windows of token ids into a shared embedding space and
    sum them a position: X [B, T] int tokens (0 pads), W [space_len,
    rand_len] -> Out [B, T, num_emb]; position t sums the embeddings of
    every window [t, t + win) for win = 2..pyramid_layer."""
    x = inputs["X"][0].to(torch.int64) & _M32
    w = inputs["W"][0]
    num_emb = int(attrs.get("num_emb", w.shape[1]))
    space_len = int(attrs.get("space_len", w.shape[0]))
    pyramid = int(attrs.get("pyramid_layer", 2))
    rand_len = int(attrs.get("rand_len", w.shape[1]))
    seed = int(attrs.get("seed", 1))
    enforce(num_emb % rand_len == 0,
            "pyramid_hash: num_emb must be a multiple of rand_len",
            InvalidArgumentError)
    b, t = x.shape
    out = torch.zeros((b, t, num_emb), dtype=w.dtype, device=w.device)
    for win in range(2, pyramid + 1):
        if win > t:
            break
        span = t - win + 1
        hw = torch.zeros((b, span), dtype=torch.int64, device=x.device)
        valid = torch.ones((b, span), dtype=torch.bool, device=x.device)
        for j in range(win):
            hw = _mix((hw * 31 + x[:, j:span + j]) & _M32)
            valid &= x[:, j:span + j] != 0
        emb = torch.cat([w[_mix((hw + seed + c) & _M32) % space_len]
                         for c in range(num_emb // rand_len)], -1)
        emb = emb * valid[:, :, None].to(w.dtype)
        out = out + F.pad(emb, (0, 0, 0, t - span))
    return {"Out": [out],
            "DropPos": [torch.zeros((b, t), dtype=torch.int32,
                                    device=x.device)],
            "X_Temp_Out": [x.to(torch.int32)]}


# -------------------------------------------------------- bilateral_slice
@register_op("bilateral_slice", non_differentiable_inputs=())
def bilateral_slice(inputs, attrs):
    """HDRNet: Grid [N, coeff_ch, gd, gh, gw], Guide [N, H, W] in [0, 1],
    X [N, C, H, W]. The coefficients are sliced trilinearly from the
    grid at (x gw / W, y gh / H, guide gd), the eight corner taps
    clamped to the grid; has_offset: out_c = sum_i A[c, i] x_i + A[c, C],
    else the sum alone."""
    grid, guide, x = inputs["Grid"][0], inputs["Guide"][0], inputs["X"][0]
    has_offset = bool(attrs.get("has_offset", False))
    n, cc, gd, gh, gw = grid.shape
    c, h, w = x.shape[1:]
    per = c + 1 if has_offset else c
    enforce(cc % per == 0,
            f"bilateral_slice: coeff channels {cc} not divisible by "
            f"{per}", InvalidArgumentError)
    f32 = dict(dtype=torch.float32, device=x.device)
    gx = (torch.arange(w, **f32) + 0.5) * gw / w - 0.5
    gy = (torch.arange(h, **f32) + 0.5) * gh / h - 0.5
    gz = guide * gd - 0.5
    x0, y0, z0 = (torch.floor(v).to(torch.int64) for v in (gx, gy, gz))
    fx, fy, fz = gx - x0, gy - y0, gz - z0

    def tap(zi, yi, xi):
        g = grid[:, :, :, yi.clamp(0, gh - 1)][..., xi.clamp(0, gw - 1)]
        z = zi.clamp(0, gd - 1)[:, None, None].expand(n, cc, 1, h, w)
        return torch.gather(g, 2, z)[:, :, 0]              # [N, cc, H, W]

    coeff = 0.
    for dz in (0, 1):
        wz = 1.0 - fz if dz == 0 else fz
        for dy in (0, 1):
            wy = 1.0 - fy if dy == 0 else fy
            for dx in (0, 1):
                wx = 1.0 - fx if dx == 0 else fx
                weight = wz * wy[:, None] * wx[None, :]
                coeff = coeff + weight[:, None] * tap(z0 + dz, y0 + dy,
                                                      x0 + dx)
    a = coeff.reshape(n, cc // per, per, h, w)
    out = torch.einsum("nochw,nchw->nohw", a[:, :, :c], x)
    if has_offset:
        out = out + a[:, :, c]
    return {"Out": [out]}
