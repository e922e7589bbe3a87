"""The bilinear gather shared by the sampling ops.

Port of ``paddle_tpu/ops/_sampling.py``: one implementation of the
out-of-range tap rule that ``grid_sampler`` (vision_ops) and
``deformable_conv`` (nn_ops) use. With ``zero_oob_taps`` a corner tap
outside the image contributes 0 (a sample within a pixel of the border
still gets its partial blend); without it the taps are clamped to the
border pixel. The reference maps it over the batch with ``jax.vmap``;
here an image may carry the batch dim itself.
"""
from __future__ import annotations

import torch


def _take(img, yc, xc):
    """``img[..., c, yc, xc]`` for index tensors of a common shape S: img
    [C, H, W] with S any shape, or [N, C, H, W] with S = [N, *rest]."""
    w = img.shape[-1]
    flat = yc * w + xc
    if img.ndim == 3:
        c = img.shape[0]
        return img.reshape(c, -1)[:, flat.reshape(-1)].reshape(
            (c,) + tuple(flat.shape))
    n, c = img.shape[:2]
    idx = flat.reshape(n, 1, -1).expand(n, c, -1)
    return torch.gather(img.reshape(n, c, -1), 2, idx).reshape(
        (n, c) + tuple(flat.shape[1:]))


def bilinear_gather(img, yy, xx, zero_oob_taps):
    """4-tap bilinear sample of ``img`` ([C, H, W], or [N, C, H, W]) at
    float coordinates ``yy`` / ``xx`` (shape S, or [N, *S]) -> [C, *S]
    (or [N, C, *S])."""
    h, w = img.shape[-2:]
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    ly = (yy - y0).to(img.dtype)
    lx = (xx - x0).to(img.dtype)
    cdim = 0 if img.ndim == 3 else 1

    def at(yi, xi):
        yc = yi.to(torch.int32).clamp(0, h - 1).long()
        xc = xi.to(torch.int32).clamp(0, w - 1).long()
        v = _take(img, yc, xc)
        if zero_oob_taps:
            ok = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            v = v * ok.unsqueeze(cdim).to(v.dtype)
        return v

    ly, lx = ly.unsqueeze(cdim), lx.unsqueeze(cdim)   # broadcast over C
    return (at(y0, x0) * (1 - ly) * (1 - lx)
            + at(y0, x0 + 1) * (1 - ly) * lx
            + at(y0 + 1, x0) * ly * (1 - lx)
            + at(y0 + 1, x0 + 1) * ly * lx)
