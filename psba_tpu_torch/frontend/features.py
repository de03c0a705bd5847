"""Feature detection and description (PyTorch counterpart of
psba_tpu.frontend.features).

Harris corner response with a fixed-size top-k selection, and a
normalized-patch descriptor, as convolutions, a max-pool and gathers on
tensors. Every function runs on the device of its tensor input; an image
given as an array goes to `device`, CUDA unless the caller names another
(and an error where torch sees no card).

cuDNN runs float32 convolutions in TF32 by default; the Sobel and box
filters run with TF32 off (`fp32`), as the reference's convolutions run in
float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from psba_tpu_torch.utils.device import resolve_device


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor input stays on its device (cast to `dtype` if given); an
    array goes to `device`, CUDA unless the caller names another."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    elif device is None:
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(
        device, "psba_tpu_torch.frontend", "it"))


@contextlib.contextmanager
def fp32():
    """Float32 convolutions and matrix products on the card (TF32 off),
    the previous settings restored after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _sobel(img):
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=img.dtype,
                      device=img.device) / 8.0
    pad = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")
    win = F.conv2d(pad, torch.stack([kx, kx.T])[:, None])[0]
    return win[0], win[1]


def _box_blur(x, radius=1):
    k = 2 * radius + 1
    kern = torch.full((1, 1, k, k), 1.0 / (k * k), dtype=x.dtype,
                      device=x.device)
    pad = F.pad(x[None, None], (radius,) * 4, mode="replicate")
    return F.conv2d(pad, kern)[0, 0]


def harris_corners(img, k: int = 256, kappa: float = 0.04, device=None):
    """Top-k Harris corners of a grayscale image [H, W].

    Returns (xy [k, 2] float32 (x, y) pixel coordinates, score [k]).
    Non-maximum suppression is a 3x3 max-pool equality test (the pool pads
    with -inf, as the reference's reduce_window); border responses are
    zeroed so descriptors always have full patches. Suppressed and border
    pixels score 0, so the order among zero scores is the top-k's own."""
    img = as_tensor(img, device, torch.float32)
    with fp32():
        ix, iy = _sobel(img)
        sxx = _box_blur(ix * ix)
        syy = _box_blur(iy * iy)
        sxy = _box_blur(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    R = det - kappa * tr * tr
    mx = F.max_pool2d(R[None, None], 3, stride=1, padding=1)[0, 0]
    R = torch.where(R >= mx, R, 0.0)
    b = 8  # border margin for descriptor patches
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    inside = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    R = torch.where(inside, R, 0.0)
    score, idx = torch.topk(R.reshape(-1), k)
    y, x = idx // W, idx % W
    return torch.stack([x, y], dim=1).to(torch.float32), score


def describe(img, xy, patch: int = 8, device=None):
    """Normalized patch descriptors [k, patch * patch] at integer corners.
    A patch's start is clamped into the image, as the reference's
    lax.dynamic_slice clamps it."""
    img = as_tensor(img, device, torch.float32)
    xy = xy.to(img.device)
    H, W = img.shape
    half = patch // 2
    ar = torch.arange(patch, device=img.device)
    x0 = (xy[:, 0].to(torch.int64) - half).clamp(0, W - patch)
    y0 = (xy[:, 1].to(torch.int64) - half).clamp(0, H - patch)
    w = img[(y0[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]
    w = w - w.mean(dim=(1, 2), keepdim=True)
    norm = torch.linalg.vector_norm(w, dim=(1, 2), keepdim=True)
    return (w / (norm + 1e-6)).reshape(xy.shape[0], -1)


def detect_and_describe(img, k: int = 256, patch: int = 8, device=None):
    """(xy [k, 2], score [k], desc [k, patch^2])."""
    img = as_tensor(img, device, torch.float32)
    xy, score = harris_corners(img, k=k)
    return xy, score, describe(img, xy, patch=patch)
