"""High-dimensional (bilateral) Gaussian filtering, the port of
``representationlearning_tpu/ops/bilateral.py``: the on-device replacement of
the reference's C++ permutohedral lattice (`SCD-AAAI2023/wrapper/bilateralfilter/`:
features (x / sxy, y / sxy, r / srgb, g / srgb, b / srgb), every class channel
filtered, the batch in parallel).

The bilateral grid: multilinear splat of every pixel into the 32 corners of its
cell of a regular 5-D grid (``index_add_``), a separable 5-tap Gaussian blur
along each grid axis as shift-and-add, multilinear slice back at the same 32
corners. ``bilateral_filter_brute`` computes the dense Gaussian transform
out_i = sum_j exp(-|f_i - f_j|^2 / 2) in_j exactly, in O(N^2), and is the
yardstick of the tests.

Grid calibration, as in the JAX package: splat and slice each convolve with a
unit triangle (variance 1/6 on unit-spaced cells), so the blur uses
sigma^2 = 1 - 2/6, and its taps are scaled so that the composite per-axis
kernel has the mass sqrt(2 pi) of exp(-t^2 / 2).

The JAX package computes all of this outside any Pallas kernel, so this is
plain PyTorch. Images are (3, H, W) in [0, 255], inputs (K, H, W); the batched
entry point takes (N, 3, H, W) and (N, K, H, W). ``index_add_`` on the card
adds with atomics, so the grid's sums may differ in the last bits from run to
run.
"""
from __future__ import annotations

import math

import torch

from ..native import bilateral_filter_batch_native

PAD = 2  # blur radius, in grid cells
# amplitude of the standard permutohedral lattice (d=5, [1,2,1] blur, alpha) relative
# to the exact Gaussian transform sum_j exp(-|fi-fj|^2/2) vj (the JAX package's figure)
LATTICE_GAIN_5D = 24.5


def _features(image: torch.Tensor, sigma_rgb: float, sigma_xy: float) -> torch.Tensor:
    """image (..., 3, H, W) in [0, 255] -> (..., H, W, 5) features in units of sigma."""
    H, W = image.shape[-2:]
    lead = image.shape[:-3]
    y = torch.arange(H, dtype=torch.float32, device=image.device) / sigma_xy
    x = torch.arange(W, dtype=torch.float32, device=image.device) / sigma_xy
    yy = y[:, None].expand(lead + (H, W))
    xx = x[None, :].expand(lead + (H, W))
    rgb = (image.float() / sigma_rgb).movedim(-3, -1)
    return torch.cat([xx[..., None], yy[..., None], rgb], dim=-1)


def bilateral_filter_brute(image: torch.Tensor, inputs: torch.Tensor, sigma_rgb: float,
                           sigma_xy: float) -> torch.Tensor:
    """The exact dense Gaussian transform, self term included. image (3, H, W) in
    [0, 255], inputs (K, H, W) -> (K, H, W). O((H W)^2): for tests."""
    K, H, W = inputs.shape
    f = _features(image, sigma_rgb, sigma_xy).reshape(H * W, 5)
    d2 = ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1)
    A = torch.exp(-0.5 * d2)
    return (inputs.reshape(K, H * W).float() @ A.T).reshape(K, H, W)


def _grid_dims(H: int, W: int, sigma_rgb: float, sigma_xy: float,
               value_range: float) -> tuple[int, ...]:
    gx = int(math.ceil((W - 1) / sigma_xy)) + 1 + 2 * PAD
    gy = int(math.ceil((H - 1) / sigma_xy)) + 1 + 2 * PAD
    gc = int(math.ceil(value_range / sigma_rgb)) + 1 + 2 * PAD
    return (gx, gy, gc, gc, gc)


def _blur_taps() -> list[float]:
    sig2 = 1.0 - 2.0 / 6.0
    taps = [math.exp(-0.5 * t * t / sig2) for t in range(-PAD, PAD + 1)]
    norm = math.sqrt(2.0 * math.pi) / sum(taps)
    return [t * norm for t in taps]


def _blur(g: torch.Tensor, axis: int, taps: list[float]) -> torch.Tensor:
    """taps[PAD] g[i] + sum_t taps[PAD + t] (g[i - t] + g[i + t]) along axis, zeros
    beyond the ends (not circular). The shifted terms are added in place into
    the centre term, slice by slice, so a pass allocates one tensor."""
    acc = taps[PAD] * g
    n = g.shape[axis]
    for t in range(1, min(PAD, n - 1) + 1):
        acc.narrow(axis, t, n - t).add_(g.narrow(axis, 0, n - t), alpha=taps[PAD + t])
        acc.narrow(axis, 0, n - t).add_(g.narrow(axis, t, n - t), alpha=taps[PAD + t])
    return acc


def _filter_grid(images: torch.Tensor, inputs: torch.Tensor, sigma_rgb: float,
                 sigma_xy: float, value_range: float) -> torch.Tensor:
    """The grid filter on a batch: images (N, 3, H, W), inputs (N, K, H, W). The
    images' grids are slabs of one (N * cells, K) tensor, and the 32 corners'
    indices and weights are made in one go, so the batch costs one pass of
    every step."""
    N, K, H, W = inputs.shape
    dims = _grid_dims(H, W, sigma_rgb, sigma_xy, value_range)
    total = math.prod(dims)
    dev = inputs.device

    f = _features(images.clamp(0.0, value_range), sigma_rgb, sigma_xy)
    f = f.reshape(N * H * W, 5) + PAD  # offset into the padded grid
    lo = f.floor()
    frac = f - lo
    strides = torch.tensor([math.prod(dims[d + 1:]) for d in range(5)], device=dev)
    base = torch.arange(N, device=dev).repeat_interleave(H * W) * total  # each image's slab
    # corner c adds bit d of c to the cell index of axis d: (32, 1, 5) against (N H W, 5)
    bits = torch.tensor([[(c >> d) & 1 for d in range(5)] for c in range(32)],
                        device=dev)[:, None, :]
    idx = ((lo.long() + bits) * strides).sum(-1) + base         # (32, N H W)
    w = torch.where(bits.bool(), frac, 1.0 - frac).prod(-1)     # (32, N H W)
    vals = inputs.float().reshape(N, K, H * W).transpose(1, 2).reshape(N * H * W, K)

    # splat: 32-corner multilinear scatter-add
    grid = torch.zeros((N * total, K), dtype=torch.float32, device=dev)
    for c in range(32):
        grid.index_add_(0, idx[c], vals * w[c, :, None])

    # blur: separable, one pass along each grid axis
    taps = _blur_taps()
    g = grid.reshape((N,) + dims + (K,))
    for axis in range(1, 6):
        g = _blur(g, axis, taps)
    grid = g.reshape(N * total, K)

    # slice: multilinear gather at the same corners
    out = torch.zeros((N * H * W, K), dtype=torch.float32, device=dev)
    for c in range(32):
        out.addcmul_(grid.index_select(0, idx[c]), w[c, :, None])
    return out.reshape(N, H * W, K).transpose(1, 2).reshape(N, K, H, W)


def bilateral_filter_grid(image: torch.Tensor, inputs: torch.Tensor, sigma_rgb: float,
                          sigma_xy: float, value_range: float = 255.0) -> torch.Tensor:
    """Bilateral-grid approximation of ``bilateral_filter_brute``: image (3, H, W)
    in [0, value_range], inputs (K, H, W) -> (K, H, W)."""
    return _filter_grid(image[None], inputs[None], sigma_rgb, sigma_xy, value_range)[0]


def bilateral_filter_batch(images: torch.Tensor, inputs: torch.Tensor, sigma_rgb: float,
                           sigma_xy: float, method: str = "grid") -> torch.Tensor:
    """Batched (N, 3, H, W) x (N, K, H, W) -> (N, K, H, W); replaces
    `bilateralfilter_batch` (`bilateralfilter.cpp:42-55`).

    method="grid": the bilateral grid (the exact Gaussian sum's amplitude).
    method="brute": the exact O(N^2) transform (tests).
    method="native": the host C++ permutohedral lattice (``native/``), the
    reference's own amplitude (the exact sum x ``LATTICE_GAIN_5D``): NCHW to NHWC
    numpy on the host and the result back on the inputs' device, as the JAX
    package's ``pure_callback`` does."""
    if method == "native":
        out = bilateral_filter_batch_native(
            images.detach().float().permute(0, 2, 3, 1).cpu().numpy(),
            inputs.detach().float().permute(0, 2, 3, 1).cpu().numpy(), sigma_rgb, sigma_xy)
        return torch.from_numpy(out).permute(0, 3, 1, 2).contiguous().to(inputs.device)
    if method == "grid":
        return _filter_grid(images, inputs, sigma_rgb, sigma_xy, 255.0)
    if method == "brute":
        return torch.stack([bilateral_filter_brute(im, x, sigma_rgb, sigma_xy)
                            for im, x in zip(images, inputs)])
    raise ValueError(f"unknown bilateral method {method!r}; expected 'grid', 'brute', "
                     "or 'native'")
