"""DenseCRF mean-field inference, the port of ``representationlearning_tpu/ops/crf.py``:
the on-device replacement of the pydensecrf wrappers
(`SCD-AAAI2023/utils/dcrf.py:7-68`, `WaveCAM-TMM2023/misc/imutils.py:156-169`).

A fully connected CRF with Potts compatibility and two Gaussian pairwise
kernels (spatial sxy, bilateral sxy / srgb), solved by mean-field iteration:
    Q <- softmax(-U + sum_m w_m * k_m (x) Q)
with symmetrically normalised kernels (pydensecrf's NORMALIZE_SYMMETRIC). The
bilateral message uses ``ops/bilateral.py`` (the grid, the host lattice or the
exact transform); the spatial message is a separable Gaussian blur whose taps
are zero-padded at the borders and not normalised: the symmetric normalisation
``rsqrt(clip(K 1, 1e-20))`` absorbs both. As in the JAX package the
self-interaction is deliberately not subtracted: the k(x_i, x_i) Q_i term damps
the iteration (subtracting it makes strong compatibilities oscillate around
boundaries).

Images are (3, H, W) in [0, 255], unaries and Q (C, H, W), label maps (H, W);
every function runs where its inputs live.

Default parameter sets, as the reference's:
- ``crf_inference``       : softmax unary, Gaussian sxy=3 compat=3, bilateral sxy=80
                            srgb=13 compat=10 (`dcrf.py:7-24`)
- ``crf_inference_label`` : label unary (gt_prob 0.7), Gaussian sxy=3 compat=3,
                            bilateral sxy=50 srgb=5 compat=10 (`dcrf.py:26-40`)
"""
from __future__ import annotations

import math

import torch

from .bilateral import bilateral_filter_batch, bilateral_filter_grid


def _gaussian_blur_2d(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable spatial Gaussian over the last two axes of (..., H, W),
    truncated at 3 sigma, zeros beyond the borders."""
    r = max(1, int(math.ceil(3 * sigma)))
    taps = torch.exp(-0.5 * (torch.arange(-r, r + 1, dtype=torch.float64) / sigma) ** 2)
    taps = taps.float().tolist()   # the f32 taps JAX's numpy computes

    def blur_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
        acc = taps[r] * a
        n = a.shape[axis]
        for t in range(1, min(r, n - 1) + 1):
            acc.narrow(axis, t, n - t).add_(a.narrow(axis, 0, n - t), alpha=taps[r + t])
            acc.narrow(axis, 0, n - t).add_(a.narrow(axis, t, n - t), alpha=taps[r + t])
        return acc

    return blur_axis(blur_axis(x, -2), -1)


def _sym_normalize(filter_fn, x: torch.Tensor) -> torch.Tensor:
    """Symmetric kernel normalisation: x -> D^-1/2 K (D^-1/2 x), D = K 1."""
    ones = torch.ones((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    norm = torch.rsqrt(filter_fn(ones).clamp(min=1e-20))
    return filter_fn(x * norm) * norm


def mean_field_inference(image: torch.Tensor, unary: torch.Tensor, t: int = 10,
                         sxy_g: float = 3.0, compat_g: float = 3.0, sxy_b: float = 80.0,
                         srgb_b: float = 13.0, compat_b: float = 10.0,
                         method: str = "grid") -> torch.Tensor:
    """image (3, H, W) in [0, 255]; unary (C, H, W) negative log probabilities.
    Returns Q (C, H, W).

    ``method`` picks the bilateral message: "grid" (the bilateral grid on the
    inputs' device), "native" (the exact C++ permutohedral lattice on the host, the
    backend family pydensecrf itself uses), "brute" (the exact O(N^2) Gaussian,
    tiny images). The symmetric normalisation cancels any constant gain between
    them, so they differ only in approximation error."""
    image = image.float()

    def g_fn(v):
        return _gaussian_blur_2d(v, sxy_g)

    if method == "grid":
        def b_fn(v):
            return bilateral_filter_grid(image, v, srgb_b, sxy_b)
    else:
        def b_fn(v):
            return bilateral_filter_batch(image[None], v[None], srgb_b, sxy_b, method=method)[0]

    Q = torch.softmax(-unary, dim=0)
    for _ in range(t):
        msg = compat_g * _sym_normalize(g_fn, Q) + compat_b * _sym_normalize(b_fn, Q)
        Q = torch.softmax(-unary + msg, dim=0)
    return Q


def unary_from_softmax(probs: torch.Tensor, clip: float = 1e-8) -> torch.Tensor:
    return -torch.log(probs.clamp(min=clip))


def unary_from_labels(labels: torch.Tensor, n_labels: int, gt_prob: float = 0.7) -> torch.Tensor:
    """(H, W) int labels -> (n_labels, H, W) unary, every label confident
    (pydensecrf's zero_unsure=False)."""
    p_other = (1.0 - gt_prob) / max(n_labels - 1, 1)
    onehot = torch.nn.functional.one_hot(labels.long(), n_labels).permute(2, 0, 1).float()
    probs = onehot * gt_prob + (1.0 - onehot) * p_other
    return -torch.log(probs)


def crf_inference(img: torch.Tensor, probs: torch.Tensor, t: int = 10,
                  scale_factor: float = 1.0, labels: int = 21,
                  method: str = "grid") -> torch.Tensor:
    """`dcrf.py:7-24`: softmax probabilities (C, H, W) -> refined ones (C, H, W)."""
    return mean_field_inference(
        img, unary_from_softmax(probs.float()), t=t, sxy_g=3.0 / scale_factor, compat_g=3.0,
        sxy_b=80.0 / scale_factor, srgb_b=13.0, compat_b=10.0, method=method)


def crf_inference_label(img: torch.Tensor, labels_map: torch.Tensor, t: int = 10,
                        n_labels: int = 21, gt_prob: float = 0.7,
                        method: str = "grid") -> torch.Tensor:
    """`dcrf.py:26-40` / `imutils.py:156-169`: hard labels (H, W) -> the refined
    argmax (H, W), int64."""
    Q = mean_field_inference(
        img, unary_from_labels(labels_map, n_labels, gt_prob), t=t, sxy_g=3.0, compat_g=3.0,
        sxy_b=50.0, srgb_b=5.0, compat_b=10.0, method=method)
    return Q.argmax(0)


class DenseCRF:
    """Parameterised wrapper (`dcrf.py:42-68`)."""

    def __init__(self, iter_max, pos_w, pos_xy_std, bi_w, bi_xy_std, bi_rgb_std,
                 method: str = "grid"):
        self.iter_max = iter_max
        self.pos_w = pos_w
        self.pos_xy_std = pos_xy_std
        self.bi_w = bi_w
        self.bi_xy_std = bi_xy_std
        self.bi_rgb_std = bi_rgb_std
        self.method = method

    def __call__(self, image: torch.Tensor, probmap: torch.Tensor) -> torch.Tensor:
        """image (3, H, W) in [0, 255], probabilities (C, H, W) -> Q (C, H, W)."""
        return mean_field_inference(
            image, unary_from_softmax(probmap.float()), t=self.iter_max,
            sxy_g=self.pos_xy_std, compat_g=self.pos_w, sxy_b=self.bi_xy_std,
            srgb_b=self.bi_rgb_std, compat_b=self.bi_w, method=self.method)
