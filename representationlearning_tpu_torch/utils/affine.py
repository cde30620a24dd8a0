"""Affine augmentation tool, the port of ``representationlearning_tpu/utils/affine.py``
(`RML/network/affine_tool.py:4-140`): samples an affine transform (scaling about
the patch centre, translation within valid bounds, rotation from a candidate
set) between the unit square and a ``patch_ratio`` sub-square, and returns the
2x3 matrix (``cv2.getAffineTransform`` replaced by a closed-form solve).
``get_affine_transform`` and ``AffineAugmentation`` are numpy, the JAX
package's code copied; ``apply_affine`` warps NCHW images by bilinear sampling
on the images' own device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.image import grid_sample_bilinear


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Solve the 2x3 affine mapping src->dst from 3 point pairs (cv2.getAffineTransform)."""
    A = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        x, y = src[i]
        A[2 * i] = [x, y, 1, 0, 0, 0]
        A[2 * i + 1] = [0, 0, 0, x, y, 1]
        b[2 * i] = dst[i][0]
        b[2 * i + 1] = dst[i][1]
    m = np.linalg.solve(A, b)
    return m.reshape(2, 3)


class AffineAugmentation:
    def __init__(
        self,
        patch_ratio: float = 1.2,
        scaling_sample_num: int = 5,
        scaling_low: float = 1.0,
        scaling_up: float = 1.0,
        translation_overflow: float = 0.0,
        rotation_sample_num: int = 25,
        rotation_max_angle: float = np.pi / 6,
        do_scaling: bool = False,
        do_rotation: bool = True,
        do_translation: bool = False,
        allow_artifacts: bool = True,
        rotation=None,
    ):
        self.patch_ratio = patch_ratio
        self.scaling_sample_num = scaling_sample_num
        self.scaling_low = scaling_low
        self.scaling_up = scaling_up
        self.translation_overflow = translation_overflow
        self.rotation_sample_num = rotation_sample_num
        if rotation is None:
            self.rotation_min_angle = -rotation_max_angle
            self.rotation_max_angle = rotation_max_angle
        else:
            self.rotation_min_angle, self.rotation_max_angle = rotation
        self.do_scaling = do_scaling
        self.do_rotation = do_rotation and not (
            self.rotation_max_angle == self.rotation_min_angle == 0
        )
        self.do_translation = do_translation
        self.allow_artifacts = allow_artifacts

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        pts_1 = np.array(((0, 0), (0, 1), (1, 1)), dtype=np.float64)
        margin = (1 - self.patch_ratio) / 2
        pts_2 = margin + np.array(
            ((0, 0), (0, self.patch_ratio), (self.patch_ratio, self.patch_ratio)),
            dtype=np.float64,
        )

        if self.do_scaling:
            scales = np.concatenate(
                [rng.uniform(self.scaling_low, self.scaling_up, self.scaling_sample_num),
                 np.ones(1)]
            )
            center = pts_2.mean(axis=0, keepdims=True)
            scaled = (pts_2 - center)[None] * scales[:, None, None] + center
            valid = (np.arange(len(scales)) if self.allow_artifacts
                     else np.where(np.all((scaled >= 0) & (scaled < 1), axis=(1, 2)))[0])
            pts_2 = scaled[valid[rng.integers(len(valid))]]

        if self.do_translation:
            t_min = np.abs(pts_2).min(axis=0)
            t_max = np.abs(1 - pts_2).min(axis=0)
            if self.allow_artifacts:
                t_min = t_min + self.translation_overflow
                t_max = t_max + self.translation_overflow
            pts_2 = pts_2 + np.array(
                [rng.uniform(-t_min[0], t_max[0]), rng.uniform(-t_min[1], t_max[1])]
            )[None]

        if self.do_rotation:
            angles = np.concatenate(
                [rng.uniform(self.rotation_min_angle, self.rotation_max_angle,
                             self.rotation_sample_num), np.zeros(1)]
            )
            center = pts_2.mean(axis=0, keepdims=True)
            rot = np.stack(
                [np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)], axis=1
            ).reshape(-1, 2, 2)
            rotated = np.matmul(np.tile((pts_2 - center)[None], (len(angles), 1, 1)), rot) + center
            valid = (np.arange(self.rotation_sample_num) if self.allow_artifacts
                     else np.where(np.all((rotated >= 0) & (rotated < 1), axis=(1, 2)))[0])
            pts_2 = rotated[valid[rng.integers(len(valid))]]

        return get_affine_transform(pts_1.astype(np.float32), pts_2.astype(np.float32))

    def __call__(self, rng: np.random.Generator, h: int = None, w: int = None) -> np.ndarray:
        return self.sample(rng)


def apply_affine(images: torch.Tensor, M: np.ndarray) -> torch.Tensor:
    """Warp NCHW images by the 2x3 affine M (unit-square coordinates) with
    bilinear border sampling; the sampling grid is computed in numpy (f64) and
    used in f32, as the JAX function does."""
    B, C, H, W = images.shape
    ys, xs = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    pts = np.stack([xs, ys, np.ones_like(xs)], axis=-1)  # (H, W, 3), (x, y, 1)
    warped = pts @ M.T  # (H, W, 2) in unit coords
    grid = torch.as_tensor(warped * 2.0 - 1.0, dtype=torch.float32, device=images.device)
    return grid_sample_bilinear(images, grid.expand(B, H, W, 2))
