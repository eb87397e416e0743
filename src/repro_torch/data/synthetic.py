# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Synthetic image data (no dataset downloads): MNIST/CIFAR-shaped classes.

Each class has a random low-frequency template; a sample is its class
template plus noise.  numpy only, so the same seed gives the same arrays as
the reference's generator.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def class_gaussian_images(num: int, image_size: int, channels: int,
                          num_classes: int, seed: int = 0,
                          noise: float = 0.7,
                          template_seed: int = 1234
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,H,W,C) float32, labels (N,) int32).

    ``template_seed`` fixes the class templates independently of the sample
    ``seed`` so train/test splits drawn with different seeds share the same
    class structure.
    """
    trng = np.random.default_rng(template_seed)
    rng = np.random.default_rng(seed)
    # low-frequency class templates (smooth random fields)
    low = max(2, image_size // 4)
    templates = trng.normal(size=(num_classes, low, low, channels))
    reps = int(np.ceil(image_size / low))
    templates = np.kron(templates, np.ones((1, reps, reps, 1)))[
        :, :image_size, :image_size, :]
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    images = templates[labels] + noise * rng.normal(
        size=(num, image_size, image_size, channels))
    return images.astype(np.float32), labels
