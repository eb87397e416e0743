# repro: noqa[R6] -- reached from chip_smoke.py, outside the orphan rule's roots
"""Synthetic data (no dataset downloads), numpy only, so the same seed gives
the same arrays as the reference's generators.

* :func:`class_gaussian_images` — MNIST/CIFAR-shaped classes: each class
  has a random low-frequency template; a sample is its template plus noise.
* :func:`markov_topic_tokens` — token streams from per-topic Markov chains,
  with the topic as the label of the non-IID split.
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


def markov_topic_tokens(num_seqs: int, seq_len: int, vocab: int,
                        n_topics: int = 8, seed: int = 0,
                        branching: int = 8, table_seed: int = 1234
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, S) int32 sequences + (N,) int32 latent topic per document.

    Each topic is its own sparse random Markov chain (an independent
    successor table), so documents of different topics have disjoint
    transition statistics.  ``table_seed`` fixes the tables apart from the
    sample ``seed``, so train and test streams share one language.
    """
    trng = np.random.default_rng(table_seed)
    rng = np.random.default_rng(seed)
    succ = trng.integers(0, vocab, size=(n_topics, vocab, branching))
    topics = rng.integers(0, n_topics, size=num_seqs).astype(np.int32)
    out = np.empty((num_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, size=num_seqs)
    for t in range(seq_len):
        out[:, t] = state
        choice = rng.integers(0, branching, size=num_seqs)
        state = succ[topics, state, choice]
    return out, topics
