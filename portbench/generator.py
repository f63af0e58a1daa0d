"""The traffic generator: a corpus from a mix's parameters and a seed.

A mix (``traffic/<name>.json``) gives the data distribution and the share
of ground truth; the configuration gives the scale (``vertices``,
``emb_dim``).  The same seed gives the same corpus, and every seed the same
sizes: ``vertices`` rows, ``round(labeled_share · vertices)`` of them seeds,
both classes among them.

``gaussian_mixture``: two classes of ``vertices // 2`` and the rest, in an
order drawn from the seed, centred at ``∓class_sep/2`` on axis 0, isotropic
noise of ``noise`` (the ``data.synth._sample_points`` mixture of the
program, which ``chip_smoke.py`` path 3 runs at ``class_sep`` 6.0,
``noise`` 0.9).
"""

from __future__ import annotations

import dataclasses

import numpy as np

UNLABELED = -1


@dataclasses.dataclass
class Corpus:
    x: np.ndarray  # (N, D) float32 embeddings
    y: np.ndarray  # (N,) int8: 0/1 for seeds, UNLABELED elsewhere
    cls: np.ndarray  # (N,) int8 true class


def make_corpus(cfg: dict, mix: dict, seed: int) -> Corpus:
    data = mix["data"]
    if data["kind"] != "gaussian_mixture":
        raise ValueError(f"unknown data kind {data['kind']!r}")
    n, d = int(cfg["vertices"]), int(cfg["emb_dim"])
    rng = np.random.default_rng(int(seed) % (1 << 64))  # any whole number is a seed
    cls = rng.permutation(np.arange(n) >= n // 2).astype(np.int8)
    centers = np.zeros((2, d), np.float32)
    centers[0, 0] = -data["class_sep"] / 2
    centers[1, 0] = +data["class_sep"] / 2
    x = centers[cls] + rng.normal(0, data["noise"], size=(n, d)).astype(np.float32)
    n_lab = max(2, int(round(mix["labeled_share"] * n)))
    y = np.full(n, UNLABELED, np.int8)
    seeds = rng.choice(n, size=n_lab, replace=False)
    y[seeds] = cls[seeds]
    for c, drop in ((0, seeds[0]), (1, seeds[-1])):  # both classes seeded, count kept
        if not (y == c).any():
            y[drop] = UNLABELED
            y[np.flatnonzero((cls == c) & (y == UNLABELED))[0]] = c
    return Corpus(x=x, y=y, cls=cls)
