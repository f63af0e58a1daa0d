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

A mix with ``"batch_size"`` is a stream (``make_stream``): the same mixture,
handed out in id order as batches Δ_t of ``batch_size`` insertions (the
last may be shorter), each with ``round(labeled_share · b)`` of its rows
seeded with their true class and ``round(deleted_share · b)`` deletions
drawn uniformly, with replacement, from the ids handed out before it (none
in Δ_0; an id drawn twice or already dead deletes nothing more).  That is
the DynLP paper's 90/1/9 protocol (``data.synth.gaussian_mixture_stream``
of the program).  Every seed gives the same sizes: the batches, their
seeds and their draws differ only in which rows and ids.
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


def _points(cfg: dict, data: dict, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """The mixture's (x, cls), the first draws of the seed's generator."""
    if data["kind"] != "gaussian_mixture":
        raise ValueError(f"unknown data kind {data['kind']!r}")
    n, d = int(cfg["vertices"]), int(cfg["emb_dim"])
    cls = rng.permutation(np.arange(n) >= n // 2).astype(np.int8)
    centers = np.zeros((2, d), np.float32)
    centers[0, 0] = -data["class_sep"] / 2
    centers[1, 0] = +data["class_sep"] / 2
    x = centers[cls] + rng.normal(0, data["noise"], size=(n, d)).astype(np.float32)
    return x, cls


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 64))  # any whole number is a seed


def make_corpus(cfg: dict, mix: dict, seed: int) -> Corpus:
    rng = _rng(seed)
    x, cls = _points(cfg, mix["data"], rng)
    n = len(x)
    n_lab = max(2, int(round(mix["labeled_share"] * n)))
    y = np.full(n, UNLABELED, np.int8)
    seeds = rng.choice(n, size=n_lab, replace=False)
    y[seeds] = cls[seeds]
    for c, drop in ((0, seeds[0]), (1, seeds[-1])):  # both classes seeded, count kept
        if not (y == c).any():
            y[drop] = UNLABELED
            y[np.flatnonzero((cls == c) & (y == UNLABELED))[0]] = c
    return Corpus(x=x, y=y, cls=cls)


@dataclasses.dataclass
class Stream:
    x: np.ndarray  # (N, D) float32, row i is the vertex of global id i
    cls: np.ndarray  # (N,) int8 true class
    bounds: list  # [(lo, hi)]: Δ_t inserts rows lo..hi-1, which take ids lo..hi-1
    labels: list  # [(hi - lo,) int8]: 0/1 for the batch's seeds, UNLABELED elsewhere
    dels: list  # [(R,) int64]: the ids Δ_t deletes, drawn from [0, lo)

    def __len__(self) -> int:
        return len(self.bounds)


def make_stream(cfg: dict, mix: dict, seed: int) -> Stream:
    rng = _rng(seed)
    x, cls = _points(cfg, mix["data"], rng)
    size = int(mix["batch_size"])
    bounds, labels, dels = [], [], []
    for lo in range(0, len(x), size):
        hi = min(lo + size, len(x))
        b = hi - lo
        y = np.full(b, UNLABELED, np.int8)
        seeds = rng.choice(b, size=int(round(mix["labeled_share"] * b)), replace=False)
        y[seeds] = cls[lo + seeds]
        n_del = int(round(mix["deleted_share"] * b)) if lo else 0
        bounds.append((lo, hi))
        labels.append(y)
        dels.append(rng.integers(0, max(lo, 1), size=n_del).astype(np.int64))
    return Stream(x=x, cls=cls, bounds=bounds, labels=labels, dels=dels)
