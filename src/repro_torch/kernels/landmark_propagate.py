"""Landmark / low-rank cold-tail state for the ``landmark`` backend.

Counterpart of ``repro.kernels.landmark_propagate``.  Every exact backend
(``ref``, ``ell_cuda``, ``bsr``) stages the full unlabeled row set on the
device each Δ_t.  The ``landmark`` backend (registered in ``kernels.ops``)
splits the graph instead:

  * **hot working set**: frontier and recently touched rows (tracked per
    batch by ``core.stream.StreamEngine``) solve exactly.  The
    hot-restricted snapshot (``core.snapshot.build_host_problem(hot=…)``)
    folds each cold unlabeled neighbor's committed label into the
    supernode weights, so the restricted solve is a true Jacobi fixpoint
    on the hot subgraph with the cold tail as fixed boundary;
  * **cold tail**: served through the low-rank factorization held here.
    ``L`` landmark vertices (sampled evenly over the alive set), their
    committed labels ``fL`` re-read at every commit in O(L), and a
    device-resident per-node assignment ``(N_pad, R)`` of nearest landmarks
    with cosine weights.  The assignment runs the argkmin kernel
    (``kernels.argkmin.argkmin_candidates``) against the landmark block, in
    chunks of ``ASSIGN_CHUNK`` rows, and is refreshed incrementally: only
    rows appended since the last commit are assigned; a landmark resample
    rebuilds the whole table.

Cold estimates are ``f_v = Σ_r W[v,r] · fL[idx[v,r]]``, one gather and a
column-order sum (``_cold_pass``), written back at commit so cold labels
keep moving with the landmark labels at O(N·R).

Unlike the exact backends, ``landmark`` answers for an agreement floor on
the hot set, not for equal bits.  On CUDA tensors the assignment launches
the argkmin kernel (never its plain version); on CPU tensors the wrapper
takes the plain version.  ``assign_chunks`` counts the argkmin calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.propagate import _row_sum
from repro_torch.device import resolve_device
from repro_torch.kernels.argkmin import argkmin_candidates

# assignment rows go through the argkmin kernel in fixed-size chunks (the
# reference's shape: one compiled scatter shape there, one launch shape here)
ASSIGN_CHUNK = 1024

# assignment-table row ladder (doubling, like the embedding store's)
ASSIGN_FLOOR = 1024


def _dim_pad(d: int) -> int:
    # ingest.embedding_store.dim_pad; kept here so this module does not
    # import the ingest package
    return max(8, -8 * (-d // 8))


def _assign_bucket(n: int, floor: int = ASSIGN_FLOOR) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _scatter_assign(assign_idx, assign_w, lo, val, idx, r):
    """Fold one argkmin chunk into the assignment table, in place.

    ``val``/``idx`` are the argkmin top-k against the landmark block for
    rows ``lo, lo+1, ...`` (``-inf`` marks empty slots): keep the best
    ``r`` per row and normalize the cosine weights to sum 1 (all-zero rows
    mean "no assignment")."""
    val = val[:, :r]
    idx = idx[:, :r]
    if val.shape[1] < r:  # fewer landmarks than r: pad with empty slots
        pad = r - val.shape[1]
        val = torch.nn.functional.pad(val, (0, pad), value=-np.inf)
        idx = torch.nn.functional.pad(idx, (0, pad))
    zero = torch.zeros((), dtype=torch.float32, device=val.device)
    w = torch.where(torch.isfinite(val), val.clamp_min(0.0), zero)
    wsum = _row_sum(w)[:, None]
    w = torch.where(wsum > 0, w / wsum.clamp_min(1e-30), zero)
    assign_idx[lo:lo + len(idx)] = idx.to(torch.int32)
    assign_w[lo:lo + len(w)] = w


def _grow_assign(assign_idx, assign_w, new_cap):
    """Pad the assignment table up the row ladder (a new allocation)."""
    pad = new_cap - assign_idx.shape[0]
    r = assign_idx.shape[1]
    dev = assign_idx.device
    return (torch.cat([assign_idx, torch.zeros((pad, r), dtype=torch.int32, device=dev)]),
            torch.cat([assign_w, torch.zeros((pad, r), dtype=torch.float32, device=dev)]))


def _cold_pass(assign_idx, assign_w, lm_f):
    """The low-rank cold-tail pass: per-node landmark-weighted label
    estimate and the per-node assignment weight sum (0 = no estimate),
    each summed over the R slots in order."""
    return _row_sum(assign_w * lm_f[assign_idx]), _row_sum(assign_w)


@dataclasses.dataclass(frozen=True)
class LandmarkConfig:
    """Knobs of the landmark cold-tail factorization.

    ``hot_ttl`` is the working-set window in batches: a vertex stays hot
    (solved exactly) for this many batches after a Δ_t last touched it,
    then falls to the cold tail.  ``resample_factor`` and ``dead_frac_max``
    bound landmark staleness: the landmarks are resampled (and the table
    rebuilt) when the alive set outgrows the sampled one by the factor, or
    when too many landmarks have been deleted.
    """

    num_landmarks: int = 64
    assign_k: int = 4  # landmarks per node (R)
    hot_ttl: int = 4
    resample_factor: float = 2.0
    dead_frac_max: float = 0.1

    def __post_init__(self):
        if self.num_landmarks < 1 or self.assign_k < 1 or self.hot_ttl < 0:
            raise ValueError(
                f"invalid LandmarkConfig: num_landmarks={self.num_landmarks} "
                f"assign_k={self.assign_k} hot_ttl={self.hot_ttl}")


class LandmarkState:
    """Device-resident landmark factorization, refreshed at commit
    boundaries by ``core.stream.StreamEngine``.

    Activation is lazy: until the alive set reaches twice ``num_landmarks``
    the state reports ``ready == False`` and the engine streams exactly.
    After activation ``refresh`` is incremental (only rows appended since
    the last call are assigned); a resample rebuilds the whole table.
    """

    def __init__(self, cfg: LandmarkConfig, emb_dim: int,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.emb_dim = emb_dim
        self.dp = _dim_pad(emb_dim)
        self.lm_ids: np.ndarray | None = None  # (L,) global landmark ids
        self.lm_emb: torch.Tensor | None = None  # (L, dp) normalized rows
        self.lm_valid: torch.Tensor | None = None  # (L,) bool
        self.assign_idx: torch.Tensor | None = None  # (N_pad, R) int32
        self.assign_w: torch.Tensor | None = None  # (N_pad, R) f32, rows sum 1
        self.assigned_upto = 0  # rows [0, assigned_upto) hold assignments
        self.sampled_alive = 0  # alive count at the last (re)sample
        self.resamples = 0
        self.assign_chunks = 0  # argkmin calls of the assignment

    @property
    def ready(self) -> bool:
        """True once landmarks are sampled and assignments exist."""
        return self.lm_ids is not None

    @property
    def num_landmarks(self) -> int:
        """Landmarks in the current sample (0 before activation)."""
        return 0 if self.lm_ids is None else len(self.lm_ids)

    # ------------------------------------------------------------------ #
    def _host_block(self, embn: np.ndarray) -> torch.Tensor:
        block = np.zeros((len(embn), self.dp), np.float32)
        block[:, : embn.shape[1]] = embn
        return torch.from_numpy(block).to(self.device)

    def _emb_rows(self, g, store, lo: int, hi: int) -> torch.Tensor:
        """Normalized embedding rows [lo, hi) as a (hi-lo, dp) device
        block: from the ingest store when one is attached (already on the
        device and dim-padded), else staged from the host graph's
        ``embn``."""
        if store is not None and store.count >= hi:
            return store.landmark_rows(lo, hi)
        return self._host_block(g.embn[lo:hi])

    def _gather_landmarks(self, g, store, ids: np.ndarray) -> torch.Tensor:
        if store is not None and store.count >= g.num_nodes:
            return store.landmark_gather(ids)
        return self._host_block(g.embn[ids])

    # ------------------------------------------------------------------ #
    def _needs_resample(self, g) -> bool:
        if self.lm_ids is None:
            return True
        n_alive = int(g.alive.sum())
        if n_alive > self.cfg.resample_factor * max(1, self.sampled_alive):
            return True
        dead = int((~g.alive[self.lm_ids]).sum())
        return dead > self.cfg.dead_frac_max * len(self.lm_ids)

    def refresh(self, g, store=None) -> None:
        """Bring the factorization up to date with the graph (called at
        commit boundaries).  No-op before activation and when nothing
        changed; O(rows appended since the last call) otherwise; O(N·L)
        on a landmark resample."""
        n = g.num_nodes
        n_alive = int(g.alive.sum())
        if self.lm_ids is None and n_alive < 2 * self.cfg.num_landmarks:
            return  # not enough rows for a stable landmark block yet
        dev = self.device
        if self._needs_resample(g):
            alive_ids = np.flatnonzero(g.alive)
            pick = np.unique(np.linspace(
                0, len(alive_ids) - 1, self.cfg.num_landmarks).round()
                .astype(np.int64))
            self.lm_ids = alive_ids[pick]
            # the landmark block keeps one shape across resamples: pad by
            # repeating row 0 with valid=False (inert in argkmin)
            ids_pad = np.zeros(self.cfg.num_landmarks, np.int64)
            ids_pad[: len(self.lm_ids)] = self.lm_ids
            self.lm_emb = self._gather_landmarks(g, store, ids_pad).contiguous()
            lv = np.zeros(self.cfg.num_landmarks, bool)
            lv[: len(self.lm_ids)] = True
            self.lm_valid = torch.from_numpy(lv).to(dev)
            self.sampled_alive = n_alive
            self.assigned_upto = 0  # full rebuild below
            self.resamples += 1
        if self.assigned_upto >= n:
            return
        cap = _assign_bucket(n)
        r = self.cfg.assign_k
        if self.assign_idx is None:
            self.assign_idx = torch.zeros((cap, r), dtype=torch.int32, device=dev)
            self.assign_w = torch.zeros((cap, r), dtype=torch.float32, device=dev)
        elif cap > self.assign_idx.shape[0]:
            self.assign_idx, self.assign_w = _grow_assign(self.assign_idx, self.assign_w,
                                                          cap)
        l_pad = int(self.lm_emb.shape[0])
        kth = torch.full((l_pad,), -np.inf, dtype=torch.float32, device=dev)
        chunk_rows = torch.arange(ASSIGN_CHUNK, device=dev)
        for lo in range(self.assigned_upto, n, ASSIGN_CHUNK):
            hi = min(lo + ASSIGN_CHUNK, n)
            block = self._emb_rows(g, store, lo, hi)
            m = hi - lo
            if m < ASSIGN_CHUNK:  # pad the tail chunk to the fixed shape
                block = torch.nn.functional.pad(block, (0, 0, 0, ASSIGN_CHUNK - m))
            # base_id at the landmark rows' end disables the kernel's
            # self-match: nodes may be landmarks themselves
            val, idx, _ = argkmin_candidates(
                self.lm_emb, self.lm_valid, kth, block.contiguous(), chunk_rows < m,
                base_id=l_pad, slack=0.0, k=r)
            self.assign_chunks += 1
            _scatter_assign(self.assign_idx, self.assign_w, lo, val[:m], idx[:m], r)
        self.assigned_upto = n

    # ------------------------------------------------------------------ #
    def landmark_values(self, g) -> np.ndarray:
        """The (L,) committed landmark labels ``fL``: the ground-truth
        label of a seeded landmark, its committed fractional label
        otherwise.  O(L) per commit."""
        ids_pad = np.zeros(self.cfg.num_landmarks, np.int64)
        ids_pad[: len(self.lm_ids)] = self.lm_ids
        f = g.f[ids_pad].astype(np.float32)
        lab = g.labels[ids_pad]
        return np.where(lab >= 0, lab.astype(np.float32), f)

    def cold_values(self, lm_f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Low-rank label estimates for every assigned row.

        Returns host ``(est, wsum)`` over the padded node axis; rows with
        ``wsum == 0`` (never assigned, or no valid landmark) have no
        estimate and keep their previous label.
        """
        est, wsum = _cold_pass(self.assign_idx, self.assign_w,
                               torch.from_numpy(np.asarray(lm_f, np.float32)).to(self.device))
        return est.cpu().numpy(), wsum.cpu().numpy()

    # ------------------------------------------------------------------ #
    def state_arrays(self) -> dict:
        """Host copies, taken now, of the state persistence saves
        (``core.persistence``)."""
        return {"ids": np.asarray(self.lm_ids, np.int64),
                "emb": self.lm_emb.cpu().numpy().copy(),
                "lm_valid": self.lm_valid.cpu().numpy().copy(),
                "assign_idx": self.assign_idx.cpu().numpy().copy(),
                "assign_w": self.assign_w.cpu().numpy().copy()}

    def state_meta(self) -> dict:
        """JSON-friendly scalar state for the checkpoint ``meta`` leaf."""
        return {"num_landmarks": self.cfg.num_landmarks,
                "assign_k": self.cfg.assign_k,
                "hot_ttl": self.cfg.hot_ttl,
                "resample_factor": self.cfg.resample_factor,
                "dead_frac_max": self.cfg.dead_frac_max,
                "assigned_upto": int(self.assigned_upto),
                "sampled_alive": int(self.sampled_alive),
                "resamples": int(self.resamples)}

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Adopt a persisted snapshot (restore path; the port's or the
        reference's)."""
        def put(a, dtype):
            return torch.from_numpy(np.array(a, dtype)).to(self.device)

        self.lm_ids = np.asarray(arrays["ids"], np.int64)
        self.lm_emb = put(arrays["emb"], np.float32)
        self.lm_valid = put(arrays["lm_valid"], bool)
        self.assign_idx = put(arrays["assign_idx"], np.int32)
        self.assign_w = put(arrays["assign_w"], np.float32)
        self.assigned_upto = int(meta["assigned_upto"])
        self.sampled_alive = int(meta["sampled_alive"])
        self.resamples = int(meta["resamples"])
