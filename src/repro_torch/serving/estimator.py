"""scikit-learn-compatible front door for streaming label propagation.

Counterpart of ``repro.serving.estimator``.  ``DynLabelPropagation`` wraps
graph construction, the streaming engine and the serving layer behind the
estimator API:

    clf = DynLabelPropagation(k=5)
    clf.fit(X, y)                  # y: 0/1, -1 (UNLABELED) for unlabeled
    clf.partial_fit(X2, y2)        # stream more points in
    pred = clf.predict(Xq)         # inductive: label unseen embeddings
    seen = clf.predict_ids(ids)    # transductive: read committed labels

Callers hand over raw embeddings; the estimator derives every graph delta
itself through ``LPService.add_points``, on the device with the argkmin
kernel when ``ingest="device"`` (the default).  Like every entry point of
the port it runs on the CUDA device unless ``engine_opts={"device": "cpu"}``
says otherwise.  sklearn is NOT imported:
the class follows the estimator protocol (``get_params`` / ``set_params`` /
trailing-underscore fitted attributes) structurally.

Labels are binary 0/1 with ``UNLABELED`` (-1) marking points the
propagation should label, as in sklearn's ``LabelPropagation``.
"""

from __future__ import annotations

import inspect

import numpy as np

from repro_torch.core.stream import StreamEngine
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph
from repro_torch.serving.lp_service import LPService


class DynLabelPropagation:
    """Streaming semi-supervised label propagation (DynLP), estimator-style.

    Parameters mirror the engine/service knobs: ``k`` (kNN graph degree),
    ``delta`` (propagation convergence threshold), ``tau`` (G' supernode
    edge threshold; None = mean edge weight), ``max_iters``, ``ingest``
    ("device" = the argkmin kernel over the device embedding store,
    "host" = blockwise BLAS staging; labels are bit-identical either
    way), ``cutoff`` (decision threshold on the propagated score) and
    ``engine_opts`` / ``service_opts`` dicts passed through verbatim (the
    engine runs on ``cuda`` unless ``engine_opts={"device": "cpu"}``).

    Fitted attributes: ``graph_`` / ``engine_`` / ``service_`` (the live
    stack), ``transduction_`` (committed labels of every point so far),
    ``classes_``, ``n_features_in_``.
    """

    def __init__(
        self,
        k: int = 5,
        delta: float = 1e-4,
        tau: float | None = None,
        max_iters: int = 200_000,
        ingest: str = "device",
        cutoff: float = 0.5,
        engine_opts: dict | None = None,
        service_opts: dict | None = None,
    ):
        # sklearn convention: __init__ only stores hyper-parameters
        self.k = k
        self.delta = delta
        self.tau = tau
        self.max_iters = max_iters
        self.ingest = ingest
        self.cutoff = cutoff
        self.engine_opts = engine_opts
        self.service_opts = service_opts

    # ------------------------------------------------------------------ #
    # estimator protocol (structural — no sklearn import)
    # ------------------------------------------------------------------ #
    @classmethod
    def _param_names(cls) -> list[str]:
        sig = inspect.signature(cls.__init__)
        return [p for p in sig.parameters if p != "self"]

    def get_params(self, deep: bool = True) -> dict:
        """Constructor parameters, sklearn-style (``deep`` is accepted
        for API compatibility; there are no nested estimators)."""
        return {name: getattr(self, name) for name in self._param_names()}

    def set_params(self, **params) -> "DynLabelPropagation":
        """Set constructor parameters in place, sklearn-style."""
        valid = set(self._param_names())
        for key, val in params.items():
            if key not in valid:
                raise ValueError(
                    f"invalid parameter {key!r} for DynLabelPropagation; "
                    f"valid parameters: {sorted(valid)}")
            setattr(self, key, val)
        return self

    # ------------------------------------------------------------------ #
    def _init_stack(self, n_features: int) -> None:
        self.graph_ = DynamicGraph(emb_dim=n_features, k=self.k)
        self.engine_ = StreamEngine(
            self.graph_, delta=self.delta, tau=self.tau,
            max_iters=self.max_iters, ingest=self.ingest,
            **(self.engine_opts or {}))
        self.service_ = LPService(
            self.engine_, cutoff=self.cutoff, **(self.service_opts or {}))
        self.classes_ = np.array([0, 1], np.int8)
        self.n_features_in_ = n_features

    def _check_x(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D (n_samples, n_features), "
                             f"got shape {X.shape}")
        return X

    def _refresh_transduction(self) -> None:
        n = self.graph_.num_nodes
        res = self.service_.query(np.arange(n, dtype=np.int64))
        self.transduction_ = res.pred

    def fit(self, X, y=None) -> "DynLabelPropagation":
        """Build a fresh graph from ``X`` and propagate.  ``y`` holds 0/1
        seeds with -1 (``UNLABELED``) everywhere the model should infer;
        ``y=None`` means all points unlabeled (no seeds yet — stream them
        in later via ``partial_fit``)."""
        X = self._check_x(X)
        self._init_stack(X.shape[1])
        self.service_.add_points(X, y)
        self.service_.sync()
        self._refresh_transduction()
        return self

    def partial_fit(self, X, y=None) -> "DynLabelPropagation":
        """Stream more points into the fitted model (first call behaves
        like ``fit``).  Only the affected subgraph re-propagates — this
        is DynLP's batch update, not a refit."""
        X = self._check_x(X)
        if not hasattr(self, "service_"):
            return self.fit(X, y)
        self.service_.add_points(X, y)
        self.service_.sync()
        self._refresh_transduction()
        return self

    def forget(self, ids) -> "DynLabelPropagation":
        """Delete points by global id (the streaming counterpart of
        refitting without them)."""
        self.service_.remove_points(ids)
        self.service_.sync()
        self._refresh_transduction()
        return self

    def relabel(self, ids, labels) -> "DynLabelPropagation":
        """Change ground-truth seeds on existing points (0/1, or -1 to
        demote a seed back to propagated)."""
        self.service_.relabel(ids, labels)
        self.service_.sync()
        self._refresh_transduction()
        return self

    # ------------------------------------------------------------------ #
    def predict(self, X) -> np.ndarray:
        """Inductive prediction for unseen embeddings: the points join
        the graph as unlabeled vertices, one batch update labels them,
        and they are removed again — the fitted points' labels are
        unchanged (their lists may re-rank, but their seeds and the
        committed predictions the model reports are refreshed)."""
        X = self._check_x(X)
        base = self.graph_.num_nodes
        self.service_.add_points(X)
        self.service_.sync()
        ids = np.arange(base, base + len(X), dtype=np.int64)
        res = self.service_.query(ids)
        self.service_.remove_points(ids)
        self.service_.sync()
        self._refresh_transduction()
        return res.pred

    def predict_ids(self, ids) -> np.ndarray:
        """Transductive read: committed labels of existing points."""
        return self.service_.query(np.asarray(ids, np.int64)).pred

    def score(self, X, y) -> float:
        """Mean accuracy of ``predict(X)`` against ``y``."""
        y = np.asarray(y).reshape(-1)
        pred = self.predict(X)
        return float((pred == y).mean()) if len(y) else 0.0


__all__ = ["DynLabelPropagation", "UNLABELED"]
