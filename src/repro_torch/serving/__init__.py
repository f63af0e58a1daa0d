"""Serving: the label service, its background driver and the estimator
(counterpart of ``repro.serving``; the LM decode loop is not ported yet)."""
