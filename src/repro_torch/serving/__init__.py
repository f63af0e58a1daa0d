"""Serving: the label service, its background driver, the estimator and
the LM continuous batcher (counterpart of ``repro.serving``)."""
