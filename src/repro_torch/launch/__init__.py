"""Input specs and the training driver (counterpart of ``repro.launch``)."""
