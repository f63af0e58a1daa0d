"""Input specs, meshes, platform setup, the training driver and the dry run
(counterpart of ``repro.launch``)."""
