"""Architecture configs: the published dimensions of every model the
reference supports, one module each (copies of ``repro.configs``)."""
