"""One reader a metric, ``<metric name>.py``, loaded by the harness by
name (see ``portbench.metric``)."""
