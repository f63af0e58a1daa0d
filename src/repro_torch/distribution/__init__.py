"""Partition specs: logical axes resolved against a mesh (counterpart of
``repro.distribution``)."""
