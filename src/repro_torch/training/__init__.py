"""Fault tolerance (counterpart of ``repro.training``; the trainer is not ported yet)."""
