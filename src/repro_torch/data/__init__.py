"""Synthetic streams (numpy copies of the reference generators)."""
