"""DynLP on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors the reference (``repro/X/Y.py`` → ``repro_torch/X/Y.py``,
same public names).  The port imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""
