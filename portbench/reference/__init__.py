"""Plain references (NumPy and plain PyTorch) that decide ``correct``.

They import nothing of the program, of ``repro`` or of ``jax``, and take
nothing the program made: each works its answer out again from the corpus.
"""
