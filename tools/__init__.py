"""Scripts that check and measure the repo; ``gpu_timing`` is also imported
by ``chip_smoke.py``."""
