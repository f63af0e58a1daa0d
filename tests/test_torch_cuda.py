"""The port on the card: the CUDA sweep kernel against its plain version,
and the main path through it.  Every test here needs an NVIDIA GPU and
skips without one; this file imports neither jax nor the reference, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.dynlp import DynLP
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import DynamicGraph
from repro_torch.kernels.ell_propagate import ell_propagate_ref, ell_propagate_step

pytestmark = pytest.mark.cuda

DELTA = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k,nf,row_offset", [
    (90_000, 24, None, 0), (1000, 1, None, 0), (700, 8, 2000, 1300), (700, 8, 1500, 1000),
])
def test_kernel_gives_the_plain_versions_bits(card, n, k, nf, row_offset):
    rng = np.random.default_rng(n + k)
    nf = n if nf is None else nf
    nbr = rng.integers(-1, nf, size=(n, k)).astype(np.int32)
    wgt = (rng.uniform(0.1, 1.0, (n, k)) * (nbr >= 0)).astype(np.float32)
    wl0 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    wl1 = (rng.uniform(0, 1, n) * (rng.random(n) < 0.3)).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in
            (nbr, wgt, wl0, wl1, rng.random(n) < 0.6, rng.uniform(0, 1, nf).astype(np.float32))]
    before = ell_propagate_step.launches
    got_f, got_ch = ell_propagate_step(*args, delta=DELTA, row_offset=row_offset)
    want_f, want_ch = ell_propagate_ref(*args, delta=DELTA, row_offset=row_offset)
    torch.cuda.synchronize()
    assert ell_propagate_step.launches == before + 1
    assert torch.equal(got_f.view(torch.int32), want_f.view(torch.int32))
    assert torch.equal(got_ch, want_ch)


def test_main_path_goes_through_the_kernel(card):
    """A small stream on the card (default device and backend) launches the
    kernel once per sweep and gives the CPU run's labels within 20·δ."""
    spec = StreamSpec(total_vertices=900, batch_size=300, seed=3, class_sep=6.0, noise=0.8)
    gg, gc = DynamicGraph(16, 5), DynamicGraph(16, 5)
    dg, dc = DynLP(gg, delta=DELTA), DynLP(gc, delta=DELTA, device="cpu")
    before = ell_propagate_step.launches
    sweeps = 0
    for batch, _ in gaussian_mixture_stream(spec):
        sweeps += dg.step(batch).iterations
        dc.step(batch)
    assert ell_propagate_step.launches - before == sweeps > 0
    ids = np.flatnonzero(gg.alive & (gg.labels == -1))
    assert np.abs(gg.f[ids] - gc.f[ids]).max() <= 20 * DELTA
