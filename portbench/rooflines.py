"""The card's peaks and each kernel's least time: the yardstick of the
``*_roofline`` metrics.

Peaks are NVIDIA's data sheet for the H100 SXM (dense rates, 700 W).  A
kernel's least time is the larger of its operations over the float32 peak
and its bytes over the memory bandwidth, counted from the shapes of the
call (each input byte read once, each output byte written once; data-
dependent work counted as these inputs need it).
"""

from __future__ import annotations

PEAKS = {
    # torch.cuda.get_device_name() -> float32 outside the tensor cores, HBM
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(device_name)


def argkmin_bound_s(m: int, c_valid: int, c: int, d: int, topk: int, pk: dict
                    ) -> tuple[float, str]:
    """One argkmin call: ``m`` real batch rows against ``c_valid`` valid
    store rows of ``c``, width ``d``, lists of ``topk``.  Operations: a
    multiply and an add per term of every (batch row, valid store row) dot
    product, 2·m·c_valid·d; the padded batch rows and dead store rows change
    no output.  Bytes: the valid rows' embeddings and k-th weights, the
    batch, ``valid`` and ``disp`` once each, and the lists (8 bytes a slot)."""
    flops = 2 * m * c_valid * d
    nbytes = c_valid * (4 * d + 4) + 4 * m * d + 2 * c + 8 * m * topk
    ops_s, bytes_s = flops / pk["f32_flops"], nbytes / pk["hbm_bytes_per_s"]
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def sweep_bound_s(n: int, k: int, nf: int, rows: int, pk: dict) -> tuple[float, str]:
    """One frontier sweep over an (n, k) ELL problem whose label vector has
    ``nf`` entries and whose frontier has ``rows`` rows.  Bytes: F read once
    (4·nf), the frontier read and F', changed written for every row (6·n),
    and a frontier row's nbr, wgt, wl0, wl1 (8k + 8); F's gathers hit L2.
    Operations: a sub, mul and two adds a lane and 12 a row, frontier rows
    only."""
    nbytes = 4 * nf + 6 * n + rows * (8 * k + 8)
    flops = rows * (4 * k + 12)
    bytes_s, ops_s = nbytes / pk["hbm_bytes_per_s"], flops / pk["f32_flops"]
    return (bytes_s, "bytes") if bytes_s >= ops_s else (ops_s, "operations")
