"""Device times of calls on the card, from CUDA events queued behind a
sleep, so that the host's launch time does not enter the readings.  Used by
``chip_smoke.py`` and ``tools/torch_kernel_times.py``; it imports nothing of
the package, so the latter can time any version of it.
"""

from __future__ import annotations

import time

import torch


class QueueError(RuntimeError):
    """The calls could not be queued while the card slept."""


def enqueue(calls):
    """Call each of ``calls`` between two CUDA events; returns the pairs."""
    pairs = []
    for fn in calls:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    return pairs


def gpu_times(calls, per_sleep):
    """Device time (ms) of each call in ``calls``: CUDA events around each,
    queued behind a sleep so host launch time does not leak into the
    readings.  Each sleep holds ``per_sleep`` calls: the card's launch
    queue is finite, and a full one makes the host wait for the card to
    wake.  Each sleep is checked: if the card woke before the last call was
    queued, the readings could hold host time, so the sleep is doubled and
    those calls are queued again."""
    enqueue(calls[:3])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue(calls)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(calls)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(1_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / max(s.elapsed_time(e), 1e-3)
    times = []
    for i in range(0, len(calls), per_sleep):
        chunk = calls[i:i + per_sleep]
        sleep_ms = 2 * host_ms * len(chunk) + 1
        while True:
            torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
            awake = torch.cuda.Event()
            awake.record()
            pairs = enqueue(chunk)
            queued_asleep = not awake.query()
            torch.cuda.synchronize()
            if queued_asleep:
                break
            if sleep_ms >= 2_000:
                raise QueueError("could not queue the timed calls behind a sleep")
            sleep_ms *= 2
        times += [s.elapsed_time(e) for s, e in pairs]
    return times
