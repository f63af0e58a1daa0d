"""One run of one cell: set-up, the measured window, the check, the result line.

``run`` looks the cell up in ``BENCHMARK.json``, loads its configuration
and traffic mix, and drives them through the driver the mix names.  With
``trace`` off the result holds the cell's end-to-end metrics; with it on,
the window runs under the hooks of the cell's per-layer metrics and the
device profiler, and the result holds those metrics, ``busy_s``/``window_s``
and the breakdown.  Every metric is read by its own reader,
``metrics/<name>.py``.  Once the window has closed and the peak is read, the
program's state is freed, the driver works out its plain reference from
the run's inputs and reads every item of the window against it, and
``check.judge`` decides; the numbers compared go to stderr as the last lines
and to the result line under ``"check"``, its last key.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level module names


class NoDevice(RuntimeError):
    pass


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cfg: dict
    setup_s: float
    window: object  # the driver's Window
    spans: object  # spans.SpanLog
    trace: object | None  # trace.DeviceTrace
    lo: int = 0  # the window in the trace's clock (ns)
    hi: int = 0
    peaks: dict | None = None


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_spec(bench: dict, name: str) -> tuple[dict, dict, dict, list, list]:
    """The cell, its configuration, mix and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(PKG / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return cell, cfg, mix, mine(bench["end_to_end"]), mine(bench["per_layer"])


def metric_module(name: str):
    """``metrics/<name>.py``, loaded from its file (names hold dots)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(BANNED))


def require_device(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", overrides: dict | None = None) -> dict:
    """One run; returns the result line's object (``correct`` included).

    ``device="cpu"`` and ``overrides`` (configuration keys, such as a small
    ``vertices``) serve the tests: they skip the look for a card."""
    import torch

    from portbench import check, rooflines, spans

    log = sys.stderr

    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, mix, e2e, per_layer = cell_spec(bench, workload)
    cfg = dict(cfg, **(overrides or {}))
    if device == "cuda":
        require_device(cell["chips"])
        torch.cuda.init()
    t_init = time.perf_counter()
    drv = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    driver = drv.make(cfg, mix, seed, device)
    t_made = time.perf_counter()
    driver.warm()
    metrics = per_layer if trace else e2e
    readers = {m["name"]: metric_module(m["name"]) for m in metrics}
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    print(f"set-up {setup_s:.2f} s: to CUDA init {t_init - t_start:.2f} s, inputs "
          f"{t_made - t_init:.2f} s, warm-up {t_warm - t_made:.2f} s", file=log)

    log_ = spans.SpanLog()
    restore = spans.install([h for r in readers.values() for h in getattr(r, "HOOKS", ())],
                            log_) if trace else (lambda: None)
    dtrace = None
    if trace and cuda:
        from portbench.trace import DeviceTrace

        dtrace = DeviceTrace()
        dtrace.start()
    try:
        window = driver.window(seconds, log_)
    finally:
        if dtrace is not None:
            dtrace.stop()
        restore()
    print(f"window {window.seconds:.3f} s, {window.items} items: "
          f"{[round(t, 3) for t in window.item_s]}", file=log)
    banned = banned_modules()
    if banned:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {banned}")

    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": cell["chips"] if cuda else 0,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    r = Run(cfg=cfg, setup_s=setup_s, window=window, spans=log_,
            trace=dtrace, peaks=rooflines.peaks(name))
    result_metrics, breakdown = {}, None
    if dtrace is not None:
        from portbench import trace as tr

        r.lo, r.hi = dtrace.to_trace(window.t0), dtrace.to_trace(window.t1)
        busy = tr.busy_intervals(dtrace.events, r.lo, r.hi)
        device_info["busy_s"] = sum(b - a for a, b in busy) / 1e9
        device_info["window_s"] = (r.hi - r.lo) / 1e9
        breakdown = {"device_ops": tr.top_ops(dtrace.events, r.lo, r.hi),
                     "idle_gaps": tr.gaps_by_host(tr.idle_gaps(busy, r.lo, r.hi),
                                                  log_.spans, dtrace.to_trace)}
    for m in metrics:
        v = readers[m["name"]].read(r)
        if v is not None:
            result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check: the program's state freed first, the reference after the peak
    outputs = window.outputs
    inputs = driver.inputs
    del driver, r, dtrace
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = drv.reference(inputs, cfg, device)
    correct, numbers = check.judge([drv.readings(ref, o) for o in outputs], cfg["check"])
    print(f"reference: {ref.info}, {len(outputs)} items checked in "
          f"{time.perf_counter() - t:.1f} s", file=log)
    for k, v in numbers.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=log)
    out = {"correct": correct, "attempted": window.items, "failed": 0,
           "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = numbers
    return out
