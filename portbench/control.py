"""The check's control on a cell's inputs: readings of the numbers compared.

    python3 portbench/control.py --workload amazon-polarity-nomic128.fit --seeds 1 2 3

For each seed it makes the cell's inputs, has the cell's driver work out
the plain reference and the control (the same reference in the nearest
precision below the configuration's, ``drivers/<name>.py``), puts the
control's answer in the program's place, and prints one JSON line: the
control's reading of each number beside the configuration's limit, and
whether ``check.judge`` passes it (it must not).  The program is not run.
"""

import argparse
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, device: str, vertices: int | None = None) -> dict:
    from portbench import check, harness

    _, cfg, mix, _, _ = harness.cell_spec(harness.load_json(ROOT / "BENCHMARK.json"), workload)
    if vertices:
        cfg = dict(cfg, vertices=vertices)
    drv = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    inputs = drv.make(cfg, mix, seed, device).inputs
    t = time.perf_counter()
    ref = drv.reference(inputs, cfg, device)
    t_ref = time.perf_counter() - t
    ctl = drv.reference(inputs, cfg, device, control=True)
    passed, numbers = check.judge(
        [drv.readings(ref, o) for o in drv.control_outputs(ctl, inputs)], cfg["check"])
    return {"workload": workload, "seed": seed, "vertices": cfg["vertices"],
            "control": {k: v["value"] for k, v in numbers.items()}, "limits": cfg["check"],
            "control_passes": passed, "reference_s": t_ref, "reference": ref.info,
            "control_info": ctl.info}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
