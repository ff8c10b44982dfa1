"""The benchmark of the PyTorch/CUDA port, ducosy_tpu_torch, on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; the mix's ``kind`` names the
driver. With ``--trace 0`` the last line of standard output is the result
with the cell's end-to-end metrics; with ``--trace 1`` with its per-layer
metrics, read from a profiled segment after the window, and its breakdown.
Each number that decides ``correct`` is printed beside its limit as the
last lines of standard error and as the result's last key. Without a CUDA
card, or with JAX or the JAX package loaded once the window has closed, it
exits non-zero and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import card  # noqa: E402
from portbench.harness.common import Ctx, log  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(spec: Spec, cell: str, reading) -> dict:
    out = {}
    for m in spec.per_layer(cell):
        value = spec.reader(m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    card.set_cache_dirs(ROOT)
    try:
        count = card.require_card(cell["chips"])
    except card.NoCard as e:
        log(f"portbench: {e}")
        return 2
    import torch

    torch.set_num_threads(4)
    traffic = spec.traffic(cell["traffic"])
    driver = importlib.import_module(f"portbench.harness.{traffic['kind']}")
    log(f"card: {card.gpu_line()}; {count} devices, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    ctx = Ctx(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              config=spec.config(cell["config"]), traffic=traffic, t0=T0)
    before = card.gpu_state()
    out = driver.run(ctx)
    log(f"clocks and power beside the window (SM clock, draw): before "
        f"{before}, after {card.gpu_state()}")
    bad = card.forbidden_modules()
    if bad:
        log(f"portbench: the process holds {bad} once the window has closed")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed}
    if args.trace:
        prof = out.reading.profile
        result["metrics"] = per_layer(spec, args.workload, out.reading)
        device.update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["breakdown"] = {"device_ops": prof.top_ops(),
                               "idle_gaps": prof.idle_gaps()}
    else:
        result["metrics"] = {m["name"]: {"value": out.end_to_end[m["name"]],
                                         "unit": m["unit"]}
                             for m in spec.end_to_end(args.workload)}
    result["device"] = device
    checks = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    checks["failed"] = {"value": out.failed, "limit": 0}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
