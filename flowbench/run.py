"""One run of one cell of the benchmark.

    python -m flowbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root. The cell's configuration, traffic and limits are
found by name (flowbench/registry.py). The run needs as many CUDA devices as
the cell asks for and exits 2 without them; set-up (imports, the kernel
library, seeded weights and inputs, warm-up) counts as ``setup_s``; the
window lasts ``--seconds``. With ``--trace 1`` the window is followed by a
profiled pass of a few units (pairs or steps), and the per-layer metrics
are read from it, shares of time at the window's own pace. Then the
program's device memory peak is read, the program freed, and what the
window produced compared with the plain reference (``correct``). The last
line of standard output is the result, one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error too.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "flow_supervisor_tpu")


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_for(cell) -> "torch.device":
    import torch

    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(f"{cell.name} needs {chips} CUDA device(s); "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    return torch.device("cuda", 0)


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """The result of one run (the last line's object)."""
    import torch

    from flowbench import registry

    cuda = torch.device(device).type == "cuda"
    run = registry.runner(cell.traffic["runner"]).Run(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    phases = getattr(run, "setup_phases", None)
    if phases:
        print("setup " + " ".join(f"{k} {v:.3f}s" for k, v in phases.items()), file=sys.stderr)
    window = run.window(seconds)
    result = {"correct": False, "attempted": window["attempted"], "failed": window["failed"]}
    if traced:
        record = run.profile()
        record.update(window_s=window["seconds"], window_work=window["attempted"])
        metrics = {}
        for m in cell.per_layer:
            value = registry.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        window["metrics"]["setup_s"] = setup_s
        metrics = {m["name"]: {"value": window["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
    }
    if traced:
        # The window's device-busy seconds: the profiled pass's a unit times
        # the window's units; the profiler's host cost stretches its own pass.
        busy_s = record["busy_s"] / record["work"] * record["window_work"]
        result["device"].update(busy_s=busy_s, window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]
    run.release()
    numbers = run.check()
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in cell.limits}
    result["correct"] = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from flowbench import registry

    torch.set_num_threads(2)
    cell = registry.cell(args.workload)
    try:
        device = device_for(cell)
    except NoDevice as e:
        print(f"flowbench: {e}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"flowbench: the run loaded {found}, which nothing on the card may import",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
