"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``;
the run measures ``repro_torch`` (``src/``) on the card for ``--seconds``
after its set-up, checks the outputs against the plain reference, and
prints, as the last line of standard output, one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled window.  The compared numbers and
their limits are the last lines of standard error and the last key of
the JSON line.  Without a CUDA card, or with fewer than the cell asks
for, it exits 2 and prints no result; if the process holds JAX or the
JAX package once everything before the result line has run (the window,
the check, the metric readers), it exits 3 and prints no result.
"""
import time

T_START_NS = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])

    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from harness import core
    core.set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)

    out = core.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start_ns=T_START_NS)
    return report(out)


def report(out: dict) -> int:
    """Print a run's result (``core.run_cell``'s output): the failed calls'
    messages and the compared numbers on standard error, then the result
    line, unless the process holds a module no run may load."""
    from harness import core
    for line in out["errors"]:
        print(line, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    found = core.banned_modules()
    if found:
        print(f"the process holds {found}: nothing the benchmark runs may "
              f"load them; no result", file=sys.stderr, flush=True)
        return 3
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
