"""The readings that a cell's limits are set from, on the card.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        [--dtype bfloat16]

For each seed: the cell's inputs, as a run makes them; the program's
reports of every device batch (one call each through the timed entry,
at the timed sizes) and the control's, the plain reference computed in
``--dtype`` (the precision below the configuration's float32) and put
in the program's place; both compared with the float64 reference as a
run compares.  One JSON line a seed, then the largest program reading
and the smallest control reading of each number.  The benchmark's own
runs do not run this.
"""
import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(workload: str, seed: int, dtype, device: str = "cuda",
             root=ROOT, overrides=None) -> dict:
    """The program's and the control's compared numbers for one seed."""
    import torch

    from harness import check, core
    from harness import traffic as tf
    root = pathlib.Path(root)
    manifest = core.load_json(root / "BENCHMARK.json")
    files = core.cell_files(root, manifest, workload)
    cfg = core.load_json(files["config"])
    mix = core.load_json(files["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        mix.update(overrides.get("traffic", {}))
    reference = core.load_reference(root, cfg)
    leaves = (reference.EXACT, reference.FLOAT)
    inputs = tf.make_inputs(cfg, mix, seed)
    prog = core.load_entry(root, cfg, mix)(root, cfg, mix, inputs, device)
    outs = {}
    for b in range(len(prog.batches)):
        out, _ = prog.call(b)
        outs[b] = prog.leaves(out)
    prog.free()
    ref = reference.reports(root, cfg, mix, inputs, device)
    low = reference.reports(root, cfg, mix, inputs, device, dtype=dtype)
    control = {}
    for b in outs:
        order = torch.as_tensor(inputs.orders[b], device=device)
        control[b] = {k: x.index_select(0, order) for k, x in low.items()}
    return {"seed": seed,
            "program": check.compare(outs, inputs.orders, ref, *leaves),
            "control": check.compare(control, inputs.orders, ref, *leaves)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from harness import core
    core.set_cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = readings(args.workload, seed, dtype)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {side: {k: (max if side == "program" else min)(
        r[side][k] for r in rows) for k in rows[0][side]}
        for side in ("program", "control")}
    print(json.dumps({"workload": args.workload, "dtype": args.dtype,
                      "seeds": len(rows), "program_max":
                      summary["program"], "control_min":
                      summary["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
