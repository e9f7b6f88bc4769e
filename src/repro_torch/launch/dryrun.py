"""The multi-pod dry run, from the command line.

Traces every (architecture x input-shape) cell against the production
meshes, 16x16 (one pod, 256 devices) and 2x16x16 (two pods, 512), as fake
devices on torch's ``fake`` process group: the step runs once on fake
tensors (no allocation), and one device's FLOPs, traffic, collectives and
peak memory (``launch.op_analysis``) go into one JSON artifact per cell
under ``artifacts/dryrun_torch/`` for the roofline
(``python -m repro_torch.launch.roofline``).

A port of ``repro.launch.dryrun`` with the same options; it needs no
``XLA_FLAGS`` and no card.  Every cell of the reference's list is
ported; a cell whose build raises ``NotImplementedError`` (an
architecture the port lacks) prints ``[not-ported]``, and any other
failure ``[FAIL]`` (exit code 1).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import logging
import json
import os
import sys
import time
import traceback

HBM_PER_CARD = 80e9      # an H100's device memory, bytes


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--mesh", choices=("pod", "multipod", "both"),
                   default="pod")
    p.add_argument("--out", default="artifacts/dryrun_torch")
    p.add_argument("--fsdp", default=None,
                   help="override FSDP: on|off (default: auto per plan)")
    p.add_argument("--skip-existing", action="store_true")
    args = p.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh

    if args.all:
        cells = registry.all_cells()
    elif args.arch and not args.shape:
        cells = [(a, s) for a, s in registry.all_cells() if a == args.arch]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        p.error("--arch (and --shape) or --all")

    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    fsdp = {None: None, "on": True, "off": False}[args.fsdp]
    # DTensor logs a warning for each mesh axis it reduces on its own
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    os.makedirs(args.out, exist_ok=True)
    failures, not_ported, ok = [], [], 0
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        tag = "2x16x16" if multi_pod else "16x16"
        for arch, shape in cells:
            name = f"{arch}__{shape}__{tag}"
            path = os.path.join(args.out, name + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {name}")
                continue
            t0 = time.perf_counter()
            try:
                res = steps.dryrun_cell(arch, shape, mesh,
                                        multi_pod=multi_pod, fsdp=fsdp)
            except NotImplementedError as e:
                not_ported.append(name)
                print(f"[not-ported] {name}: {e}")
                continue
            except Exception as e:  # noqa: BLE001 - record and continue
                failures.append((name, repr(e)))
                print(f"[FAIL] {name}: {e!r} "
                      f"({time.perf_counter() - t0:.0f}s)")
                traceback.print_exc()
                continue
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            ok += 1
            peak = res["memory"]["peak_bytes_est"]
            over = (f" OVER {HBM_PER_CARD / 1e9:.0f} GB"
                    if peak > HBM_PER_CARD else "")
            print(f"[ok]   {name}: trace={res['trace_s']:.1f}s "
                  f"flops/dev={res['flops_per_device']:.3e} "
                  f"coll/dev={res['collective_total_bytes_per_device']:.3e}B "
                  f"peak/dev={peak / 2**30:.2f}GiB{over}", flush=True)
    print(f"\n{ok} ok, {len(not_ported)} not-ported, {len(failures)} failed")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for n, e in failures:
            print(" ", n, e)
        return 1
    print("all ported cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
