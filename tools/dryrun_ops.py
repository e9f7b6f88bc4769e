#!/usr/bin/env python3
"""List the collectives of one dry-run cell by the code that issued them:
where two torch versions count different collective bytes for a cell,
the two listings name the ops whose DTensor choices differ.

    PYTHONPATH=src python tools/dryrun_ops.py deepseek-v2-lite-16b train_4k
    PYTHONPATH=src python tools/dryrun_ops.py qwen3-moe-30b-a3b prefill_32k \\
        --mesh 2x2 --smoke

Traces the cell as ``repro_torch.launch.steps.dryrun_cell`` does (the
16 x 16 fake mesh by default; ``--mesh 2x16x16`` or a small ``DxM`` /
``PxDxM`` mesh, where ``--smoke`` takes the smoke config at batch 8) under
``torch.autograd.set_detect_anomaly``, so that a collective issued in the
backward is named by the forward code of its autograd node.  Prints the
cell's collective bytes by kind, then one line per (kind, bytes, site):
the count of such calls (each microbatch's calls once; the artifact
weights them by the microbatch count).  Needs no card; the counts hold
for the installed torch, which the first line names.
"""
from __future__ import annotations

import argparse
import collections
import logging
import traceback

import torch


def _repro_frames(lines: list[str]) -> list[str]:
    """``function:line`` of each ``repro_torch`` frame in a formatted
    stack, innermost first."""
    out = []
    for line in "".join(lines).splitlines():
        if "File" in line and "repro_torch" in line \
                and "op_analysis" not in line:
            name = line.split(" in ")[-1].strip()
            lineno = line.split("line ")[1].split(",")[0]
            out.append(f"{name}:{lineno}")
    return out[::-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from repro_torch.launch import op_analysis, steps
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    sizes = [int(n) for n in args.mesh.split("x")]
    multi_pod = len(sizes) == 3
    if args.mesh in ("16x16", "2x16x16"):
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        mesh = make_local_mesh(*sizes[-2:], pod=sizes[0] if multi_pod
                               else None, fake=True)
    sites = collections.Counter()
    count = op_analysis.OpAnalysis._count

    def counting(self, func, fargs, kwargs, out):
        if func.namespace == "_c10d_functional" \
                and not func.__name__.startswith("wait"):
            outs = out if isinstance(out, (list, tuple)) else [out]
            nbytes = sum(o.numel() * o.element_size() for o in outs
                         if isinstance(o, torch.Tensor))
            node = torch._C._current_autograd_node()
            if node is None:
                site = " < ".join(_repro_frames(
                    traceback.format_stack())[:5])
            else:
                site = (f"backward of {node.name()} [" + " < ".join(
                    _repro_frames(node.metadata.get("traceback_", []))[:5])
                    + "]")
            sites[(func.__name__, nbytes, site)] += 1
        return count(self, func, fargs, kwargs, out)

    op_analysis.OpAnalysis._count = counting
    kw = dict(smoke=True, batch_override=8) if args.smoke else {}
    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        res = steps.dryrun_cell(args.arch, args.shape, mesh,
                                multi_pod=multi_pod, **kw)
    print(f"torch {res['torch']} {args.arch} {args.shape} {res['mesh']}: "
          f"{res['collective_bytes_per_device']}")
    for (name, nbytes, site), n in sorted(
            sites.items(), key=lambda kv: -kv[0][1] * kv[1]):
        print(f"{n:5d} x {nbytes:12d} {name:30s} {site}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
