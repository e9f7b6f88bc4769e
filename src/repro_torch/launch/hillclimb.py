"""The three planning studies of the reference's hillclimb, on the port's
dry-run numbers (before/after per variant, on the 16x16 mesh).  Each
variant is a real plan override of ``steps.build_cell``; the flash-kernel
memory substitution uses the score-tile traffic the trace counted
(``OpReport.kernel_adjusted_traffic``: the port's attention is the flash
kernels' shape-only ops, so it equals the traffic).

    python -m repro_torch.launch.hillclimb [--cell yi_train|yi_prefill|granite_decode]
        [--smoke]
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.launch import roofline


def row(tag: str, res: dict, kernel_sub: bool = False) -> str:
    comp, mem, coll = roofline.terms(res, kernel_adjusted=kernel_sub)
    peak = res["memory"]["peak_bytes_est"] / 2 ** 30
    line = (f"  {tag:34s} compute={comp:10.4g}s memory={mem:10.4g}s "
            f"collective={coll:10.4g}s bound={max(comp, mem, coll):10.4g}s "
            f"peak={peak:6.2f}GiB")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cell", default="all",
                   choices=("all", "yi_train", "yi_prefill",
                            "granite_decode"))
    p.add_argument("--smoke", action="store_true",
                   help="the smoke configs on a (4, 4) mesh, batch 8")
    args = p.parse_args(argv)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    if args.smoke:
        mesh = make_local_mesh(4, 4, fake=True)
        kw = dict(multi_pod=False, smoke=True, batch_override=8)
    else:
        mesh = make_production_mesh(multi_pod=False)
        kw = dict(multi_pod=False)

    def cell(arch, shape, **over):
        return steps.dryrun_cell(arch, shape, mesh, **kw, **over)

    if args.cell in ("all", "yi_train"):
        print("H1: yi-34b train_4k (most collective-bound)")
        row("baseline (FSDP + boundary-SP)",
            cell("yi-34b", "train_4k", zero1=False, fsdp=True))
        it1 = cell("yi-34b", "train_4k", zero1=True, interior_pin=True)
        row("iter1: ZeRO-1 + interior pin", it1)
        row("iter2: + flash-kernel memory", it1, kernel_sub=True)
    if args.cell in ("all", "yi_prefill"):
        print("H2: yi-34b prefill_32k (worst roofline fraction)")
        cur = cell("yi-34b", "prefill_32k")
        row("pin + cache-shard + last-logit", cur)
        row("+ flash-kernel memory", cur, kernel_sub=True)
    if args.cell in ("all", "granite_decode"):
        print("H3: granite-8b decode_32k (paper-representative)")
        row("baseline (bf16 KV cache)", cell("granite-8b", "decode_32k"))
        row("int8 KV cache encoding",
            cell("granite-8b", "decode_32k", kv_cache_dtype="int8"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
