"""``python -m repro_torch.analysis`` — the port's static-analysis gate.

    python -m repro_torch.analysis [--skip-dispatch] [--device cuda|cpu]

A port of ``repro.analysis.__main__``: the same three passes over the same
corpus, printing the same lines; exits 1 on any ERROR finding.

1. **trace lint** — every generator family (IDD loops, probes, validation
   sweeps, the 23 SPEC application traces, the encoded traces, the
   power-down policy traces: 51 labelled traces) linted against the full
   JEDEC rule set by the batched torch engine on ``--device``;
2. **dispatch audit** — every registered (estimator kind x impl x mode)
   combination of a quick-fit model run under the recorder
   (``dispatch_audit``: float64 ops, host round trips, pad masking, build
   state), then the serving, fleet-chunked and online-recalibration
   probes;
3. **repo lint** — the AST invariants over ``src/repro_torch``.

``--skip-dispatch`` runs only the two static passes.  ``--device``
defaults to ``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import sys


def _corpus(device="cpu"):
    """(label, CommandTrace) pairs covering every generator family, on
    ``device``."""
    import numpy as np

    from repro_torch.core import (applications, dram, encodings, idd_loops,
                                  traces)

    out = []

    def add(label, obj):
        # several generators return (trace, skip) pairs
        tr = obj if isinstance(obj, dram.CommandTrace) else obj[0]
        out.append((label, tr.to(device)))

    for name, fn in idd_loops.IDD_LOOPS.items():
        add(f"idd_loops.{name}", fn())
    add("idd_loops.ones_sweep_point(8)", idd_loops.ones_sweep_point(8))
    add("idd_loops.interleave_sweep_point",
        idd_loops.interleave_sweep_point(
            np.zeros(dram.LINE_WORDS, np.uint32),
            np.full(dram.LINE_WORDS, 0xFFFFFFFF, np.uint32), "bankcol"))
    add("idd_loops.bank_idle_probe(3)", idd_loops.bank_idle_probe(3))
    add("idd_loops.bank_read_probe(5)", idd_loops.bank_read_probe(5))
    add("idd_loops.row_act_probe(7)", idd_loops.row_act_probe(7))
    add("idd_loops.column_read_probe(9)", idd_loops.column_read_probe(9))
    for n in (0, 1, 4, 16):
        add(f"idd_loops.validation_sweep({n})",
            idd_loops.validation_sweep(n))

    apps = {}
    for app in traces.SPEC_APPS:
        tr = traces.app_trace(app, n_requests=256)
        apps[app.name] = tr
        add(f"traces.app_trace({app.name})", tr)

    demo = apps[traces.SPEC_APPS[3].name]
    for enc in encodings.ENCODINGS:
        add(f"encodings.encode_trace({enc})",
            encodings.encode_trace(demo, enc, device=device))
    for timeout in (32, 256):
        add(f"applications.apply_powerdown_policy(t={timeout})",
            applications.apply_powerdown_policy(demo, timeout))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--skip-dispatch", action="store_true",
                    help="skip the dispatch audit (it fits a quick model "
                         "and runs every combination)")
    ap.add_argument("--device", default="cuda",
                    help="device of the lint engine and the audited "
                         "dispatches (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import dispatch_audit, repo_lint, trace_lint
    from repro_torch.core import model_api
    device = model_api.resolve_device(args.device)

    n_errors = 0

    corpus = _corpus(device)
    diags = trace_lint.lint_traces([tr for _, tr in corpus])
    labels = [label for label, _ in corpus]
    errs = trace_lint.errors_of(diags)
    n_errors += len(errs)
    for d in diags:
        stream = sys.stderr if d.severity == trace_lint.ERROR else sys.stdout
        print(f"trace_lint[{labels[d.trace_index]}]: {d}", file=stream)
    print(f"trace lint: {len(corpus)} traces, "
          f"{len(errs)} errors, {len(diags) - len(errs)} warnings")

    if not args.skip_dispatch:
        from repro_torch.core.vampire import reference_vampire
        model = reference_vampire(device)
        findings = dispatch_audit.audit_all(model, device=device)
        findings.extend(dispatch_audit.audit_serving(model, device=device))
        findings.extend(dispatch_audit.audit_fleet_chunked(device=device))
        findings.extend(dispatch_audit.audit_recalibration(model,
                                                           device=device))
        errs = dispatch_audit.errors_of(findings)
        n_errors += len(errs)
        for f in findings:
            print(f"dispatch_audit: {f}",
                  file=sys.stderr if f.severity == dispatch_audit.ERROR
                  else sys.stdout)
        print(f"dispatch audit: {len(errs)} errors, "
              f"{len(findings) - len(errs)} warnings")
    else:
        print("dispatch audit: skipped")

    findings = repo_lint.run_repo_lint()
    errs = repo_lint.errors_of(findings)
    n_errors += len(errs)
    for f in findings:
        print(f"repo_lint: {f}",
              file=sys.stderr if f.severity == repo_lint.ERROR
              else sys.stdout)
    print(f"repo lint: {len(errs)} errors, "
          f"{len(findings) - len(errs)} warnings")

    if n_errors:
        print(f"FAILED: {n_errors} error(s)", file=sys.stderr)
        return 1
    print("analysis clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
