"""Static verification layer of the port: trace protocol linting,
dispatch auditing, and repo-invariant AST linting.

Three passes, all runnable as ``python -m repro_torch.analysis``:

* :mod:`repro_torch.analysis.trace_lint` — the JEDEC timing/state rule
  engine over :class:`~repro_torch.core.dram.CommandTrace` (numpy, batched
  torch and reference engines); every trace producer and the serving
  ingestion path run it.
* :mod:`repro_torch.analysis.dispatch_audit` — runs every registered
  (estimator kind x impl x mode) dispatch under a recorder and flags
  float64 ops, host round trips, unmasked pad rows and build-state growth.
* :mod:`repro_torch.analysis.repo_lint` — an AST pass enforcing the Model
  API invariants (no deprecated shims, impls declare their modes, fitters
  declare streaming, per-call kernel choice, serialization covers every
  ``PowerParams`` field).
"""
from repro_torch.analysis.trace_lint import (Diagnostic,  # noqa: F401
                                             TimingRule, TraceProtocolError,
                                             check_generated, lint_batch,
                                             lint_trace, lint_traces,
                                             reference_lint)
