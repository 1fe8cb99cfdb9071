"""repro_torch.check -- the port's contract audit.

The port of the contract half of ``repro.check``
(:mod:`repro_torch.check.contracts`): every golden spec's step is run and
recorded, and its wire (u8 ``pp`` payloads, 2 x hops calls, exact bytes),
its dtypes (no f64 in a sharded step) and its host reads are held to the
reference's contracts.  The reference's linter already scans the port
(``src/repro/check/lint.py``'s ``LINT_DIRS``), so the port has no lint
layer.

CLI: ``python -m repro_torch.check [--specs DIR] [--only STEM] [--json]
[--device cpu|cuda]``.
"""
