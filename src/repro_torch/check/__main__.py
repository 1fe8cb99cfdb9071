"""``python -m repro_torch.check`` -- the port's contract audit over the
golden specs, in-process.

Prints ``[check] PASS/FAIL claim [detail]`` lines and an ``[check]
OK|FAIL: n/m checks hold`` summary; exits nonzero on any FAIL.  Each
sharded spec is audited on its (8, 1) and its (4, 2) mesh, and a sharded
neighbor spec's (4, 2) variant as a tensor-parallel node too
(``<name>/tp``: ``StackedTP(2)``).
Runs on the card unless ``--device cpu`` is given.

Flags::

  --specs DIR      golden-spec dir (default <repo>/tests/golden_specs)
  --only STEM      audit this spec alone (repeatable)
  --json           machine-readable findings on stdout
  --device DEV     cpu or cuda (default: the card; raises without one)
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List

from repro_torch.check.contracts import GateFinding, audit_spec_dir


def _repo_root() -> pathlib.Path:
    # src/repro_torch/check/__main__.py -> repo root
    return pathlib.Path(__file__).resolve().parents[3]


def print_findings(findings: List[GateFinding]) -> int:
    """Print the findings and the summary line; -> the count of FAILs."""
    n_fail = 0
    for claim, ok, detail in findings:
        n_fail += not ok
        print(f"[check] {'PASS' if ok else 'FAIL'} {claim}"
              + (f"   [{detail}]" if detail else ""))
    n = len(findings)
    print(f"[check] {'FAIL' if n_fail else 'OK'}: {n - n_fail}/{n} checks "
          f"hold")
    return n_fail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.check",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--specs", default=None,
                    help="golden-spec dir (default <repo>/tests/"
                         "golden_specs)")
    ap.add_argument("--only", action="append", default=[],
                    help="restrict the audit to these spec stems")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    from repro_torch.api import resolve_device
    device = resolve_device(args.device)
    specs = pathlib.Path(args.specs) if args.specs \
        else _repo_root() / "tests" / "golden_specs"
    findings = audit_spec_dir(specs, device, only=args.only or None)
    if args.as_json:
        print(json.dumps({"device": str(device),
                          "contracts": [list(f) for f in findings]},
                         indent=1))
        return 1 if not all(ok for _, ok, _ in findings) else 0
    return 1 if print_findings(findings) else 0


if __name__ == "__main__":
    sys.exit(main())
