"""``python -m repro_torch.analysis`` — the port's invariant-checker CLI
(port of ``repro.analysis.__main__``).

Default run (no arguments): Layer 1 lints the installed ``repro_torch``
package tree and Layer 2 checks every registered kernel form under every
advertised capability combination.  Explicit paths restrict the run to
Layer 1 over those paths (fixture checking, editor integration).
``--state-dir`` additionally runs the Layer-3 determinism auditor over a
``DurableStore`` directory (the reference's format, written by either
package).  ``--skip-contracts`` (the lint alone) imports no torch.

Exit status 0 means every checked invariant holds; 1 means violations
were printed (one ``RULE path:line message`` per line); 2 means the
checker itself could not run.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.violations import RULES, render


def _default_tree() -> str:
    # the repro_torch package directory itself: works both from a src
    # checkout and an installed package
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Check the port's kernel/service invariants "
                    "(see repro_torch.analysis.RULES for rule IDs).")
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the repro_torch "
             "package tree, plus the kernel contract layer)")
    parser.add_argument(
        "--state-dir", action="append", default=[],
        help="DurableStore state dir to audit (repeatable)")
    parser.add_argument(
        "--skip-contracts", action="store_true",
        help="skip the kernel contract layer (no torch import)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print every rule ID and the contract it enforces")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule}  {RULES[rule]}")
        return 0

    violations = []
    notes = []

    from repro_torch.analysis import boundary
    lint_paths = args.paths or [_default_tree()]
    violations.extend(boundary.check_paths(lint_paths))
    notes.append(f"boundary: linted {lint_paths}")

    run_contracts = not args.skip_contracts and not args.paths
    if run_contracts:
        from repro_torch.analysis import contracts
        from repro_torch.kernels import registry
        violations.extend(contracts.check_registered_forms())
        forms = registry.forms()
        combos = sum(len(contracts._combos(f)) for f in forms)
        notes.append(f"contracts: {len(forms)} form(s), "
                     f"{combos} capability combo(s) checked")

    from repro_torch.analysis import streams
    for state_dir in args.state_dir:
        report = streams.audit_state_dir(state_dir)
        violations.extend(report.violations)
        notes.append(report.summary())

    if violations:
        print(render(violations))
    for note in notes:
        print(f"[analysis] {note}", file=sys.stderr)
    status = "FAIL" if violations else "OK"
    print(f"[analysis] {status}: {len(violations)} violation(s)",
          file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
