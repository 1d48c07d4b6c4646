# Static analysis for the port's kernel/service contracts (port of
# repro.analysis).
#
#   violations - rule registry + the Violation record all layers emit
#   boundary   - Layer 1: AST lint (import boundary, purity, f32-only,
#                one clock shim, one retry policy)
#   contracts  - Layer 2: eval-body contracts over registered forms
#   streams    - Layer 3: determinism auditor over durable stream state
#                + live debug assertion hooks
#   __main__   - the CLI: python -m repro_torch.analysis
#
# This package root stays import-light (no torch): the lint and the live
# hooks run in processes that never touch a device.  Layer 2 (contracts)
# imports torch and is pulled lazily by the CLI.

from repro_torch.analysis.violations import RULES, Violation, render

__all__ = ["RULES", "Violation", "render"]
