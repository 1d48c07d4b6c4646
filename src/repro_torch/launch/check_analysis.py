"""Invariant-checker launcher: ``python -m repro_torch.launch.check_analysis``
(port of ``repro.launch.check_analysis``).

A thin alias for ``python -m repro_torch.analysis`` so the analysis gate
sits next to the other launchers (``integrate``, ``serve_integrals``,
...).  Same arguments, same exit codes; see
:mod:`repro_torch.analysis.__main__`.
"""

from __future__ import annotations

import sys

from repro_torch.analysis.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
