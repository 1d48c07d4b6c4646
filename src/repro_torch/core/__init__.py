# Port of repro.core: counter RNG, finite boxes, families, Genz suite,
# the chunked direct-MC engine and the three solvers:
#   ZMCNormal          - stratified sampling + heuristic tree search (dim 8-12)
#   ZMCFunctional      - one integrand x large parameter grid (v5)
#   ZMCMultiFunctions  - many heterogeneous integrands (the v5.1 feature)
#
# Variance-reduction substrate (the service's adaptive planner builds on
# these):
#   adaptive    - VEGAS importance grids: pilot, refine, inverse-CDF map
#   stratified  - fixed-capacity stratum tables + per-stratum statistics
#   tree_search - priority-driven stratum refinement (dim 8-12 escalation)

from repro_torch.core import adaptive, stratified, tree_search
from repro_torch.core.adaptive import region_scores

from repro_torch.core.direct_mc import (
    MCResult,
    SumsState,
    family_sums,
    finalize,
    merge_sums,
    sharded_family_sums,
)
from repro_torch.core.integrand import (
    IntegrandFamily,
    MultiFunctionSpec,
    abs_sum_family,
    family_from_numpy,
    gaussian_analytic,
    gaussian_family,
    harmonic_analytic,
    harmonic_family,
    spec_from_numpy,
)
from repro_torch.core.functional import ZMCFunctional
from repro_torch.core.multifunctions import (MultiFunctionResult,
                                             ZMCMultiFunctions)
from repro_torch.core.normal import NormalResult, ZMCNormal

__all__ = [
    "IntegrandFamily",
    "MCResult",
    "MultiFunctionResult",
    "MultiFunctionSpec",
    "NormalResult",
    "SumsState",
    "ZMCFunctional",
    "ZMCMultiFunctions",
    "ZMCNormal",
    "abs_sum_family",
    "adaptive",
    "family_from_numpy",
    "family_sums",
    "finalize",
    "gaussian_analytic",
    "gaussian_family",
    "harmonic_analytic",
    "harmonic_family",
    "merge_sums",
    "region_scores",
    "sharded_family_sums",
    "spec_from_numpy",
    "stratified",
    "tree_search",
]
