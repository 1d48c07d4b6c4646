# Port of repro.core: counter RNG, finite boxes, families, Genz suite,
# the chunked direct-MC engine and the multi-function solver.

from repro_torch.core.direct_mc import (
    MCResult,
    SumsState,
    family_sums,
    finalize,
    merge_sums,
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
from repro_torch.core.multifunctions import (MultiFunctionResult,
                                             ZMCMultiFunctions)

__all__ = [
    "IntegrandFamily",
    "MCResult",
    "MultiFunctionResult",
    "MultiFunctionSpec",
    "SumsState",
    "ZMCMultiFunctions",
    "abs_sum_family",
    "family_from_numpy",
    "family_sums",
    "finalize",
    "gaussian_analytic",
    "gaussian_family",
    "harmonic_analytic",
    "harmonic_family",
    "merge_sums",
    "spec_from_numpy",
]
