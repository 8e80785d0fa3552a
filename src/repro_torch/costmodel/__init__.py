from .energy import EnergyBreakdown, run_energy          # noqa: F401
from .params import COMPUTE, LINK, MEM, SILICON           # noqa: F401
from .perf import PerfResult, run_perf                    # noqa: F401
from .silicon import (dcra_die_area_mm2, die_cost_usd,     # noqa: F401
                      murphy_yield, package_cost)
