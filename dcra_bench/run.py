"""Run one benchmark cell once: ``python3 dcra_bench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` from the checkout's root.
The last line of standard output is the run's JSON result."""
import time

T0 = time.perf_counter()    # set-up is timed from the start of the process

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from dcra_bench import harness
    sys.exit(harness.main(sys.argv[1:], T0))
