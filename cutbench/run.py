"""Run one benchmark cell once and print its result as the last line.

    python3 cutbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for; see ``harness/main.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cutbench.harness.main import main, process_start_wall  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], process_start_wall()))
