"""The control of a cell's ``correct``: a whole run with the reference's
control in the program's place (``reference.control_compress`` /
``control_decompress``: one stated guarantee broken), judged exactly as
the program's runs are.  Its result line must read ``"correct": false``.

    python3 -m portbench.control --workload <name> --seed <n>
        --seconds <s> --trace 0

The benchmark's own runs never run it.
"""
from __future__ import annotations

import os
import sys

from . import run

if __name__ == "__main__":
    code = run.main(control=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
