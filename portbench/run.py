"""Run one cell of ``BENCHMARK.json`` once, in this process:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``src/repro_torch``).
It builds the cell's system from the seed, warms up every shape the
cell's traffic uses (counted in ``setup_s``), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, last,
``checks``. It exits non-zero, printing no result, when torch sees fewer
CUDA devices than the cell asks for, when the program is not beside it,
or when the process holds ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` after the window.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the benchmark's package and the program, never the script's own folder
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    code = main(sys.argv[1:], t_process=T_PROCESS)
    sys.stdout.flush()
    sys.stderr.flush()
    # nothing may print after the result and the numbers compared: no
    # exit handler of a library runs
    os._exit(code)
