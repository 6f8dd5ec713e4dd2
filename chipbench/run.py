"""Run one benchmark cell once and print its result as the last line.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The program under test is ``src/repro_torch``;
its kernel build and every other cache stay in fixed directories inside
the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".chipbench-cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# byte code, torch's included, is compiled once per checkout and kept there
sys.dont_write_bytecode = False
sys.pycache_prefix = str(CACHE / "pycache")
# the checkout and the program, in place of this script's own folder
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

from chipbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
