import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Python's bytecode is a build cache like the kernels': kept in the checkout
# (`ptbench/.cache/pycache`) and written by the first run there, so later
# runs load torch and the program without compiling their sources again.
sys.pycache_prefix = str(Path(__file__).resolve().parent / ".cache" / "pycache")
sys.dont_write_bytecode = False

from ptbench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], T0))
