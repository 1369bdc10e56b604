"""Traffic drivers, one module a ``driver`` named in a traffic file: each
plays its traffic against the port (``setup``, ``window``, ``traced``,
``release``) and checks what the port produced against the float32
reference (``check``); ``calibrate`` reads the control's and the planted
faults' numbers beside the port's."""

import sys
import time

#: set-up logs run from the drivers' import, just before set-up begins
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[perfbench] {time.perf_counter() - T0:.3f} s: {msg}",
          file=sys.stderr, flush=True)
