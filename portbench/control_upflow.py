"""``portbench.control`` for the UPFlow cell, whose driver ``control.py``'s
table of readings does not know:

    python -m portbench.control_upflow --workload upflow_train_kitti --seeds 1,2,3 \\
        [--control-seeds 4,5]

The program on each seed of ``--seeds``, and on each of ``--control-seeds``
the control (the reference computing in float8 e4m3, ``precision="fp8"``)
and the half-batch fault too, each held against the float32 reference
(``drivers.upflow_train.control_readings``); the output is
``portbench.control``'s.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import sys

from portbench import control
from portbench.drivers.upflow_train import control_readings

control.READINGS.setdefault("upflow_train", control_readings)

if __name__ == "__main__":
    sys.exit(control.main())
