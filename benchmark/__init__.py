"""The benchmark of neurecon_tpu_torch on one H100: `python3 -m benchmark.run
--workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>`.

The cells, metrics and bounds are in BENCHMARK.json at the root of the
checkout; each configuration, traffic mix, per-layer metric and cell's
limits is a file of its own here, found by its name (`registry.py`). The
yardstick lives here and nowhere in the program: the scene and weights
(`scene.py`, `weights.py`), the traffic generator (`mixes.py`), the work
arithmetic and the card's peaks (`work.py`), the trace reader (`trace.py`)
and the plain reference with the comparison that decides `correct`
(`reference/`, `mixes.py`). `calibrate.py` reads what the limits are set
from; `faults.py` holds the faults the check is shown to catch.
"""
