"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything that belongs to one configuration, traffic
mix, cell or metric is a file of its own, found by its name:

* ``configs/<config>.json`` — the configuration as it is run, naming its
  system module (``systems/<system>.py``: how the system under test is built
  and fed) and its plain reference (``refs/<reference>.py``);
* ``traffic/<traffic>.json`` — a mix's parameters; its ``kind`` names the
  arrival process (``kinds/<kind>.py``, one ``generate`` of one signature
  each, found through ``generator.py``);
* ``cells/<cell>.json`` — the limits of the cell's correctness check;
* ``metrics/<metric>.py`` — one reader a metric, end to end or per layer
  (a quantity split by the end-to-end metric it moves, ``<name>.<part>``,
  may share ``metrics/<name>.py``).

The yardstick (the generator, ``stats.py``, ``counts.py``, ``trace.py``,
the references and the comparisons) lives here and imports nothing of
the program; the system modules alone import ``repro_torch``.
"""

import importlib.util
from pathlib import Path
from types import ModuleType


def load_module(path: Path, name: str) -> ModuleType:
    """A module of ``bench/`` by its file, whatever its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
