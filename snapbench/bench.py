"""Finding the benchmark's parts by name.

``BENCHMARK.json`` at the root of a checkout names the cells, their
configurations and metrics. Everything else is found by name under
``snapbench/``, so a later change adds files and entries and edits none:

- a configuration: the ``file`` its entry names (``configs/<name>.json``),
  whose ``reference`` names its plain reference, ``reference/<name>.py``.
  ``pool_headroom_rows`` (absent: 0) gives each disk that many spare pool
  rows, in whole lease quanta, for the window's writes
  (``systems.pool_rows``);
- a traffic mix: ``traffic/<name>.json``, read by ``generator.py``. A mix
  may write (``writes_per_tenant``), snapshot every disk every N batches
  (``snapshot_every``) and tick the port's maintenance scheduler each
  batch (``maintenance``, its keyword arguments);
- a per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` returns
  the value or ``None`` where it finds nothing to read. ``run`` holds the
  unprofiled ``window`` (``seconds``, ``batches``, ``host_s`` a batch,
  in a mix that ticks ``tick_s`` a batch), the ``trace``
  (``tracing.summarize``'s ``complete``, ``window_s``, ``busy_s``,
  ``layer_s`` by layer, ``steps``), the program's ``lookups_per_read``,
  the traced steps' ``spans`` (by range name, the harness's
  ``snapbench.*`` and the program's: ``host_s``, ``count``, ``idle_s``)
  and ``counters`` (``launches`` and ``pages``, the program's counters'
  deltas, and the ``reads`` and ``writes`` issued), the card's ``peaks``
  and the ``bytes`` the window's and the traced batches need
  (``resolve``, ``gather``, and in a mix that writes ``write``; resolve
  ``None`` where ``rooflines.bytes`` cannot count it);
- a layer's kernels: ``layers/<file>.json``, each naming its ``layer``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

MANIFEST = "BENCHMARK.json"
HOME = "snapbench"


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    known = sorted(e["name"] for e in entries)
    raise KeyError(f"unknown {what} {name!r}; {MANIFEST} has {known}")


class Bench:
    """The manifest of one checkout and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.home = self.root / HOME
        self.manifest = json.loads((self.root / MANIFEST).read_text())

    def cell(self, name: str) -> dict:
        return _by_name(self.manifest["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = _by_name(self.manifest["configs"], name, "configuration")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def reference(self, cfg: dict):
        """The configuration's plain reference class."""
        mod = _load_module(self.home / "reference" / f"{cfg['reference']}.py",
                           f"snapbench_reference_{cfg['reference']}")
        return mod.REFERENCE

    def metric_reader(self, name: str):
        mod = _load_module(self.home / "metrics" / f"{name}.py",
                           f"snapbench_metric_{name}")
        return mod.read

    def layers(self) -> list[dict]:
        """Every layer map, in file-name order."""
        return [json.loads(p.read_text())
                for p in sorted((self.home / "layers").glob("*.json"))]

    def metrics_of(self, kind: str, cell: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
        without a ``workloads`` key and those whose key lists it."""
        return [m for m in self.manifest[kind]
                if cell in m.get("workloads", [cell])]
