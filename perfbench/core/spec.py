"""What a run is made of, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``mixes/<name>.json``), its limits (``limits/<cell>.json``), and the
per-layer readers (``metrics/<name>.py``), kernel costs (``costs/<kernel>.py``)
and plain references (``reference/<config>.py``) that go with them.

A new cell is an entry in ``BENCHMARK.json`` plus such files; nothing here
changes for it.
"""

from __future__ import annotations

import copy
import hashlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
OUT_DIR = BENCH_DIR / "out"


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def parked() -> dict:
    """Cells kept out of ``BENCHMARK.json`` for now, with the metrics only
    they report, in its format (``parked.json``): the harness runs them by
    name, and a later change moves them into ``BENCHMARK.json``."""
    with open(BENCH_DIR / "parked.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def mix(name: str) -> dict:
    return _json("mixes", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


_MODULES: Dict[str, ModuleType] = {}


def module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` under the benchmark's folder, loaded once (the
    names of metrics carry dots, so they are loaded by path)."""
    key = f"{kind}/{name}"
    if key not in _MODULES:
        path = BENCH_DIR / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} module named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def reference(config_name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.reference.{config_name}")


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, mix,
    limits and metrics, resolved by name."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = benchmark() if bench is None else bench
        if name not in {w["name"] for w in bench["workloads"]}:
            more = parked()
            bench = dict(bench, **{k: bench[k] + more[k] for k in more})
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload named {name!r}; "
                           f"known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = config(self.entry["config"])
        self.mix = mix(self.entry["traffic"])
        self.limits = limits(name)
        self.end_to_end = self._metrics(bench["end_to_end"])
        self.per_layer = self._metrics(bench["per_layer"])
        self.run_seconds = int(bench["run_seconds"])

    def _metrics(self, entries: List[dict]) -> List[dict]:
        return [m for m in entries
                if self.name in m.get("workloads", [self.name])]

    def port_config(self, overrides: Optional[dict] = None):
        """The program's config: its experiment, with every entry of the
        configuration file's ``config`` checked against it (the file states
        the configuration as it is run), then ``overrides`` (``{section:
        {key: value}}``, for tests at a small size)."""
        from litehandnet_tpu_torch.config import get_config

        cfg = get_config(self.config["experiment"])
        for section, values in self.config["config"].items():
            for key, value in values.items():
                have = cfg[section].get(key)
                if _plain(have) != value:
                    raise ValueError(
                        f"{self.config['name']}: {section}.{key} is {have!r} "
                        f"in {self.config['experiment']}, the file says "
                        f"{value!r}")
        for section, values in (overrides or {}).items():
            for key, value in values.items():
                cfg[section][key] = copy.deepcopy(value)
        return cfg

    def model_spec(self, overrides: Optional[dict] = None) -> dict:
        """The ``MODEL`` entry the reference is built from."""
        model = dict(self.config["config"]["MODEL"])
        model.update((overrides or {}).get("MODEL", {}))
        return model


def _plain(value):
    """A config value as JSON has it (tuples become lists)."""
    return json.loads(json.dumps(value))


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each use of the run's ``--seed``."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1
