"""What every cell shares: the manifest (``BENCHMARK.json``), finding a
cell's configuration, traffic mix and per-layer readers by name, the
statistics of the end-to-end metrics, the check that no JAX module was
loaded, and the one result line.

A cell names a configuration (``configs/<name>.json``, whose ``kind``
names its driver, ``drivers/<kind>.py``, and whose ``reference`` names
its plain reference under ``reference/``) and a traffic mix
(``traffic/<name>.json``). A per-layer metric is read by
``metrics/<name>.py``'s ``read(ctx)``, which returns a number, or None
when its cell gave it nothing to read. Adding a configuration, a mix or a
metric adds files and manifest entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may have loaded once its window
# closes: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "vxtpu")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell of the manifest with what it names, loaded."""

    name: str
    chips: int
    config: dict            # the configuration's file
    config_name: str
    traffic: dict           # the traffic mix's file
    traffic_name: str
    end_to_end: list        # manifest entries of its end-to-end metrics
    per_layer: list         # manifest entries of its per-layer metrics


def cell_metrics(manifest: dict, name: str):
    """(end_to_end entries, per_layer entries) that cell ``name`` reports:
    a metric with ``workloads`` where it lists the cell; an end-to-end
    metric without in every cell; a per-layer metric without in every
    cell that reports the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def find_cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e, layer = cell_metrics(manifest, name)
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(root / cfg["file"]), config_name=cfg["name"],
                traffic=load_json(root / HERE.name / "traffic"
                                  / f"{w['traffic']}.json"),
                traffic_name=w["traffic"], end_to_end=e2e, per_layer=layer)


def driver(kind: str):
    """The module that runs configurations of this kind."""
    return importlib.import_module(f"vxbench.drivers.{kind}")


def reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of per-layer metric ``name`` (``metrics/<name>.py``;
    the name may hold dots, so the file is loaded by its path)."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "vxbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def rate_per_item(window_s: float, items: int) -> float:
    """The window's seconds over the items completed in it, in ms."""
    if items <= 0:
        raise ValueError("no item completed in the window")
    return window_s / items * 1e3


def forbidden_loaded(modules=None) -> list:
    """FORBIDDEN top-level names present in ``sys.modules`` (compared
    whole: ``vxtpu_torch`` is not ``vxtpu``)."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None
                                      else modules)}
    return sorted(t for t in FORBIDDEN if t in tops)


def read_layers(cell: Cell, ctx: dict, root: Path = ROOT) -> dict:
    """The per-layer metrics that this cell's traced run found."""
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"], root)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def checks_ok(checks: dict) -> bool:
    """Every number compared is finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    """The run's last line of standard output; the numbers compared,
    each beside its limit, come last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = {k: [[n, v] for n, v in rows]
                            for k, rows in breakdown.items()}
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {k} {c['value']!r} limit {c['limit']!r}"
                     for k, c in checks.items())
