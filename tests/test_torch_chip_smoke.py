"""chip_smoke.py's kernel table on the CPU: the rows whose bound is closed
in the grid's size reckon, at 512^3, the bytes and least times that
PERF.md's kernel table records. No card is needed: a bound is arithmetic
on shapes."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def rows():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_rows", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {r.name: r for r in mod.kernel_rows()}


@pytest.mark.parametrize("row, nbytes, bound_ms", [
    ("tv.fwd_kernel", 2_147_483_648, 0.6410),
    ("tv.bwd", 4_294_967_296, 1.2821),
    ("adam", 15_032_385_536, 4.4873),
    ("k4.zero_fill", 2_147_483_648, 0.6410)])
def test_closed_form_bound_at_512(rows, row, nbytes, bound_ms):
    b = rows[row].bound(SimpleNamespace(D=512))
    assert b["bytes"] == nbytes
    assert round(b["bound_ms"], 4) == bound_ms
    assert b["bound_by"] == "bytes"


def test_bounds_pass_bound_at_c4(rows):
    """The masked c4 step's bounds pass: 65,536 rays in and out (32 B a
    ray) and the 128^3 mask's distance field once (a byte a cell)."""
    b = rows["bounds.c4_masked"].bound(SimpleNamespace(n=65536,
                                                       cells=128 ** 3))
    assert b["bytes"] == 4_194_304
    assert round(b["bound_ms"], 6) == 0.001252
    assert b["bound_by"] == "bytes"
