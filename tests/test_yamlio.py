"""The package's YAML subset reader/writer (fargocpt_tpu/yamlio.py).

Every committed ``*.yml`` must read back exactly as ``yaml.safe_load``
reads it — values and types — because ``Config`` consumes the typed
values.  PyYAML is only the test oracle; whether it is importable is
decided inside the tests, never at collection.
"""

import builtins
import math
import subprocess
import sys
from pathlib import Path

import pytest

from fargocpt_tpu import yamlio

REPO = Path(__file__).resolve().parent.parent
# the committed files (git's list; a checkout without .git falls back to
# every *.yml outside hidden and output directories)
YML_FILES = sorted(
    (REPO / p) for p in subprocess.run(
        ["git", "-C", str(REPO), "ls-files", "*.yml"],
        capture_output=True, text=True).stdout.split()) or sorted(
    p for p in REPO.rglob("*.yml")
    if not any(part.startswith(".") or part == "chiprun_out"
               for part in p.relative_to(REPO).parts))


def _pyyaml():
    return pytest.importorskip("yaml")


def _same(a, b) -> bool:
    """Equal values AND equal types, recursively (1 != 1.0 != True)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_committed_yml_files_found():
    assert len(YML_FILES) >= 64


@pytest.mark.parametrize("path", YML_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_reader_matches_safe_load(path):
    yaml = _pyyaml()
    assert _same(yamlio.load_file(path), yaml.safe_load(path.read_text()))


@pytest.mark.parametrize("text", [
    "yes", "No", "on", "OFF", "y", "1e-5", "1.0e-5", "1.0e5", "1.", "3.",
    "0x1F", "017", "0b101", "1:30", "1:30.5", "-.inf", ".nan", "~", "null",
    "12_000", "+5", "-0", "0", "1 au", "0.76 solMass", "'0.5'", '"a\\tb"',
    "'it''s'", "[1, 'a', yes]", "{name: r, unit: cm s^-1, factor: 1.0}",
    "",
])
def test_scalar_resolution_matches_safe_load(text):
    yaml = _pyyaml()
    doc = f"k: {text}"
    assert _same(yamlio.loads(doc), yaml.safe_load(doc))


OUTPUT_DUMPS = [
    {"length": {"unit": "cm", "factor": 14959787070000.0},
     "time": {"unit": "s", "factor": 5022642.89}},
    {"G": 1.0, "R": 3.6e-08, "sigma_sb": 2.1e-15, "c": 10065.3},
    {"Nrad": "32", "Sigma0": "200 g/cm2", "WriteDefaultValues": "yes",
     "FirstDT": 1e-05, "l0": 1, "flag": True, "none": None, "empty": "",
     "nbody": [{"name": "Star", "mass": "1.0", "semi-major axis": 0.0},
               {"name": "Jupiter", "accretion efficiency": "2"}],
     "quoted": "a: b #c", "list": [], "map": {}},
]


@pytest.mark.parametrize("data", OUTPUT_DUMPS, ids=["units", "constants",
                                                   "setup"])
@pytest.mark.parametrize("sort_keys", [True, False])
def test_dump_round_trip(data, sort_keys):
    yaml = _pyyaml()
    text = yamlio.dumps(data, sort_keys=sort_keys)
    assert _same(yamlio.loads(text), data)
    assert _same(yaml.safe_load(text), data)


@pytest.mark.parametrize("text", [
    "a: &anchor 1", "a: *alias", "a: !!str 1", "a: |\n  block",
    "a: >\n  folded", "a: 1\n---\nb: 2", "a: first\n  continued",
    "\ta: 1", "a: [1,\n  2]", "? complex\n: key",
])
def test_unsupported_syntax_names_the_line(text):
    with pytest.raises(yamlio.YamlSubsetError, match=r"<string>:\d+"):
        yamlio.loads(text)


def test_cli_runs_setup_without_pyyaml(tmp_path, monkeypatch):
    """The main path never needs PyYAML: with ``yaml`` unimportable the
    CLI runs a shipped setup (shrunk) and writes its YAML output."""
    from fargocpt_tpu import run
    from fargocpt_tpu.analysis import Loader

    setup = (REPO / "setups" / "spreading_ring.yml").read_text()
    small = tmp_path / "ring.yml"
    lines = []
    for line in setup.splitlines():
        key = line.split(":")[0].strip()
        if key == "Nrad":
            line = "Nrad: 16"
        elif key == "MonitorTimestep":
            line = "MonitorTimestep: 0.05"
        lines.append(line)
    small.write_text("\n".join(lines) + "\n")

    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("yaml is not installed")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    for mod in [m for m in list(sys.modules)
                if m == "yaml" or m.startswith("yaml.")]:
        monkeypatch.delitem(sys.modules, mod)
    out = tmp_path / "out"
    assert run(["start", str(small), "-o", str(out), "-N", "4"]) == 0
    loader = Loader(out)
    assert loader.units["length"]["unit"] == "cm"
    assert loader.params()["Nrad"] == 16

    # every YAML file the run wrote reads back as PyYAML reads it
    monkeypatch.undo()
    yaml = _pyyaml()
    written = sorted(out.rglob("*.yml"))
    assert {p.name for p in written} >= {"units.yml", "constants.yml",
                                         "info2D.yml", "info1D.yml",
                                         "setup.yml", "config.yml"}
    for path in written:
        assert _same(yamlio.load_file(path), yaml.safe_load(path.read_text()))
