"""The REFERENCE's own python Loader must open a repo output directory.

SURVEY §7 stage 10 promises "python Loader compatibility (same file
formats)".  The reference tooling hard-requires the output identifier
file ``fargocpt_output_v1_4`` (reference src/output.cpp:205,
python_module/fargocpt/data.py ``Loader._check_output_dir``) and reads
snapshot times / monitor numbers from ``snapshots/timeSnapshot.dat``
(reference src/output.cpp:1014-1068 ``write_snapshot_time``,
``Loader._load_snapshots``).  This test imports the reference's
``python_module/fargocpt`` package verbatim (astropy is not installed
here, so a minimal ``Unit``/``Quantity`` shim is injected first) and
drives its ``Loader`` end-to-end on a repo output dir.
"""

import os
import sys
import types

import numpy as np
import pytest

from fargocpt_tpu.config import Config
from fargocpt_tpu.sim import Simulation
from fargocpt_tpu import output as out

from test_output_restart import cfg_dict

REF_PYMOD = "/root/reference/python_module"


class _Quantity:
    """Just-enough astropy.units.Quantity: wraps ndarray, keeps a unit tag."""

    def __init__(self, value, unit=None):
        if isinstance(value, _Quantity):
            unit = value.unit if unit is None else unit
            value = value.value
        elif (isinstance(value, (list, tuple)) and value
              and isinstance(value[0], _Quantity)):
            unit = value[0].unit
            value = [v.value for v in value]
        self.value = np.asarray(value)
        self.unit = unit

    @property
    def isscalar(self):
        return self.value.ndim == 0

    def __getitem__(self, idx):
        return _Quantity(self.value[idx], self.unit)

    def __len__(self):
        return len(self.value)

    def __int__(self):
        return int(self.value)

    def __float__(self):
        return float(self.value)

    def __mul__(self, other):
        return _Quantity(self.value * np.asarray(other), self.unit)

    __rmul__ = __mul__

    def to(self, unit):
        if str(unit) != str(self.unit):
            raise NotImplementedError("stub Quantity cannot convert units")
        return self

    def __repr__(self):
        return f"{self.value} {self.unit}"


class _Unit:
    """Just-enough astropy.units.Unit: remembers the unit string."""

    # make ndarray * Unit defer to Unit.__rmul__ instead of broadcasting
    __array_ufunc__ = None

    def __init__(self, s):
        self.s = str(s)

    def __rmul__(self, other):
        return _Quantity(other, self)

    def __str__(self):
        return self.s

    __repr__ = __str__


@pytest.fixture()
def reference_fargocpt(monkeypatch):
    """Import the reference python module with an astropy shim."""
    if not os.path.exists(REF_PYMOD):
        pytest.skip("reference tree not available")
    astropy = types.ModuleType("astropy")
    astropy_units = types.ModuleType("astropy.units")
    astropy_units.Unit = _Unit
    astropy_units.Quantity = _Quantity
    astropy.units = astropy_units
    monkeypatch.setitem(sys.modules, "astropy", astropy)
    monkeypatch.setitem(sys.modules, "astropy.units", astropy_units)
    monkeypatch.syspath_prepend(REF_PYMOD)
    for mod in [m for m in sys.modules if m.split(".")[0] == "fargocpt"]:
        monkeypatch.delitem(sys.modules, mod)
    import fargocpt.data as ref_data
    yield ref_data
    for mod in [m for m in sys.modules if m.split(".")[0] == "fargocpt"]:
        sys.modules.pop(mod, None)


def test_reference_loader_opens_repo_output(tmp_path, reference_fargocpt):
    ref_data = reference_fargocpt
    outdir = tmp_path / "out"
    sim = Simulation(Config.from_dict(cfg_dict(outdir, monitors=2)))
    out.OutputWriter(sim)
    sim.run()

    loader = ref_data.Loader(str(outdir))

    # identifier + snapshot registry (data.py _check_output_dir passed)
    assert loader.snapshots == [0, 1, 2]

    # snapshot times from timeSnapshot.dat: code-time column with the cgs
    # factor carried in the unit string (reference output.cpp:1055-1066
    # writes sim::time with units::time.get_cgs_factor_symbol())
    t = loader.snapshot_time
    assert t.value.shape == (3,)
    assert np.allclose(t.value, [0.0, 0.3, 0.6], rtol=0, atol=1e-12)
    assert str(t.unit) == f"{sim.units.time:.16e} s"
    assert loader.monitor_number == [0, 1, 2]

    # units.yml parsed into the reference Units object
    assert str(loader.units.length).endswith("cm")

    # gas 2D field through the reference Vars2D reader matches the raw file
    sigma = loader.gas.vars2D.get("Sigma", 2)
    raw = np.fromfile(outdir / "snapshots" / "2" / "Sigma.dat",
                      np.float64).reshape(32, 16)
    assert sigma.value.shape == (32, 16)
    assert np.array_equal(sigma.value, raw)

    # grid radii via used_rad.dat
    assert loader.gas.grid.Nrad == 32 and loader.gas.grid.Naz == 16
    assert np.isclose(loader.gas.grid.radi.value[1], 0.4)

    # nbody monitor files discovered and column-addressable
    assert len(loader.nbody) == 2
    a = loader.nbody[1].get("semi-major axis").value
    assert np.allclose(a, 1.0, rtol=1e-4)

    # params resolved from parameters/
    assert int(loader.params["Nrad"]) == 32


def test_time_snapshot_restart_appends(tmp_path):
    """A restart must append to timeSnapshot.dat, not rewrite it
    (reference src/output.cpp:1024-1031 restart branch)."""
    outdir = tmp_path / "out"
    sim = Simulation(Config.from_dict(cfg_dict(outdir, monitors=1)))
    out.OutputWriter(sim)
    sim.run()

    sim2 = Simulation(Config.from_dict(cfg_dict(outdir, monitors=2)))
    out.OutputWriter(sim2)
    out.restore_simulation(sim2, outdir, 1)
    sim2.run()

    rows = np.loadtxt(outdir / "snapshots" / "timeSnapshot.dat")
    assert rows.shape == (3, 3)
    assert list(rows[:, 0]) == [0.0, 1.0, 2.0]
    # times strictly increasing across the restart boundary
    assert np.all(np.diff(rows[:, 2]) > 0)
