"""Error budget of the float32 production path vs the float64 reference
path.

The reference binary is all-double (src/types.h); this rebuild's
production path runs float32, with float64 available everywhere as the
validated reference-precision path; this test pins the question — how
much error float32 ARITHMETIC accumulates over a physically-relevant
integration — so the f32-compute/f64-reference strategy has a measured
budget, not a hope.
"""

import numpy as np
import pytest

from fargocpt_tpu.config import Config
from fargocpt_tpu.sim import Simulation


def _cfg():
    return Config.from_dict({
        "EquationOfState": "Ideal", "AdiabaticIndex": "1.4",
        "AspectRatio": "0.05", "FlaringIndex": "0.25",
        "ViscousAlpha": "0.001",
        "Sigma0": "200 g/cm2", "SigmaSlope": "0.5",
        "HeatingViscous": "Yes", "CoolingBetaLocal": "Yes",
        "CoolingBeta": "10",
        "ArtificialViscosity": "SN",
        "Nrad": "64", "Naz": "128",
        "Rmin": "0.4", "Rmax": "2.5", "RadialSpacing": "Log",
        "InnerBoundary": "outflow", "OuterBoundary": "outflow",
        "Transport": "FARGO",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "3.0",
    })


@pytest.mark.slow
def test_f32_error_budget_vs_f64():
    """~200 steps of the adiabatic flagship config: float32 stays within
    a 1e-3 relative L2 budget of float64 on every prognostic field."""
    sims = {}
    for dtype in ("float64", "float32"):
        sim = Simulation(_cfg(), dtype=dtype)
        sim.run()
        sims[dtype] = sim

    assert sims["float32"].n_hydro_iter > 100

    def rel_l2(name):
        a = np.asarray(getattr(sims["float32"].fields, name), np.float64)
        b = np.asarray(getattr(sims["float64"].fields, name), np.float64)
        scale = np.linalg.norm(b)
        if name == "vrad":            # vrad crosses zero; scale by vaz
            scale = np.linalg.norm(
                np.asarray(sims["float64"].fields.vaz, np.float64))
        return np.linalg.norm(a - b) / scale

    budget = {"sigma": 1e-3, "energy": 1e-3, "vaz": 1e-3, "vrad": 1e-3}
    errs = {name: rel_l2(name) for name in budget}
    for name, err in errs.items():
        assert err < budget[name], (name, errs)
    # the comparison is real (not two identical f64 runs)
    assert errs["sigma"] > 0.0
