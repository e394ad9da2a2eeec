"""Custom user boundary hook (reference src/boundary_conditions/custom.cpp).

The reference ships a source template users edit and recompile; this
rebuild loads a jax-traceable ``custom_boundary`` callable at runtime —
either from a Python file named by ``CustomBoundaryModule`` or assigned
directly to ``sim.stepper.custom_bc``."""

import textwrap

import numpy as np
import pytest

from fargocpt_tpu.config import Config
from fargocpt_tpu.sim import Simulation


def base_cfg(extra=None):
    d = {
        "EquationOfState": "Isothermal", "AspectRatio": "0.05",
        "ViscousAlpha": "0.001", "Sigma0": "200 g/cm2",
        "SigmaSlope": "0.5", "ArtificialViscosity": "SN",
        "Nrad": "32", "Naz": "16", "Rmin": "0.4", "Rmax": "2.5",
        "RadialSpacing": "Log",
        "InnerBoundary": "custom", "OuterBoundary": "outflow",
        "Transport": "FARGO",
        "Nsnapshots": "1", "Nmonitor": "1", "MonitorTimestep": "0.05",
    }
    d.update(extra or {})
    return Config.from_dict(d)


CUSTOM_SRC = textwrap.dedent("""
    import jax.numpy as jnp

    SIGMA_GHOST = 0.123

    def custom_boundary(g, sigma, vrad, vaz, energy, omega_frame):
        # reference custom.cpp template shape: pin the inner ghost ring
        sigma = sigma.at[0].set(SIGMA_GHOST)
        vrad = vrad.at[0:2].set(0.0)
        vaz = vaz.at[0].set(1.0 / jnp.sqrt(g.rb[0, 0]) -
                            g.rb[0, 0] * omega_frame)
        return sigma, vrad, vaz, energy
""")


def test_custom_boundary_module_file(tmp_path):
    mod = tmp_path / "my_bc.py"
    mod.write_text(CUSTOM_SRC)
    cfg = base_cfg({"CustomBoundaryModule": str(mod)})
    sim = Simulation(cfg)
    sim.run()
    sigma = np.asarray(sim.fields.sigma)
    vrad = np.asarray(sim.fields.vrad)
    assert np.allclose(sigma[0], 0.123)
    assert np.allclose(vrad[0:2], 0.0)


def test_custom_boundary_direct_registration():
    cfg = base_cfg()
    with pytest.warns(UserWarning, match="CustomBoundaryModule"):
        sim = Simulation(cfg)

    def hook(g, sigma, vrad, vaz, energy, omega_frame):
        return sigma.at[0].set(0.5), vrad, vaz, energy

    sim.stepper.custom_bc = hook
    sim.run()
    assert np.allclose(np.asarray(sim.fields.sigma)[0], 0.5)


def test_custom_boundary_module_missing_function(tmp_path):
    mod = tmp_path / "empty.py"
    mod.write_text("x = 1\n")
    with pytest.raises(AttributeError, match="custom_boundary"):
        Simulation(base_cfg({"CustomBoundaryModule": str(mod)}))
