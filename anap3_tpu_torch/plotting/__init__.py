"""Plot generation for LDC runs: the port's own copy of
``anap3_tpu/plotting``.

The same artifacts from the port's tracking store and VTS files:
convergence.pdf, vorticity.pdf, ghia_comparison.pdf per run plus u.png /
v.png / pressure.png / vel-mag.png / streamlines.png / streamlines_3d.png
field renders (PyVista's when it is importable, matplotlib's otherwise),
and per sweep ghia_comparison.pdf + l2_convergence_{u,v}[_regu].pdf on the
parent run.

Importing this package imports no plotting library: matplotlib, seaborn
and pandas load when a plot is asked for, so a driver run with
``plots=false`` never needs them, and a run with plots on a machine
without them fails its plots with an ImportError that the driver logs.
"""

__all__ = ["generate_plots_for_run", "generate_comparison_plots_for_sweep"]


def generate_plots_for_run(*args, **kwargs) -> list:
    """``orchestrator.generate_plots_for_run``."""
    from .orchestrator import generate_plots_for_run as run

    return run(*args, **kwargs)


def generate_comparison_plots_for_sweep(*args, **kwargs) -> dict:
    """``orchestrator.generate_comparison_plots_for_sweep``."""
    from .orchestrator import generate_comparison_plots_for_sweep as sweep

    return sweep(*args, **kwargs)
