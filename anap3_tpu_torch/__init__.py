"""anap3_tpu_torch — the PyTorch / CUDA port of ``anap3_tpu``.

The JAX package ``anap3_tpu`` is the reference; this package computes the
same lid-driven-cavity solves with PyTorch on one NVIDIA H100. Module names
mirror ``anap3_tpu`` so each counterpart is easy to find:

- ``models/spectral_sg.py``: the plain-torch PN-PN-2 core (operators, RK4
  step, metrics);
- ``models/runner.py``: the chunked convergence runner;
- ``models/spectral.py``: ``SGSolver`` and ``FSGSolver``;
- ``ops/sg_kernels.py``: wrappers of the hand-written CUDA kernels in
  ``csrc/`` (built by ``ops/_build.py``), each beside its plain version.

The package imports ``torch`` and never ``jax``. From ``anap3_tpu`` it uses
only the jax-free numpy modules (bases, corner/singular fields, transfer
operators, validation, VTS I/O and the parameter dataclasses).
"""

__version__ = "0.1.0"
