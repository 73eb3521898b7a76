"""anap3_tpu_torch — the PyTorch / CUDA port of ``anap3_tpu``.

The JAX package ``anap3_tpu`` is the reference; this package computes the
same lid-driven-cavity solves with PyTorch on one NVIDIA H100. Module names
mirror ``anap3_tpu`` so each counterpart is easy to find:

- ``models/spectral_sg.py``: the plain-torch PN-PN-2 core (operators, RK4
  step, metrics);
- ``models/runner.py``: the chunked convergence runner;
- ``models/spectral.py``: ``SGSolver`` and ``FSGSolver``;
- ``models/spectral_vmg.py``: ``VMGSolver`` and ``FMGSolver`` (FAS
  V-cycles);
- ``models/fv.py``: ``FVSolver`` (FV-SIMPLE);
- ``ops/sg_kernels.py``, ``ops/fv_kernels.py``: wrappers of the
  hand-written CUDA kernels in ``csrc/`` (built by ``ops/_build.py``), each
  beside its plain version.

The package imports ``torch`` and never ``jax``, and nothing of
``anap3_tpu``: the numpy modules it needs (bases, corner and singular
fields, transfer operators, validation, VTS I/O, the parameter
dataclasses) are its own copies, in ``ops/``, ``analysis/``, ``utils/`` and
``models/params.py``.
"""

__version__ = "0.1.0"
