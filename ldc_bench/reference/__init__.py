"""Plain float64 NumPy references that judge the port's answers.

Nothing here imports the program, JAX or the JAX package: every operator
is worked out again from the configuration. Each module judges a converged
state by the equations that define it.

A configuration names its reference by file (``"reference": "<name>"``
finds ``<name>.py``, ``spec.reference``). Such a module exposes two
functions of the lane's parameters, its order or cells per side ``n`` and
its final state (the solver's state fields as numpy arrays, in order):

- ``lane_numbers(params, n, state)``: a dict of its judged numbers;
- ``lane_evaluator(params, n, state)``: a function ``(x, y) -> (u, v)``
  at points, from which ``validation.l2_errors`` works out the reported
  validation again.

``spectral.py`` and ``fv.py`` are such modules; ``validation.py`` and
``vts.py`` are what they share.
"""
