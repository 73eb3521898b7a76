"""Plain float64 NumPy references that judge the port's answers.

Nothing here imports the program, JAX or the JAX package: every operator
is worked out again from the configuration. Each module judges a converged
state by the equations that define it.
"""
