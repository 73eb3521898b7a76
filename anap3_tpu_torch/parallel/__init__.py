"""Batched parameter sweeps of the port (``anap3_tpu/parallel`` on one card):
SG, FSG and FV lanes through the lane kernels."""

from .sweep import (SweepResult, StackedOps, make_batched_chunk_runner,
                    run_batched_sweep, stack_ops, stack_states)

__all__ = ["SweepResult", "StackedOps", "make_batched_chunk_runner",
           "run_batched_sweep", "stack_ops", "stack_states"]
