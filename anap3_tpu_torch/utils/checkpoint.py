"""Mid-solve checkpoint/resume of the port.

The counterpart of ``anap3_tpu/utils/checkpoint.py`` on its self-contained
``.npz`` path, in the same layout, so a checkpoint written by either
package restores into the other:

- ``leaf_<i>``: the state's tensors in field order (a tensor, or a
  possibly nested (named) tuple or list of tensors), as numpy arrays;
- ``__meta__``: JSON bytes with ``iteration``, ``n_leaves``, ``treedef``
  (informational) and ``fingerprint``, the solver parameters without the
  run-control keys; the port adds ``carry``, the scalars of the runner's
  convergence state that the state does not hold (the residual
  criterion's normalization ``ref_norm``), which the JAX package's loader
  ignores.

Writes are atomic: a dot-prefixed temporary file, then ``os.replace``.
A restore puts every leaf on the device and in the dtype of the matching
tensor of ``like``.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import asdict
from pathlib import Path
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "FingerprintMismatch"]

logger = logging.getLogger(__name__)


class FingerprintMismatch(ValueError):
    """Checkpoint params fingerprint differs from the current solver's."""


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _leaves(child)]
    return [tree]


def _treedef(tree: Any) -> str:
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_treedef(child) for child in tree)
        fields = getattr(tree, "_fields", None)
        name = type(tree).__name__
        if fields:
            inner = ", ".join(f"{f}={_treedef(c)}" for f, c in
                              zip(fields, tree))
        return f"{name}({inner})"
    return "*"


def _rebuild(like: Any, leaves: Iterator[Any]) -> Any:
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(c, leaves) for c in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(c, leaves) for c in like)
    return next(leaves)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path, state: Any, iteration: int,
                    params_fingerprint: str = "",
                    carry: Optional[dict] = None) -> None:
    """Atomically persist a solver state (a tensor or tuple of tensors)
    and the scalars ``carry`` (0-d tensors or numbers) beside it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves = _leaves(state)
    # Dot-prefixed temp name so a crash mid-write can never leave a file
    # matching the ckpt_*.npz glob used by CheckpointManager.latest/_gc.
    # Written via a file handle so np.savez does not append another ".npz".
    tmp = path.parent / f".{path.name}.tmp"
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    meta = {"iteration": int(iteration), "n_leaves": len(leaves),
            "treedef": _treedef(state), "fingerprint": params_fingerprint}
    if carry:
        meta["carry"] = {k: float(v) for k, v in carry.items()}
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            __meta__=np.frombuffer(json.dumps(meta).encode(),
                                   dtype=np.uint8),
            **arrays,
        )
    os.replace(tmp, path)


def load_checkpoint(path, like: Any,
                    expected_fingerprint: Optional[str] = None
                    ) -> Tuple[Any, int]:
    """Restore a state saved by save_checkpoint (either package's).

    ``like`` supplies the structure, dtypes and devices (shapes are
    validated). ``expected_fingerprint`` (when given) must match the
    fingerprint stored at save time: resuming a run whose physics params
    changed (Re, CFL, corner treatment) but whose grid shape did not would
    otherwise silently produce a wrong "converged" solution. Returns
    (state, iteration).
    """
    state, meta = _load(path, like, expected_fingerprint)
    return state, meta["iteration"]


def _load(path, like: Any, expected_fingerprint: Optional[str]):
    """load_checkpoint's state and the whole ``__meta__`` dict."""
    path = Path(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if expected_fingerprint is not None:
            stored = meta.get("fingerprint", "")
            if stored and stored != expected_fingerprint:
                raise FingerprintMismatch(
                    f"Checkpoint {path} was saved with different solver "
                    f"parameters; refusing to resume from it.")
        leaves_like = _leaves(like)
        if meta["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"Checkpoint has {meta['n_leaves']} leaves, expected "
                f"{len(leaves_like)}")
        leaves = []
        for i, ref in enumerate(leaves_like):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(np.shape(ref)):
                raise ValueError(
                    f"Leaf {i} shape {arr.shape} != expected "
                    f"{tuple(np.shape(ref))}")
            if isinstance(ref, torch.Tensor):
                leaves.append(torch.as_tensor(arr, dtype=ref.dtype,
                                              device=ref.device))
            else:
                leaves.append(np.asarray(arr, dtype=np.asarray(ref).dtype))
        return _rebuild(like, iter(leaves)), meta


class CheckpointManager:
    """Every-K-chunks checkpointing hook for the iteration runner.

    Usage::

        mgr = CheckpointManager(dir, params, every_chunks=10)
        state, start_iter = mgr.restore_or(initial_state)
        ... in the solve loop: mgr.maybe_save(state, iteration, carry)

    After ``restore_or``, ``carry`` holds the restored checkpoint's
    scalars (empty for a fresh start or a JAX-written checkpoint).
    """

    # Run-control knobs that may legitimately change across a resume
    # (extending the iteration budget, relaxing the tolerance, retuning the
    # chunking, the device the solve runs on) -- everything else in the
    # params dataclass is physics or discretization and MUST match the
    # checkpoint. ``device`` exists in the port's params only; leaving it
    # out of the fingerprint also keeps it equal to the JAX package's.
    RUN_CONTROL_KEYS = frozenset({
        "max_iterations", "tolerance", "chunk_size", "checkpoint_dir",
        "checkpoint_every_chunks", "use_pallas", "convergence_metric",
        "stall_chunks", "matmul_algorithm", "device",
    })

    def __init__(self, directory, params=None, every_chunks: int = 10,
                 keep: int = 2):
        self.dir = Path(directory)
        self.every = max(1, int(every_chunks))
        self.keep = keep
        self._chunk_count = 0
        self.carry: dict = {}
        try:
            fields = {k: v for k, v in asdict(params).items()
                      if k not in self.RUN_CONTROL_KEYS} if params else {}
            self.fingerprint = json.dumps(fields, sort_keys=True,
                                          default=str) if params else ""
        except TypeError:
            self.fingerprint = str(params)

    @staticmethod
    def _ckpt_index(p: Path) -> Optional[int]:
        try:
            return int(p.stem.split("_")[1])
        except (IndexError, ValueError):
            return None  # stray/partial file: ignore rather than crash

    def _checkpoints(self):
        if not self.dir.exists():
            return []
        cpts = [(self._ckpt_index(p), p) for p in self.dir.glob("ckpt_*.npz")]
        return [p for i, p in sorted((i, p) for i, p in cpts if i is not None)]

    @property
    def latest(self) -> Optional[Path]:
        cpts = self._checkpoints()
        return cpts[-1] if cpts else None

    def restore_or(self, initial_state) -> Tuple[Any, int]:
        path = self.latest
        if path is None:
            return initial_state, 0
        try:
            state, meta = _load(path, initial_state,
                                self.fingerprint or None)
            iteration = meta["iteration"]
            self.carry = dict(meta.get("carry", {}))
            logger.info("Resumed from checkpoint %s at iteration %d",
                        path, iteration)
            return state, iteration
        except FingerprintMismatch:
            raise
        except Exception:
            logger.warning("Failed to restore checkpoint %s; starting fresh",
                           path, exc_info=True)
            return initial_state, 0

    def maybe_save(self, state, iteration: int,
                   carry: Optional[dict] = None) -> bool:
        self._chunk_count += 1
        if self._chunk_count % self.every != 0:
            return False
        self.save(state, iteration, carry)
        return True

    def save(self, state, iteration: int,
             carry: Optional[dict] = None) -> None:
        """Write the checkpoint of ``iteration`` and drop all but the
        newest ``keep``."""
        path = self.dir / f"ckpt_{iteration:09d}.npz"
        save_checkpoint(path, state, iteration, self.fingerprint, carry)
        self._gc()

    def _gc(self) -> None:
        for old in self._checkpoints()[: -self.keep]:
            old.unlink(missing_ok=True)
