"""Checkpoint and resume — port of gdpathtracing_tpu/post/checkpoint.py.

A post state (``ProgressiveState``, ``TemporalState``) or any nest of named
tuples, tuples, lists and dicts of tensors is saved to an ``.npz``, its
structure beside the leaves as a string; loading checks that string
against the structure it is asked to fill and refuses another.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s tensors to ``leaves`` in order; return its
    structure, the leaves written as ``*``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "*"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        inner = ", ".join(f"{k}={_flatten(v, leaves)}"
                          for k, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                          for k in sorted(tree))
        return "{" + inner + "}"
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _unflatten(like, leaves):
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return {k: _unflatten(like[k], leaves) for k in sorted(like)}


def save_state(path: str | Path, state) -> None:
    """Write ``state``'s tensors and structure to the ``.npz`` at
    ``path``."""
    leaves: list = []
    structure = _flatten(state, leaves)
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(leaves)}
    arrays["__structure__"] = np.array(structure)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_state(path: str | Path, like):
    """Load the ``.npz`` at ``path`` into the structure of ``like``, each
    tensor on the device of ``like``'s tensor in its place. Raises
    ValueError where the saved structure differs."""
    data = np.load(path, allow_pickle=False)
    like_leaves: list = []
    structure = _flatten(like, like_leaves)
    saved = str(data["__structure__"])
    if saved != structure:
        raise ValueError(f"checkpoint structure mismatch:\n saved: {saved}"
                         f"\n expected: {structure}")
    leaves = (torch.from_numpy(data[f"leaf_{i}"]).to(x.device)
              for i, x in enumerate(like_leaves))
    return _unflatten(like, leaves)
