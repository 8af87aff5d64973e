"""Debug-mode numerical checks — port of ``zsgnet_tpu/utils/debug.py``.

* :func:`assert_finite_tree` — over nested dicts, lists and tuples of
  tensors or arrays (a ``state_dict``, a batch, a loss dict; a module
  counts as its ``state_dict``, other objects are skipped), raises
  ``FloatingPointError`` naming the non-finite floating leaves;
* :func:`checked` — wraps a function so that a non-finite floating tensor
  in its output raises, naming the leaf. It is the eager counterpart of
  checkify's float checks on the JAX side. It does not make checkify's
  out-of-bounds checks, which eager PyTorch indexing already raises, nor
  its division checks: a division by zero shows up here as the inf or NaN
  it produces.

    step = checked(make_train_step(cfg, anchors, device))
    state, ls = step(state, batch)   # raises on a NaN loss, naming it
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, torch.nn.Module):
        yield from _leaves(tree.state_dict(), path)
    else:
        yield path, tree


def non_finite_leaves(tree: Any) -> list[str]:
    """Paths (``['key'][0]``) of the floating leaves holding a NaN or inf."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf.detach()).all()):
                bad.append(path)
        elif isinstance(leaf, (np.ndarray, np.floating, float)):
            a = np.asarray(leaf)
            if a.dtype.kind == "f" and not np.isfinite(a).all():
                bad.append(path)
    return bad


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` listing the first ten non-finite leaves."""
    bad = non_finite_leaves(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def checked(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn`` that raises ``FloatingPointError`` when its output holds a
    non-finite floating tensor or array."""

    def wrapper(*args: Any, **kwargs: Any) -> Any:
        out = fn(*args, **kwargs)
        assert_finite_tree(out, name=f"the output of {getattr(fn, '__name__', 'fn')}")
        return out

    return wrapper
