"""Leaf paths of the port's nested trees — parameters, layer state, gradients
and optimizer slots are dicts of dicts whose depth varies: a plain layer's
parameters sit at ``tree[layer][key]``, a recurrent group's at
``tree[group][inner layer][key]`` (the JAX package's params pytree has the
same shape).  Every walker of those trees goes through these functions, so
a nested tree trains, saves and loads like a flat one."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

Path = Tuple[str, ...]


def leaf_paths(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) over every non-dict value, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def leaves(tree) -> list:
    return [v for _, v in leaf_paths(tree)]


def map_leaves(fn: Callable[[Any], Any], tree):
    """`tree`'s structure with ``fn(leaf)`` at every leaf."""
    return {k: map_leaves(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def get_path(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree, path: Path, value) -> None:
    """``tree[path] = value`` in place, creating intermediate dicts."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def dotted(path: Path) -> str:
    """The JAX package's parameter name of a leaf path: "decoder.att.w0"."""
    return ".".join(path)
