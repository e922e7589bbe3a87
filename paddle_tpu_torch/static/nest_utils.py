"""Nested-structure utilities (ref: python/paddle/fluid/layers/
utils.py: flatten/pack_sequence_as/map_structure and friends, used by
the RNN/decoder stacks).

Port of ``paddle_tpu/static/nest_utils.py``, which is built on
``jax.tree_util``; here the same tree semantics in plain Python:

- the containers are ``list``, ``tuple``, ``dict`` (children in sorted
  key order), ``collections.OrderedDict`` and ``defaultdict`` (sorted
  too), and namedtuples (children in field order); a subclass of a
  container that is none of those is a leaf, as are strings and tensors;
- ``None`` is an empty subtree, not a leaf;
- two structures are the same when their containers have the same types
  (and keys) at the same places.
"""
from __future__ import annotations

import collections

from ..core.enforce import InvalidArgumentError, enforce

__all__ = ["flatten", "pack_sequence_as", "map_structure",
           "assert_same_structure", "is_sequence"]

_LEAF = "*"


def is_sequence(seq) -> bool:
    """ref: utils.py is_sequence: containers, not strings/tensors."""
    return isinstance(seq, (list, tuple, dict))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(x):
    """(node kind, keys, children) of a container, or None for a leaf."""
    t = type(x)
    if x is None:
        return ("none", None, [])
    if t is list or t is tuple:
        return (t, None, list(x))
    if _is_namedtuple(x):
        return (t, None, list(x))
    if t is collections.OrderedDict:
        keys = list(x)
        return (t, tuple(keys), [x[k] for k in keys])
    if t is dict or t is collections.defaultdict:
        keys = sorted(x)
        return ((t, getattr(x, "default_factory", None)), tuple(keys),
                [x[k] for k in keys])
    return None


def _structure(x):
    """A hashable description of the tree ``x`` (leaves as ``_LEAF``)."""
    node = _children(x)
    if node is None:
        return _LEAF
    kind, keys, kids = node
    return (kind, keys, tuple(_structure(c) for c in kids))


def _leaves(x, out):
    node = _children(x)
    if node is None:
        out.append(x)
    else:
        for c in node[2]:
            _leaves(c, out)
    return out


def _num_leaves(struct) -> int:
    if struct == _LEAF:
        return 1
    return sum(_num_leaves(c) for c in struct[2])


def _build(like, it):
    """``like``'s tree with its leaves taken from iterator ``it``."""
    if like is None:
        return None
    node = _children(like)
    if node is None:
        return next(it)
    kind, keys, kids = node
    vals = [_build(c, it) for c in kids]
    t = type(like)
    if t is list:
        return vals
    if t is tuple:
        return tuple(vals)
    if _is_namedtuple(like):
        return t(*vals)
    if t is collections.OrderedDict:
        return collections.OrderedDict(zip(keys, vals))
    if t is collections.defaultdict:
        return collections.defaultdict(like.default_factory,
                                       zip(keys, vals))
    return dict(zip(keys, vals))


def _up_to(struct_of, x, out):
    """The subtrees of ``x`` at the leaves of ``struct_of``'s tree (``x``
    must have that tree as a prefix)."""
    node = _children(struct_of)
    if node is None:
        out.append(x)
        return out
    xnode = _children(x)
    if xnode is None or xnode[0] != node[0] or xnode[1] != node[1] or \
            len(xnode[2]) != len(node[2]):
        raise ValueError(
            f"map_structure: {_structure(x)!r} does not have the tree "
            f"structure {_structure(struct_of)!r} as a prefix")
    for c, xc in zip(node[2], xnode[2]):
        _up_to(c, xc, out)
    return out


def flatten(nest):
    """Structure-flatten (ref: utils.py flatten): leaves in order."""
    return _leaves(nest, [])


def pack_sequence_as(structure, flat_sequence):
    """ref: utils.py pack_sequence_as."""
    n = _num_leaves(_structure(structure))
    enforce(n == len(flat_sequence),
            f"pack_sequence_as: structure has {n} "
            f"leaves but {len(flat_sequence)} values given",
            InvalidArgumentError)
    return _build(structure, iter(flat_sequence))


def map_structure(func, *structures):
    """ref: utils.py map_structure: func over matching leaves."""
    enforce(structures, "map_structure needs at least one structure",
            InvalidArgumentError)
    first = structures[0]
    cols = [_leaves(first, [])] + [_up_to(first, s, [])
                                   for s in structures[1:]]
    return _build(first, iter([func(*args) for args in zip(*cols)]))


def assert_same_structure(nest1, nest2, check_types=True):
    """ref: utils.py assert_same_structure."""
    t1, t2 = _structure(nest1), _structure(nest2)
    enforce(t1 == t2,
            f"structures differ: {t1} vs {t2}", InvalidArgumentError)
