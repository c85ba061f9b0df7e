"""Trees of nested containers without JAX: JAX's flattening order, its key
paths, and its ``PyTreeDef`` protobuf (``serialize_using_proto``).

A checkpoint's ``meta.json`` records its tree's structure as the hex of
``jax.tree_util.tree_structure(tree).serialize_using_proto()``, and its
``tree_digest`` hashes each leaf's key path as JAX prints it. This module
reproduces both for the node kinds checkpoint trees use, so the port reads
and writes the reference's artifacts byte for byte:

* a ``dict`` with ``str`` keys (children in sorted key order), a ``list``
  and a ``tuple`` (children by index), ``None`` (a node with no children);
* anything else is a leaf (a tensor, an array, a number).

The protobuf: the outer message repeats field 1, one node per entry in
post-order, then field 2, the dict keys interned in the order the nodes
first use them. A node holds its arity (field 1, left out when 0), its kind
(field 2: 1 leaf, 2 list, 3 None, 4 tuple, 5 dict) and, for a non-empty
dict, field 3: a message whose field 1 packs the indices of its keys in the
interned strings. JAX refuses to serialise other node kinds (named tuples,
ordered dicts, registered classes); :func:`decode` raises on any kind, field
or wire type it does not know.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

LEAF, LIST, NONE, TUPLE, DICT = 1, 2, 3, 4, 5


@dataclasses.dataclass(frozen=True)
class DictKey:
    """A dict entry of a key path; prints as JAX's ``DictKey(key='a')``."""
    key: str


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    """A list or tuple entry; prints as JAX's ``SequenceKey(idx=0)``."""
    idx: int


def _children(node) -> List[Tuple[Any, Any]]:
    """(key-path entry, child) of a container node, in JAX's order."""
    if isinstance(node, dict):
        if not all(isinstance(k, str) for k in node):
            raise TypeError(f"dict keys must be str, got "
                            f"{sorted(type(k).__name__ for k in node)}")
        return [(DictKey(k), node[k]) for k in sorted(node)]
    return [(SequenceKey(i), c) for i, c in enumerate(node)]


def _is_node(x) -> bool:
    if type(x) in (dict, list, tuple) or x is None:
        return True
    if isinstance(x, (dict, list, tuple)):
        raise TypeError(f"a {type(x).__name__} node: JAX's proto holds "
                        f"dict, list, tuple and None nodes only")
    return False


def leaves_with_path(tree) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf)]`` in JAX's flattening order; ``str(path)`` is what
    ``jax.tree_util.tree_leaves_with_path`` prints."""
    out: List[Tuple[tuple, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if not _is_node(node):
            out.append((path, node))
            return
        for key, child in _children(node):
            walk(child, path + (key,))
    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if tree is None:
        return None
    if type(tree) is dict:
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(tree_map(fn, c) for c in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _len_field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _int_field(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value) if value else b""


def encode(tree) -> bytes:
    """``tree``'s structure as JAX's ``serialize_using_proto`` writes it."""
    nodes: List[bytes] = []
    strings: List[str] = []
    index = {}

    def walk(node):
        if not _is_node(node):
            nodes.append(_int_field(2, LEAF))
            return
        if node is None:
            nodes.append(_int_field(2, NONE))
            return
        kids = _children(node)
        for _, child in kids:
            walk(child)
        kind = DICT if type(node) is dict else (
            LIST if type(node) is list else TUPLE)
        body = _int_field(1, len(kids)) + _int_field(2, kind)
        if kind == DICT and kids:
            for key, _ in kids:
                if key.key not in index:
                    index[key.key] = len(strings)
                    strings.append(key.key)
            packed = b"".join(_varint(index[key.key]) for key, _ in kids)
            body += _len_field(3, _len_field(1, packed))
        nodes.append(body)
    walk(tree)
    return (b"".join(_len_field(1, n) for n in nodes)
            + b"".join(_len_field(2, s.encode()) for s in strings))


def _fields(data: bytes):
    """``(field number, wire type, value)`` of each field of a message:
    value an int for varints, bytes for length-delimited fields."""
    pos = 0

    def varint():
        nonlocal pos
        shift = value = 0
        while True:
            if pos >= len(data):
                raise ValueError("treedef: truncated varint")
            b = data[pos]
            pos += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return value
    while pos < len(data):
        tag = varint()
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            yield num, wire, varint()
        elif wire == 2:
            n = varint()
            if pos + n > len(data):
                raise ValueError("treedef: truncated field")
            yield num, wire, data[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"treedef: wire type {wire} of field {num} is "
                             f"not in JAX's PyTreeDef proto")


def _unpack_varints(data: bytes) -> List[int]:
    out, shift, value = [], 0, 0
    for b in data:
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            out.append(value)
            shift = value = 0
    if shift:
        raise ValueError("treedef: truncated packed varint")
    return out


def decode(data: bytes) -> List[Tuple[int, int, Tuple[str, ...]]]:
    """The nodes of a serialised ``PyTreeDef``, post-order, as
    ``(kind, arity, dict keys)``. Raises on what JAX's proto for these node
    kinds does not hold."""
    raw_nodes, strings = [], []
    for num, wire, value in _fields(data):
        if wire != 2 or num not in (1, 2):
            raise ValueError(f"treedef: unexpected field {num} (wire {wire})")
        if num == 1:
            raw_nodes.append(value)
        else:
            strings.append(value.decode())
    nodes = []
    for raw in raw_nodes:
        arity, kind, key_ids = 0, 0, []
        for num, wire, value in _fields(raw):
            if num == 1 and wire == 0:
                arity = value
            elif num == 2 and wire == 0:
                kind = value
            elif num == 3 and wire == 2:
                for sub, sub_wire, ids in _fields(value):
                    if sub != 1:
                        raise ValueError(f"treedef: dict keys field {sub}")
                    key_ids += (_unpack_varints(ids) if sub_wire == 2
                                else [ids])
            else:
                raise ValueError(f"treedef: node field {num} (wire {wire}) "
                                 f"is not one this codec knows")
        if kind not in (LEAF, LIST, NONE, TUPLE, DICT):
            raise ValueError(f"treedef: node kind {kind} is not one this "
                             f"codec knows (1 leaf, 2 list, 3 None, 4 tuple, "
                             f"5 dict)")
        if kind in (LEAF, NONE) and arity:
            raise ValueError(f"treedef: a node of kind {kind} with arity "
                             f"{arity}")
        if kind != DICT and key_ids:
            raise ValueError("treedef: dict keys on a node that is not a "
                             "dict")
        if kind == DICT and len(key_ids) != arity:
            raise ValueError(f"treedef: a dict of arity {arity} with "
                             f"{len(key_ids)} keys")
        if any(i >= len(strings) for i in key_ids):
            raise ValueError("treedef: a dict key index past the strings")
        nodes.append((kind, arity, tuple(strings[i] for i in key_ids)))
    return nodes


_END = object()


def unflatten(data: bytes, leaf_values) -> Any:
    """The tree a serialised ``PyTreeDef`` describes, its leaves taken in
    order from ``leaf_values``; raises if their number does not fit."""
    it = iter(leaf_values)
    stack: list = []
    n_leaves = 0
    for kind, arity, keys in decode(data):
        if kind == LEAF:
            try:
                stack.append(next(it))
            except StopIteration:
                raise ValueError("treedef: fewer leaves than the structure "
                                 "holds") from None
            n_leaves += 1
            continue
        if kind == NONE:
            stack.append(None)
            continue
        if arity > len(stack):
            raise ValueError("treedef: a node with more children than the "
                             "nodes before it")
        kids = stack[len(stack) - arity:]
        del stack[len(stack) - arity:]
        stack.append(dict(zip(keys, kids)) if kind == DICT
                     else list(kids) if kind == LIST else tuple(kids))
    if len(stack) != 1:
        raise ValueError(f"treedef: {len(stack)} roots")
    if next(it, _END) is not _END:
        raise ValueError(f"treedef: more leaves than the {n_leaves} the "
                         f"structure holds")
    return stack[0]
