"""Balanced tree (randomized treap) for the O(log n) evictor (paper §4.4-4.5).

Keys are (weight_key: float, uid: int) pairs — the uid breaks ties so keys
are unique.  Supports insert / delete / min / len, each O(log n) expected.

Iterative implementations (no recursion) so 100K+ block caches — the paper's
"offloading to CPU memory" regime — don't hit Python's recursion limit.
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

Key = Tuple[float, int]


class _Node:
    __slots__ = ("key", "prio", "left", "right")

    def __init__(self, key: Key, prio: float):
        self.key = key
        self.prio = prio
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


class Treap:
    """The balanced tree of Algorithm 1 (paper §4.4–4.5): one per Eq.-9
    segment, keyed by the time-invariant ``FreqParams.key1``/``key2``
    (Eq. 8 makes the per-segment ranking constant over time, so the tree
    never rebalances on clock advance).  EVICT only ever reads
    :meth:`min`; insert/delete/min are O(log n) expected — the Table-2
    complexity bound."""

    def __init__(self, seed: int = 0):
        self._root: Optional[_Node] = None
        self._rng = random.Random(seed)
        self._size = 0
        # spine steps across merge/split/delete/min — the per-op work a
        # balanced tree does, O(log n) expected each.  The control-plane
        # stress benchmark reads this (via the evictor/block manager) to
        # gate evictor cost sublinear in resident sessions.
        self.n_ops = 0

    def __len__(self) -> int:
        return self._size

    # -- split/merge core ---------------------------------------------------
    def _merge(self, a: Optional[_Node], b: Optional[_Node]) -> Optional[_Node]:
        """Merge treaps where all keys in a < all keys in b (iterative)."""
        if a is None:
            return b
        if b is None:
            return a
        # iterative merge along the spine
        dummy = _Node((0.0, 0), 0.0)
        cur = dummy
        attach_left = True  # which child of `cur` to attach result to

        def attach(node):
            nonlocal cur, attach_left
            if attach_left:
                cur.left = node
            else:
                cur.right = node

        while a is not None and b is not None:
            self.n_ops += 1
            if a.prio > b.prio:
                attach(a)
                cur, attach_left = a, False
                a = a.right
            else:
                attach(b)
                cur, attach_left = b, True
                b = b.left
        attach(a if a is not None else b)
        return dummy.left

    def _split(self, node: Optional[_Node], key: Key):
        """Split into (< key, >= key), iterative."""
        left_dummy = _Node((0.0, 0), 0.0)
        right_dummy = _Node((0.0, 0), 0.0)
        lcur, rcur = left_dummy, right_dummy
        while node is not None:
            self.n_ops += 1
            if node.key < key:
                lcur.right = node
                lcur = node
                node = node.right
            else:
                rcur.left = node
                rcur = node
                node = node.left
        lcur.right = None
        rcur.left = None
        return left_dummy.right, right_dummy.left

    # -- public ops ----------------------------------------------------------
    def insert(self, weight: float, uid: int) -> None:
        key = (weight, uid)
        node = _Node(key, self._rng.random())
        left, right = self._split(self._root, key)
        self._root = self._merge(self._merge(left, node), right)
        self._size += 1

    def delete(self, weight: float, uid: int) -> bool:
        key = (weight, uid)
        parent, cur, is_left = None, self._root, True
        while cur is not None and cur.key != key:
            self.n_ops += 1
            parent = cur
            if key < cur.key:
                cur, is_left = cur.left, True
            else:
                cur, is_left = cur.right, False
        if cur is None:
            return False
        merged = self._merge(cur.left, cur.right)
        if parent is None:
            self._root = merged
        elif is_left:
            parent.left = merged
        else:
            parent.right = merged
        self._size -= 1
        return True

    def min(self) -> Optional[Key]:
        cur = self._root
        if cur is None:
            return None
        while cur.left is not None:
            self.n_ops += 1
            cur = cur.left
        return cur.key

    def validate(self) -> bool:
        """Check BST + heap invariants (tests only; O(n))."""
        ok = True
        stack = [(self._root, None, None)]
        count = 0
        while stack:
            node, lo, hi = stack.pop()
            if node is None:
                continue
            count += 1
            if lo is not None and not (node.key > lo):
                ok = False
            if hi is not None and not (node.key < hi):
                ok = False
            for child in (node.left, node.right):
                if child is not None and child.prio > node.prio:
                    ok = False
            stack.append((node.left, lo, node.key))
            stack.append((node.right, node.key, hi))
        return ok and count == self._size
