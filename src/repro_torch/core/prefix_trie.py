"""Token-level radix trie for cross-request prefix sharing.

The trie indexes the token sequences of previously served requests so a
new request can discover the longest prompt prefix some earlier request
already pushed through the engine.  It is deliberately *residency
agnostic*: it stores tokens only, never slots.  The block manager's
chain-hash table stays the single source of truth for which blocks are
resident — a trie match is turned into device pages by recomputing chain
hashes over the matched tokens and looking them up, so stale trie paths
(whose blocks were since evicted) degrade gracefully into ordinary cache
misses instead of dangling slot references.

Two queries matter:

* ``match(tokens)`` — longest common prefix between the query and ANY
  stored sequence, measured in tokens (may end mid-edge: a stored
  ``A B C D`` and query ``A B X`` match 2).  Full blocks inside the
  match resolve through the hash table as usual; the *partial* trailing
  block is the copy-on-write case.
* ``completions(match, need)`` — candidate continuations of the matched
  prefix along stored paths.  A divergent request needs them to
  reconstruct the *donor's* chain hash for the block containing the
  divergence point: the donor block's K/V for the common positions are
  exactly reusable (causality: K/V at position p depends only on tokens
  ≤ p), so the block manager can fork (page-copy) it and the requester
  recomputes only from the divergence point on.

Memory is bounded by ``max_tokens`` stored edge tokens; crossing the
budget resets the index (the block cache itself is unaffected — only
future partial-block matches are lost until the trie repopulates).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


@dataclass
class _Node:
    edge: Tuple[int, ...]                        # label on edge from parent
    children: Dict[int, "_Node"] = field(default_factory=dict)


@dataclass
class PrefixMatch:
    """Result of :meth:`PrefixTrie.match` (a cursor into the trie)."""
    length: int                                  # tokens matched
    node: Optional[_Node] = None                 # node whose edge we ended on
    edge_off: int = 0                            # tokens of node.edge consumed

    @property
    def mid_edge(self) -> bool:
        return self.node is not None and self.edge_off < len(self.node.edge)


class PrefixTrie:
    def __init__(self, max_tokens: int = 4_000_000):
        self.root = _Node(edge=())
        self.max_tokens = max_tokens
        self.stored_tokens = 0
        self.n_sequences = 0
        self.n_resets = 0
        # nodes stepped through by insert/match walks — gated sublinear
        # per scheduled step by benchmarks/control_plane_stress.py
        self.n_nodes_visited = 0

    # ------------------------------------------------------------------
    def insert(self, tokens) -> None:
        """Register a served token sequence (idempotent for prefixes)."""
        tokens = tuple(tokens)
        if not tokens:
            return
        if self.stored_tokens > self.max_tokens:
            self.root = _Node(edge=())
            self.stored_tokens = 0
            self.n_resets += 1
        node = self.root
        pos = 0
        while pos < len(tokens):
            self.n_nodes_visited += 1
            child = node.children.get(tokens[pos])
            if child is None:
                leaf = _Node(edge=tokens[pos:])
                node.children[tokens[pos]] = leaf
                self.stored_tokens += len(leaf.edge)
                break
            common = 0
            edge = child.edge
            limit = min(len(edge), len(tokens) - pos)
            while common < limit and edge[common] == tokens[pos + common]:
                common += 1
            if common == len(edge):                 # full edge match: descend
                pos += common
                node = child
                continue
            # split the edge at the divergence point
            split = _Node(edge=edge[:common], children={edge[common]: child})
            child.edge = edge[common:]
            node.children[tokens[pos]] = split
            rest = tokens[pos + common:]
            if rest:
                split.children[rest[0]] = _Node(edge=rest)
                self.stored_tokens += len(rest)
            break
        self.n_sequences += 1

    # ------------------------------------------------------------------
    def match(self, tokens) -> PrefixMatch:
        """Longest common prefix (in tokens) with any stored sequence."""
        node = self.root
        pos = 0
        n = len(tokens)
        while pos < n:
            self.n_nodes_visited += 1
            child = node.children.get(tokens[pos])
            if child is None:
                return PrefixMatch(length=pos, node=node,
                                   edge_off=len(node.edge))
            edge = child.edge
            k = 0
            limit = min(len(edge), n - pos)
            while k < limit and edge[k] == tokens[pos + k]:
                k += 1
            pos += k
            if k < len(edge):                       # diverged / query exhausted
                return PrefixMatch(length=pos, node=child, edge_off=k)
            node = child
        return PrefixMatch(length=pos, node=node, edge_off=len(node.edge))

    # ------------------------------------------------------------------
    def completions(self, pm: PrefixMatch, need: int,
                    limit: int = 4) -> Iterator[Tuple[int, ...]]:
        """Up to ``limit`` stored continuations of ``pm``, each exactly
        ``need`` tokens long (shorter dead-end paths are skipped)."""
        if pm.node is None or need <= 0:
            return
        yielded = 0
        # (node, tokens already taken from node.edge, accumulated suffix)
        stack: List[Tuple[_Node, int, Tuple[int, ...]]] = [
            (pm.node, pm.edge_off, ())]
        while stack and yielded < limit:
            node, off, acc = stack.pop()
            take = node.edge[off:off + (need - len(acc))]
            acc = acc + tuple(take)
            if len(acc) == need:
                yielded += 1
                yield acc
                continue
            for child in node.children.values():
                stack.append((child, 0, acc))

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self.n_sequences

    def n_nodes(self) -> int:
        count = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            count += 1
            stack.extend(n.children.values())
        return count
