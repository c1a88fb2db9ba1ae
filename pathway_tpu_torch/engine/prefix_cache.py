"""Host-side radix tree over token blocks: which prompt prefixes have KV
resident on the device, and where (a copy of
``pathway_tpu/engine/prefix_cache.py``, plain Python and numpy).

Every answer prompt of a RAG deployment starts with the same system prompt
and template. KV for block-aligned prompt prefixes persists next to the
slot pool, and admission seeds a slot from it instead of recomputing it:
prefill runs only over the uncached suffix.

- ``match``    longest cached block-aligned prefix of a prompt; splits
               mid-edge so the returned node's root-path exactly covers
               the matched blocks (the handle the caller ref-counts).
- ``insert``   extend the tree with a prompt's not-yet-cached full
               blocks, allocating arena ids (evicting if needed); the
               caller copies the slot's freshly-prefilled KV into them
               (``kv_extract``).
- ``acquire``/``release``  ref-count a node's whole root-path while a
               slot is live on it; referenced blocks never evict.
- eviction     LRU over unreferenced leaf edges when the arena free
               list runs dry; the arena's block count is the byte budget.

Insert and evict keep the ``record_prefix`` ledger of
``engine/probes.py`` current; the serving loop accounts hit and miss
tokens at admission.

Under the paged KV pool the tree runs in ADOPTED mode: there is no arena;
cached blocks are the slots' own blocks in the global paged pool, pinned
through the ``pin``/``unpin`` allocator callbacks. ``insert(...,
block_ids=)`` adopts a slot's block-table entries zero-copy, ``n_blocks``
is a budget, and eviction unpins. A hit installs the pinned ids at the
head of the slot's block table (``paged_admit_cached``), copy-on-write:
suffix and decode writes land past the shared run.

TWO-TIER mode (``tier2_blocks`` > 0 and an ``export`` callback): eviction
DEMOTES the dropped edge's KV bytes into a host-RAM block store
(:class:`HostTierStore`) before freeing the device blocks. A later
``match_t2`` finds the demoted continuation of a tier-1 match and hands
the blobs back for asynchronous promotion by the serving loop.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np

from pathway_tpu_torch.engine.probes import record_prefix


class _Node:
    """One radix edge: a run of blocks ``keys`` (token tuples) with their
    arena ids ``blocks``, compressed into a single node. ``refs`` counts
    live slots whose acquired path passes through here (cumulative: an
    ancestor's refs >= the sum over its subtree's holders)."""

    __slots__ = ("keys", "blocks", "children", "parent", "refs", "stamp")

    def __init__(self, parent: "_Node | None",
                 keys: list[tuple[int, ...]], blocks: list[int]):
        self.parent = parent
        self.keys = keys
        self.blocks = blocks
        self.children: dict[tuple[int, ...], _Node] = {}
        self.refs = 0
        self.stamp = 0  # LRU clock at last touch


class HostTierStore:
    """Tier 2: a bounded host-RAM store of demoted radix edges. Entries
    are keyed ``(path, first_block)`` — ``path`` is the tuple of block
    keys from the root to the edge's parent — so a tier-1 match can
    chain straight into its demoted continuation. Values are the edge's
    block keys plus per-channel ``np`` blobs stacked ``(n, ...)`` in the
    ``kv_block_export`` layout. LRU over whole entries: ``take`` pops
    (the blobs are on their way back to the device — a failed promotion
    just loses them), ``put`` evicts oldest-in until the new edge fits.
    Plain host Python, single-threaded by its caller (the serving
    loop)."""

    def __init__(self, n_blocks: int, block_bytes: int):
        self.capacity_blocks = int(n_blocks)
        self.block_bytes = int(block_bytes)
        self._edges: OrderedDict[tuple, tuple[list, dict]] = OrderedDict()
        self._used = 0

    def put(self, path: tuple, keys: list, blobs: dict) -> int:
        """File a demoted edge; returns how many blocks were kept (the
        tail is trimmed if the edge alone exceeds the budget)."""
        if self.capacity_blocks <= 0 or not keys:
            return 0
        if len(keys) > self.capacity_blocks:
            keys = list(keys)[: self.capacity_blocks]
            blobs = {c: v[: self.capacity_blocks] for c, v in blobs.items()}
        key = (tuple(path), keys[0])
        old = self._edges.pop(key, None)
        if old is not None:
            self._used -= len(old[0])
        while self._used + len(keys) > self.capacity_blocks and self._edges:
            _, (old_keys, _) = self._edges.popitem(last=False)
            self._used -= len(old_keys)
        self._edges[key] = (list(keys), blobs)
        self._used += len(keys)
        return len(keys)

    def take(self, path: tuple, want: list) -> tuple[list, dict | None]:
        """Pop the longest stored continuation of ``want`` under
        ``path``, chaining across entries (an edge matched only partway
        re-files its unmatched tail under the deeper path, mirroring the
        tree's mid-edge split). Returns ``(keys, blobs)`` with the blobs
        concatenated along the block axis, or ``([], None)``."""
        path = tuple(path)
        keys_out: list = []
        parts: dict | None = None
        j = 0
        while j < len(want):
            ent = self._edges.pop((path, want[j]), None)
            if ent is None:
                break
            ekeys, eblobs = ent
            self._used -= len(ekeys)
            i = 1  # the dict key IS the first block, so >= 1 matches
            while (i < len(ekeys) and j + i < len(want)
                   and ekeys[i] == want[j + i]):
                i += 1
            if i < len(ekeys):  # re-file the divergent tail
                self.put(path + tuple(ekeys[:i]), ekeys[i:],
                         {c: v[i:] for c, v in eblobs.items()})
            keys_out.extend(ekeys[:i])
            if parts is None:
                parts = {c: [] for c in eblobs}
            for c in eblobs:
                parts[c].append(eblobs[c][:i])
            path = path + tuple(ekeys[:i])
            j += i
            if i < len(ekeys):
                break  # diverged mid-edge — nothing deeper can match
        if not keys_out:
            return [], None
        blobs = {c: (v[0] if len(v) == 1 else np.concatenate(v, axis=0))
                 for c, v in parts.items()}
        return keys_out, blobs

    def clear(self) -> None:
        self._edges.clear()
        self._used = 0

    @property
    def used_blocks(self) -> int:
        return self._used

    def stats(self) -> dict:
        return {
            "capacity_blocks": self.capacity_blocks,
            "used_blocks": self._used,
            "edges": len(self._edges),
            "cached_bytes": self._used * self.block_bytes,
        }


class PrefixCache:
    """Radix prefix cache over ``n_blocks`` arena slots of ``block``
    tokens each. ``block_bytes`` is the device footprint of ONE block's
    K+V across all layers — only used for the bytes ledger; capacity is
    enforced in blocks (the arena is preallocated, so the byte budget is
    exact by construction). ``tier2_blocks`` > 0 plus an ``export``
    callback (block ids -> per-channel host ``np`` blobs) turns eviction
    into demotion — see :class:`HostTierStore`."""

    def __init__(self, *, n_blocks: int, block: int, block_bytes: int,
                 pin=None, unpin=None, tier2_blocks: int = 0, export=None):
        self.block = int(block)
        self.block_bytes = int(block_bytes)
        self.capacity_blocks = int(n_blocks)
        self._root = _Node(None, [], [])
        # ADOPTED mode (paged pool): no private arena — cached ids are
        # global pool blocks held alive through the pin/unpin refcount
        # callbacks (BlockAllocator.pin / .release); n_blocks is a
        # budget, tracked by self._used.
        self._pin = pin
        self._unpin = unpin
        self._adopted = pin is not None
        if self._adopted and unpin is None:
            raise ValueError("adopted mode needs both pin and unpin")
        self._used = 0
        # pop() takes from the tail: reversed so low ids allocate first
        # (deterministic layouts make the tests' arena assertions exact)
        self._free = [] if self._adopted else list(range(int(n_blocks)))[::-1]
        self._clock = 0
        self._export = export
        self.tier2 = (HostTierStore(int(tier2_blocks), int(block_bytes))
                      if int(tier2_blocks) > 0 and export is not None
                      else None)

    # -- tree internals ------------------------------------------------

    def _tick(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    def _block_keys(self, tokens: Sequence[int],
                    n_blocks: int) -> list[tuple[int, ...]]:
        B = self.block
        return [tuple(tokens[i * B:(i + 1) * B]) for i in range(n_blocks)]

    def _path_keys(self, node: _Node) -> list[tuple[int, ...]]:
        """The block keys on ``node``'s root-path, root-first — the
        tier-2 store's addressing for everything below ``node``."""
        runs, n = [], node
        while n is not None:
            runs.append(n.keys)
            n = n.parent
        out: list[tuple[int, ...]] = []
        for ks in reversed(runs):
            out.extend(ks)
        return out

    def _split(self, node: _Node, i: int) -> _Node:
        """Split ``node``'s edge before block ``i`` (0 < i < len(keys)):
        the TOP half is a NEW node spliced between parent and ``node``;
        ``node`` keeps its identity (and children, and holders — whose
        acquired paths all pass through the new top, so it inherits the
        cumulative ref count). Returns the top half."""
        top = _Node(node.parent, node.keys[:i], node.blocks[:i])
        top.refs = node.refs
        top.stamp = node.stamp
        node.parent.children[top.keys[0]] = top
        top.children[node.keys[i]] = node
        node.parent = top
        node.keys = node.keys[i:]
        node.blocks = node.blocks[i:]
        return top

    # -- public API ----------------------------------------------------

    def match(self, tokens: Sequence[int]) -> tuple[int, list[int], _Node]:
        """Longest cached block-aligned prefix of ``tokens``. Returns
        ``(n_blocks, arena_ids, node)`` where ``node``'s root-path covers
        exactly the matched blocks (mid-edge matches split the edge so
        the handle is exact). Touches LRU stamps along the path."""
        want = self._block_keys(tokens, len(tokens) // self.block)
        node, ids, j = self._root, [], 0
        while j < len(want):
            child = node.children.get(want[j])
            if child is None:
                break
            i = 0
            while (i < len(child.keys) and j + i < len(want)
                   and child.keys[i] == want[j + i]):
                i += 1
            if i == 0:  # defensive: children are keyed by their first block
                break
            if i < len(child.keys):
                child = self._split(child, i)
            ids.extend(child.blocks)
            j += i
            node = child
            self._tick(node)
        return j, ids, node

    def match_t2(self, tokens: Sequence[int], n_blocks: int, node: _Node,
                 j: int) -> tuple[list, dict] | None:
        """Tier-2 continuation of a tier-1 ``match`` that stopped at
        block ``j`` on ``node``: pop the demoted blobs covering blocks
        ``[j, j + k)`` of the prompt's first ``n_blocks``. Returns
        ``(keys, blobs)`` for the caller to promote (re-insert + h2d
        scatter), or None. The entries leave the store either way —
        promotion owns them now."""
        if self.tier2 is None or j >= n_blocks:
            return None
        want = self._block_keys(tokens, n_blocks)[j:]
        keys, blobs = self.tier2.take(tuple(self._path_keys(node)), want)
        if not keys:
            return None
        record_prefix("t2_hit_blocks", len(keys))
        return keys, blobs

    def acquire(self, node: _Node) -> None:
        """Pin ``node``'s whole root-path against eviction (a slot is
        live on this prefix)."""
        n = node
        while n is not None:
            n.refs += 1
            n = n.parent

    def release(self, node: _Node) -> None:
        n = node
        while n is not None:
            n.refs -= 1
            n = n.parent

    def insert(self, tokens: Sequence[int], n_blocks: int | None = None,
               block_ids: Sequence[int] | None = None,
               ) -> tuple[_Node, int, list[int]]:
        """Ensure the first ``n_blocks`` full blocks of ``tokens`` are in
        the tree. Returns ``(node, first_new, new_ids)``: the deepest
        node now covering the prompt's cached prefix, the block index
        where the newly-allocated run starts, and its arena ids — the
        caller must copy the slot's KV spans into them (``kv_extract``).
        Allocation evicts LRU unreferenced leaves when the free list is
        dry; if the arena is exhausted the tail is simply not cached
        (``new_ids`` comes back short, or empty).

        ADOPTED mode instead takes ``block_ids`` — the slot's block-table
        ids covering blocks ``[0, n_blocks)`` of the prompt — and pins
        ``block_ids[first_new:n_blocks]`` into the tree zero-copy; the
        budget evicts cold edges (unpinning them) to make room, and the
        tail is dropped if the budget still doesn't stretch."""
        if n_blocks is None:
            n_blocks = len(tokens) // self.block
        j, _, node = self.match(tokens[: n_blocks * self.block])
        if j >= n_blocks:
            return node, j, []
        want = self._block_keys(tokens, n_blocks)[j:]
        if self._adopted:
            if block_ids is None:
                raise ValueError(
                    "adopted-mode insert needs the slot's block ids"
                )
            adopt = list(block_ids)[j:n_blocks]
            while self._used + len(adopt) > self.capacity_blocks:
                if not self._evict_one(node):
                    adopt = adopt[: max(0, self.capacity_blocks
                                        - self._used)]
                    break
            if not adopt:
                return node, j, []
            self._pin(adopt)
            self._used += len(adopt)
            new_ids = adopt
        else:
            new_ids = []
            for _ in want:
                a = self._alloc(protect=node)
                if a is None:
                    break
                new_ids.append(a)
        if not new_ids:
            return node, j, []
        child = _Node(node, want[: len(new_ids)], new_ids)
        node.children[want[0]] = child
        self._tick(child)
        record_prefix("inserted_blocks", len(new_ids))
        record_prefix("cached_bytes", len(new_ids) * self.block_bytes)
        return child, j, new_ids

    def _alloc(self, protect: _Node) -> int | None:
        if not self._free and not self._evict_one(protect):
            return None
        return self._free.pop()

    def _evict_one(self, protect: _Node) -> bool:
        """Drop the LRU unreferenced leaf EDGE (whole node — a long cold
        tail frees in one step). Never touches the root, referenced
        nodes, interior nodes, or ``protect``'s own root-path (the
        in-progress insertion point)."""
        protected = set()
        n = protect
        while n is not None:
            protected.add(id(n))
            n = n.parent
        best, stack = None, [self._root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if (nd is self._root or nd.children or nd.refs > 0
                    or id(nd) in protected):
                continue
            if best is None or nd.stamp < best.stamp:
                best = nd
        if best is None:
            return False
        del best.parent.children[best.keys[0]]
        if self.tier2 is not None:
            # demote before freeing: device bytes are still the edge's
            # KV until the block ids are reused
            blobs = self._export(list(best.blocks))
            kept = self.tier2.put(tuple(self._path_keys(best.parent)),
                                  list(best.keys), blobs)
            record_prefix("t2_demoted_blocks", kept)
        if self._adopted:
            self._unpin(best.blocks)
            self._used -= len(best.blocks)
        else:
            self._free.extend(best.blocks)
        record_prefix("evicted_blocks", len(best.blocks))
        record_prefix("cached_bytes", -len(best.blocks) * self.block_bytes)
        return True

    def reset(self) -> None:
        """Drop the whole tree. ADOPTED mode unpins every cached block
        back into the global allocator — only call with no live refs
        (e.g. the bench's between-arm reset); arena mode returns every
        block to the private free list."""
        blocks, stack = [], list(self._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            blocks.extend(nd.blocks)
        if blocks:
            if self._adopted:
                self._unpin(blocks)
                self._used = 0
            else:
                self._free.extend(blocks)
            record_prefix("evicted_blocks", len(blocks))
            record_prefix("cached_bytes", -len(blocks) * self.block_bytes)
        self._root = _Node(None, [], [])
        if self.tier2 is not None:
            self.tier2.clear()

    # -- observability ---------------------------------------------------

    @property
    def used_blocks(self) -> int:
        if self._adopted:
            return self._used
        return self.capacity_blocks - len(self._free)

    def stats(self) -> dict:
        out = {
            "capacity_blocks": self.capacity_blocks,
            "used_blocks": self.used_blocks,
            "cached_bytes": self.used_blocks * self.block_bytes,
            "block": self.block,
        }
        if self.tier2 is not None:
            out["tier2"] = self.tier2.stats()
        return out
