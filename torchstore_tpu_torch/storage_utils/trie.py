"""Prefix trie over '/'-separated keys.

Port of ``torchstore_tpu/storage_utils/trie.py``: a ``MutableMapping``
whose ``keys()`` view supports ``filter_by_prefix``, the controller's index
under ``keys(prefix)`` listings. A prefix matches whole path segments:
"a/b" holds "a/b" and "a/b/c", not "a/bc".
"""

from __future__ import annotations

from collections.abc import MutableMapping
from typing import Any, Iterator, Optional

_SEP = "/"


class _Node:
    __slots__ = ("children", "value", "has_value")

    def __init__(self) -> None:
        self.children: dict[str, _Node] = {}
        self.value: Any = None
        self.has_value = False


class TrieKeysView:
    """Iterable keys view with prefix filtering (path-segment semantics)."""

    def __init__(self, trie: "Trie", prefix: Optional[str] = None) -> None:
        self._trie = trie
        self._prefix = prefix

    def filter_by_prefix(self, prefix: str) -> "TrieKeysView":
        return TrieKeysView(self._trie, prefix)

    def __iter__(self) -> Iterator[str]:
        yield from self._trie.iter_keys(self._prefix)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __contains__(self, key: object) -> bool:
        if not isinstance(key, str) or key not in self._trie:
            return False
        if self._prefix is None:
            return True
        pre = self._prefix.split(_SEP)
        segs = key.split(_SEP)
        return segs[: len(pre)] == pre


class Trie(MutableMapping):
    def __init__(self) -> None:
        self._root = _Node()
        self._len = 0

    @staticmethod
    def _split(key: str) -> list[str]:
        if not isinstance(key, str):
            raise TypeError(f"trie keys must be str, got {type(key)}")
        return key.split(_SEP)

    def _find(self, key: str) -> Optional[_Node]:
        node = self._root
        for seg in self._split(key):
            node = node.children.get(seg)
            if node is None:
                return None
        return node

    def __getitem__(self, key: str) -> Any:
        node = self._find(key)
        if node is None or not node.has_value:
            raise KeyError(key)
        return node.value

    def __setitem__(self, key: str, value: Any) -> None:
        node = self._root
        for seg in self._split(key):
            node = node.children.setdefault(seg, _Node())
        if not node.has_value:
            self._len += 1
        node.value = value
        node.has_value = True

    def __delitem__(self, key: str) -> None:
        segs = self._split(key)
        path: list[tuple[_Node, str]] = []
        node = self._root
        for seg in segs:
            nxt = node.children.get(seg)
            if nxt is None:
                raise KeyError(key)
            path.append((node, seg))
            node = nxt
        if not node.has_value:
            raise KeyError(key)
        node.has_value = False
        node.value = None
        self._len -= 1
        # Prune now-empty branches.
        for parent, seg in reversed(path):
            child = parent.children[seg]
            if child.has_value or child.children:
                break
            del parent.children[seg]

    def __contains__(self, key: object) -> bool:
        if not isinstance(key, str):
            return False
        node = self._find(key)
        return node is not None and node.has_value

    def __len__(self) -> int:
        return self._len

    def clear(self) -> None:
        self._root = _Node()
        self._len = 0

    def __iter__(self) -> Iterator[str]:
        yield from self.iter_keys(None)

    def iter_keys(self, prefix: Optional[str]) -> Iterator[str]:
        """All keys, or keys under ``prefix``: a key matches when it equals
        the prefix or extends it at a segment boundary."""
        node = self._root
        parts: list[str] = []
        if prefix:
            parts = self._split(prefix)
            for seg in parts:
                node = node.children.get(seg)
                if node is None:
                    return
        stack = [(node, parts)]
        while stack:
            cur, path = stack.pop()
            if cur.has_value:
                yield _SEP.join(path)
            for seg in sorted(cur.children, reverse=True):
                stack.append((cur.children[seg], path + [seg]))

    def keys(self) -> TrieKeysView:  # type: ignore[override]
        return TrieKeysView(self)
