"""The port's key trie against the JAX package's on the same keys: the seven
cases of tests/test_trie.py, each run through both classes with equal
results (exact), and the controller index's prefix listing over it."""

import pytest

from torchstore_tpu.storage_utils.trie import Trie as RefTrie
from torchstore_tpu_torch.metadata.index_core import IndexCore
from torchstore_tpu_torch.storage_utils.trie import Trie

BOTH = pytest.mark.parametrize("cls", [Trie, RefTrie], ids=["port", "jax"])


def run_both(case):
    """``case(cls)`` for the port's trie and the JAX package's; equal."""
    port, ref = case(Trie), case(RefTrie)
    assert port == ref
    return port


def test_basic_mapping():
    def case(cls):
        t = cls()
        t["a/b/c"] = 1
        t["a/b"] = 2
        t["x"] = 3
        out = [t["a/b/c"], t["a/b"], len(t), "a/b" in t, "a" not in t]
        del t["a/b"]
        out += ["a/b" not in t, t["a/b/c"], len(t)]
        return out

    assert run_both(case) == [1, 2, 3, True, True, True, 1, 2]


@BOTH
def test_missing_key(cls):
    t = cls()
    with pytest.raises(KeyError):
        t["nope"]
    with pytest.raises(KeyError):
        del t["nope"]
    t["a/b"] = 1
    with pytest.raises(KeyError):
        del t["a"]  # an interior node holds no value


def test_overwrite():
    def case(cls):
        t = cls()
        t["k"] = 1
        t["k"] = 2
        return t["k"], len(t)

    assert run_both(case) == (2, 1)


def test_prefix_listing():
    def case(cls):
        t = cls()
        for k in ["sd/v0/layer1", "sd/v0/layer2", "sd/v1/layer1", "other"]:
            t[k] = True
        return (sorted(t.keys().filter_by_prefix("sd/v0")),
                sorted(t.keys().filter_by_prefix("sd")),
                list(t.keys().filter_by_prefix("nothing")),
                sorted(t.keys()), len(t.keys().filter_by_prefix("sd")))

    v0, sd, nothing, every, n = run_both(case)
    assert v0 == ["sd/v0/layer1", "sd/v0/layer2"]
    assert sd == ["sd/v0/layer1", "sd/v0/layer2", "sd/v1/layer1"]
    assert nothing == [] and n == 3
    assert every == sorted(["sd/v0/layer1", "sd/v0/layer2", "sd/v1/layer1", "other"])


def test_prefix_is_segment_wise():
    def case(cls):
        t = cls()
        t["ab/c"] = 1
        t["abc/d"] = 2
        view = t.keys().filter_by_prefix("ab")
        return list(view), "abc/d" in view, "ab/c" in view

    assert run_both(case) == (["ab/c"], False, True)


def test_exact_key_in_prefix_listing():
    def case(cls):
        t = cls()
        t["a"] = 1
        t["a/b"] = 2
        return sorted(t.keys().filter_by_prefix("a"))

    assert run_both(case) == ["a", "a/b"]


def test_pruning_keeps_siblings():
    def case(cls):
        t = cls()
        t["a/b/c"] = 1
        t["a/b/d"] = 2
        del t["a/b/c"]
        return list(t.keys()), list(t.items())

    assert run_both(case) == (["a/b/d"], [("a/b/d", 2)])


def test_many_keys_iterate_in_the_same_order_and_clear():
    keys = [f"policy/v{v}/layers.{i}.{p}" for v in range(3) for i in range(12)
            for p in ("w", "b")] + ["policy/v0", "x", "policy/LATEST"]

    def case(cls):
        t = cls()
        for n, k in enumerate(keys):
            t[k] = n
        for k in keys[::5]:
            del t[k]
        listed = (list(t), list(t.keys().filter_by_prefix("policy/v1")), len(t))
        t.clear()
        return listed, len(t), list(t)

    listed, n, after = run_both(case)
    assert n == 0 and after == []
    assert listed[2] == len(keys) - len(keys[::5])


def test_index_lists_keys_by_whole_segments():
    core = IndexCore()
    for key in ["policy/v1/w", "policy/v10/w", "policy/v1", "other/w"]:
        core.index[key] = {}
    assert core.keys_list("policy/v1") == ["policy/v1", "policy/v1/w"]
    assert core.keys_list("policy") == ["policy/v1", "policy/v1/w", "policy/v10/w"]
    assert core.keys_list() == ["other/w", "policy/v1", "policy/v1/w", "policy/v10/w"]
    assert core.keys_list("nothing") == []
