"""The port's page pool and prefix tree (``repro_torch.core.paging``, a
copy of the JAX package's module): the JAX package's PagePool/PrefixTree
properties run against the copy, and random operation streams leave both
modules in the same state (same pages handed out, same refcounts).
"""
import numpy as np
import pytest

from _hyp import given, settings, st  # optional dep: skips when absent
from repro.core import paging as jpaging
from repro_torch.core import paging as tpaging
from repro_torch.core.paging import (
    TRASH_PAGE,
    PagePool,
    PrefixTree,
    build_row_table,
    pages_for,
)


def _tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(np.int32)


class TestPagePool:
    def test_alloc_fork_free_refcounts(self):
        pool = PagePool(8, 4)
        a = pool.alloc(3)
        assert pool.pages_in_use == 4  # 3 + pinned trash
        assert all(pool.refcount(p) == 1 for p in a)
        pool.fork(a)
        assert all(pool.refcount(p) == 2 for p in a)
        assert pool.free(a) == []  # refs drop to 1: nothing released
        assert sorted(pool.free(a)) == sorted(a)
        pool.check()
        assert pool.pages_in_use == 1  # only the trash page

    def test_double_free_raises(self):
        pool = PagePool(8, 4)
        a = pool.alloc(2)
        pool.free(a)
        with pytest.raises(ValueError, match="double free"):
            pool.free(a)
        pool.check()

    def test_trash_page_is_pinned(self):
        pool = PagePool(8, 4)
        assert TRASH_PAGE not in pool.alloc(pool.capacity)
        with pytest.raises(ValueError):
            pool.free([TRASH_PAGE])
        with pytest.raises(ValueError):
            pool.fork([TRASH_PAGE])

    def test_exhaustion_is_atomic(self):
        pool = PagePool(8, 4)
        pool.alloc(5)
        before = pool.pages_free
        with pytest.raises(MemoryError):
            pool.alloc(3)  # only 2 free
        assert pool.pages_free == before  # nothing leaked
        pool.check()

    def test_fork_with_a_dead_page_raises_and_changes_nothing(self):
        pool = PagePool(8, 4)
        a = pool.alloc(2)
        dead = pool.alloc(1)
        pool.free(dead)
        with pytest.raises(ValueError, match="dead page"):
            pool.fork(a + dead)
        assert [pool.refcount(p) for p in a] == [1, 1]  # the live pages kept
        assert pool.stats.pages_reused == 0
        pool.check()

    def test_check_catches_broken_accounting(self):
        """``check`` runs after every scheduler tick: a page both free and
        referenced, or a free list holding a page twice, trips it."""
        pool = PagePool(8, 4)
        pool.alloc(2)
        pool.check()
        pool._refs[pool._free[0]] = 1  # a free page that is referenced
        with pytest.raises(AssertionError, match="refcount map"):
            pool.check()
        pool = PagePool(8, 4)
        pool._free[-1] = pool._free[-2]  # one page listed twice, one lost
        with pytest.raises(AssertionError, match="free list corrupt"):
            pool.check()

    @staticmethod
    def _run_ops(ops, module, num_pages=16):
        """Interpret an (op, idx) stream against a pool, checking the
        accounting invariant after every operation; returns the trace of
        pages handed out and the final refcounts."""
        pool = module.PagePool(num_pages, 4)
        held, trace = [], []
        for kind, idx in ops:
            if kind == 0:
                try:
                    held.append(pool.alloc(1 + idx % 3))
                    trace.append(tuple(held[-1]))
                except MemoryError:
                    trace.append("oom")
            elif kind == 1 and held:
                pages = held[idx % len(held)]
                pool.fork(pages)
                held.append(list(pages))
            elif kind == 2 and held:
                trace.append(tuple(pool.free(held.pop(idx % len(held)))))
            pool.check()
            assert pool.pages_in_use + pool.pages_free == pool.num_pages
        refs = [pool.refcount(p) for p in range(num_pages)]
        for pages in held:
            pool.free(pages)
        pool.check()
        assert pool.pages_in_use == 1  # everything returned except trash
        return trace, refs

    @pytest.mark.parametrize("seed", range(10))
    def test_random_ops_keep_invariant(self, seed):
        """No sequence of alloc/fork/free can double-free or leak."""
        rng = np.random.default_rng(seed)
        ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 64))) for _ in range(60)]
        self._run_ops(ops, tpaging)

    @pytest.mark.parametrize("seed", range(4))
    def test_same_state_as_jax_pool(self, seed):
        """The copy hands out the same pages in the same order as the JAX
        package's pool and ends with the same refcounts."""
        rng = np.random.default_rng(100 + seed)
        ops = [(int(rng.integers(0, 3)), int(rng.integers(0, 64))) for _ in range(80)]
        assert self._run_ops(ops, tpaging) == self._run_ops(ops, jpaging)

    @given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 63)), max_size=80))
    @settings(max_examples=40, deadline=None)
    def test_random_ops_keep_invariant_hyp(self, ops):
        assert self._run_ops(ops, tpaging) == self._run_ops(ops, jpaging)


class TestPrefixTree:
    def test_fork_then_free_leaves_shared_pages_live(self):
        """A slot retiring must not kill pages the tree (or another slot)
        still references."""
        pool = PagePool(32, 4)
        tree = PrefixTree(pool)
        toks = _tokens(16, seed=1)  # 4 full blocks
        pages = pool.alloc(4)
        tree.insert(toks, pages)
        pool.free(pages)  # first slot retires; tree refs keep them live
        m, n = tree.match(toks)
        assert n == 16 and len(m) == 4
        pool.fork(m)  # second slot shares the chain
        assert pool.free(m) == []  # ...and retires: tree still holds all
        m2, n2 = tree.match(toks)
        assert n2 == 16 and m2 == m
        pool.check()

    def test_refcounts_match_tree_reachability(self):
        """With no slots holding pages, every cached page's refcount is
        exactly the tree's one ref, and nothing else is in use."""
        pool = PagePool(64, 4)
        tree = PrefixTree(pool)
        rng = np.random.default_rng(2)
        base = _tokens(24, seed=3)  # 6 blocks
        for i in range(6):
            cut = 4 * int(rng.integers(1, 7))
            toks = np.concatenate([base[:cut], _tokens(8, seed=10 + i)])
            shared, skip = tree.match(toks, max_tokens=(len(toks) // 4) * 4)
            if shared:
                pool.fork(shared)
            n_pages = len(toks) // 4
            fresh = pool.alloc(n_pages - len(shared))
            tree.insert(toks[:n_pages * 4], list(shared) + fresh)
            pool.free(list(shared) + fresh)  # the slot retires at once
            pool.check()
        assert pool.pages_in_use == 1 + tree.cached_pages
        for node in tree._nodes.values():
            assert pool.refcount(node.page) == 1
        freed = tree.clear()
        pool.check()
        assert pool.pages_in_use == 1 and freed > 0

    def test_match_respects_token_cap(self):
        pool = PagePool(16, 4)
        tree = PrefixTree(pool)
        toks = _tokens(16, seed=4)
        tree.insert(toks, pool.alloc(4))
        m, n = tree.match(toks, max_tokens=8)
        assert n == 8 and len(m) == 2

    def test_reclaim_spares_forked_pages(self):
        """LRU reclaim frees tree-only chains; pages a live slot forked
        survive (refcount > 1)."""
        pool = PagePool(16, 4)
        tree = PrefixTree(pool)
        cold, hot = _tokens(8, seed=5), _tokens(8, seed=6)
        cold_pages = pool.alloc(2)
        tree.insert(cold, cold_pages)
        pool.free(cold_pages)  # slot retires: cold chain is tree-only
        hot_pages = pool.alloc(2)
        tree.insert(hot, hot_pages)  # this slot stays live (keeps refs)
        assert tree.reclaim(4) == 2  # only the cold chain was evictable
        assert all(pool.refcount(p) >= 1 for p in hot_pages)
        assert tree.match(hot)[1] == 8  # hot chain survived
        pool.check()

    def test_build_row_table_pads_with_trash(self):
        row = build_row_table([3, 7], 4)
        assert row.dtype == np.int32
        assert list(row) == [3, 7, TRASH_PAGE, TRASH_PAGE]
        assert pages_for(17, 16) == 2 and pages_for(16, 16) == 1 and pages_for(0, 16) == 0
        with pytest.raises(ValueError):
            build_row_table([1, 2, 3], 2)
        np.testing.assert_array_equal(row, jpaging.build_row_table([3, 7], 4))

    @given(st.lists(st.integers(0, 3), min_size=1, max_size=12), st.integers(1, 5))
    @settings(max_examples=30, deadline=None)
    def test_shared_prefix_reuse_hyp(self, symbols, reps):
        """Inserting the same token stream repeatedly never allocates new
        pages past the first insert, and refcounts stay consistent."""
        pool = PagePool(64, 2)
        tree = PrefixTree(pool)
        toks = np.asarray(symbols, np.int32)
        nfull = (len(toks) // 2) * 2
        if nfull == 0:
            return
        for _ in range(reps):
            shared, skip = tree.match(toks, max_tokens=nfull)
            if shared:
                pool.fork(shared)
            fresh = pool.alloc(nfull // 2 - len(shared))
            tree.insert(toks[:nfull], list(shared) + fresh)
            pool.free(list(shared) + fresh)
            pool.check()
        assert pool.pages_in_use == 1 + tree.cached_pages
        assert tree.cached_pages == nfull // 2
