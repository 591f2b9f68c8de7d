"""C's new keys in the stack multiply, `mm.multiply.union_keys`, on the CPU.

The union of C's old keys and the candidate products' keys is
``np.union1d(old, np.unique(cand))``: sorted, unique, int64.  The port
builds it with a presence bitmap over C's key space where that space is
at most `_UNION_BITMAP_K` slots a key and at most `_UNION_BITMAP_MAX`
slots, and with the sort otherwise; ``read_totals()["index_engine"]
["union"]`` counts which ran.  Both give the same array, so a multiply
and a TAS contraction give the same C, key for key and bit for bit,
whichever path runs.  No counterpart in the JAX package, which sorts.
"""

import numpy as np
import pytest

from dbcsr_tpu_torch.mm import multiply as mm
from dbcsr_tpu_torch.ops import test_methods as port_tm
from dbcsr_tpu_torch.tensor import contract, create_tensor

K, S_MAX = mm._UNION_BITMAP_K, mm._UNION_BITMAP_MAX


@pytest.fixture(autouse=True)
def fresh():
    mm.clear_plan_cache()
    mm.reset_totals()
    yield
    mm.clear_plan_cache()


def _unions():
    return mm.read_totals()["index_engine"]["union"]


def _force_sort(monkeypatch):
    monkeypatch.setattr(mm, "_UNION_BITMAP_K", 0)


def _case(name, rng):
    """(old keys, candidate keys, key space) of one named case; each with
    keys has at least one key for every K slots, so the bitmap may run."""
    space = 30 * 30
    if name == "empty_candidates":
        return np.unique(rng.integers(0, space, 200)), np.empty(0, np.int64), space
    if name == "empty_old":
        return np.empty(0, np.int64), rng.integers(0, space, 200), space
    if name == "both_empty":
        return np.empty(0, np.int64), np.empty(0, np.int64), space
    if name == "heavy_duplicates":
        return np.unique(rng.integers(0, space, 20)), rng.integers(0, 7, 5000) * 97, space
    if name == "space_ends":
        space = 7 * K
        return np.array([0, space - 1]), np.array([space - 1, 0, 5, space - 1, 0]), space
    if name == "symmetric":
        # C's stored triangle, i <= j, as `_candidates` keeps it for a
        # symmetric C
        n = 30
        i, j = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
        i, j = np.minimum(i, j), np.maximum(i, j)
        old = np.unique(rng.integers(0, n, 40) * (n + 1))  # diagonal blocks
        return old, i * n + j, n * n
    raise ValueError(name)


@pytest.mark.parametrize("name", ["empty_candidates", "empty_old", "both_empty",
                                  "heavy_duplicates", "space_ends", "symmetric"])
@pytest.mark.parametrize("path", ["bitmap", "sort"])
def test_union_is_the_sorted_union(name, path, monkeypatch):
    rng = np.random.default_rng(len(name))
    old, cand, space = _case(name, rng)
    old, cand = old.astype(np.int64), cand.astype(np.int64)
    if path == "sort":
        _force_sort(monkeypatch)
    got = mm.union_keys(old, cand, space)
    want = np.union1d(old, np.unique(cand))
    assert got.dtype == np.int64 and np.array_equal(got, want)
    n = len(old) + len(cand)
    ran = "bitmap" if path == "bitmap" and n else "sort"
    assert _unions() == {ran: 1, {"bitmap": "sort", "sort": "bitmap"}[ran]: 0}


@pytest.mark.parametrize("over,path", [(-1, "bitmap"), (0, "bitmap"), (1, "sort")])
def test_the_key_space_against_the_key_count_picks_the_path(over, path):
    """The bitmap up to K slots a key, the sort past it."""
    rng = np.random.default_rng(11)
    old = np.unique(rng.integers(0, 1000, 40))
    cand = rng.integers(0, 1000, 360)
    space = K * (len(old) + len(cand)) + over
    got = mm.union_keys(old, cand, space)
    assert np.array_equal(got, np.union1d(old, np.unique(cand)))
    assert _unions()[path] == 1 and sum(_unions().values()) == 1


def test_a_key_space_over_the_cap_takes_the_sort():
    """Past `_UNION_BITMAP_MAX` slots the sort runs, however many keys:
    the bitmap's host memory stays bounded."""
    space = S_MAX + 1
    n = -(-space // K)  # enough keys for the K rule alone to take the bitmap
    rng = np.random.default_rng(12)
    cand = rng.integers(0, space, n)
    cand[:2] = (0, space - 1)
    got = mm.union_keys(np.empty(0, np.int64), cand, space)
    assert space <= K * n and _unions() == {"bitmap": 0, "sort": 1}
    assert np.array_equal(got, np.unique(cand))


def _same_c(x, y):
    assert np.array_equal(x.keys, y.keys)
    assert np.array_equal(x.ent_bin, y.ent_bin) and np.array_equal(x.ent_slot, y.ent_slot)
    assert len(x.bins) == len(y.bins)
    for bx, by in zip(x.bins, y.bins):
        assert bx.data.equal(by.data)


def test_north_star_multiply_is_the_same_on_both_paths(monkeypatch):
    """The north star's blocking (23s and one 18) at 24 block rows,
    occupancy 0.1, alpha 1 and beta 1 into a copy of C: the same C from
    the bitmap and from the sort."""
    sizes = [23] * 23 + [18]
    rng = np.random.default_rng(2026)
    a, b, c0 = (port_tm.make_random_matrix(n, sizes, sizes, occupation=0.1, rng=rng,
                                           device="cpu") for n in "ABC")
    out = {}
    for path in ("bitmap", "sort"):
        if path == "sort":
            _force_sort(monkeypatch)
        mm.clear_plan_cache()
        mm.reset_totals()
        c = c0.copy()
        mm.multiply("N", "N", 1.0, a, b, 1.0, c)
        assert _unions()[path] == 1 == mm.read_totals()["multiplies"]
        out[path] = c
    assert len(out["bitmap"].keys) > len(c0.keys)
    _same_c(out["bitmap"], out["sort"])


def test_tas_contraction_is_the_same_on_both_paths(monkeypatch):
    """An RI-shaped contraction, T(i,j,k) M(k,l) into an empty C(i,j,l)
    split into TAS groups: every group's union and the union of C's
    pattern built before them, on each path, the same C."""
    si, sj, sk, sl = [3] * 12, [2] * 12, [4, 3, 2], [2, 3]
    rng = np.random.default_rng(5)
    t = create_tensor("T", [si, sj, sk], (0, 1), (2,), device="cpu")
    m = create_tensor("M", [sk, sl], (0,), (1,), device="cpu")
    for x, occ in ((t, 0.5), (m, 0.9)):
        for idx in np.ndindex(*[len(d) for d in x.blk_sizes]):
            if rng.random() < occ:
                x.put_block(idx, rng.standard_normal(x.block_shape(idx)))
        x.finalize()
    kw = dict(contract_a=(2,), notcontract_a=(0, 1), contract_b=(0,), notcontract_b=(1,),
              map_1=(0, 1), map_2=(2,))
    out = {}
    for path in ("bitmap", "sort"):
        if path == "sort":
            _force_sort(monkeypatch)
        mm.clear_plan_cache()
        mm.reset_totals()
        c = create_tensor("C", [si, sj, sl], (0, 1), (2,), device="cpu")
        c.finalize()
        contract(1.0, t, m, 0.0, c, **kw)
        groups, unions = mm.read_totals()["multiplies"], _unions()
        assert c.matrix._tas_nsplit > 1 and groups > 1
        assert sum(unions.values()) == groups + mm.read_totals()["c_rebuild"]["prebuilt"]
        assert mm.read_totals()["c_rebuild"]["prebuilt"] == 1
        # a group with few candidates in C's key space sorts on either path
        assert unions["bitmap"] > 0 if path == "bitmap" else unions["bitmap"] == 0
        out[path] = c.matrix
    assert len(out["bitmap"].keys)
    _same_c(out["bitmap"], out["sort"])
