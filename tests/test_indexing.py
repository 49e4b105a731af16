"""Exhaustive unit tests of the essential/guard index maps against
brute-force multi-index constructions (util.cpp:155-278 semantics)."""

import numpy as np
import pytest

from quandary_tpu.utils import indexing as ix


CASES = [
    ([3], [2]),
    ([3, 20], [3, 20]),
    ([3, 4], [2, 2]),
    ([2, 3, 4], [2, 2, 3]),
    ([4, 4, 4], [2, 3, 4]),
]


def _brute_levels(i, dims):
    out = []
    rem = i
    for k in range(len(dims)):
        post = int(np.prod(dims[k + 1:])) if k + 1 < len(dims) else 1
        out.append(rem // post)
        rem %= post
    return out


@pytest.mark.parametrize("nlevels,ness", CASES)
def test_multi_index_roundtrip(nlevels, ness):
    N = int(np.prod(nlevels))
    for i in range(N):
        lv = ix.multi_index(i, nlevels)
        assert list(lv) == _brute_levels(i, nlevels)
        assert ix.flat_index(lv, nlevels) == i


@pytest.mark.parametrize("nlevels,ness", CASES)
def test_ess_full_maps(nlevels, ness):
    Ne = int(np.prod(ness))
    emap = ix.ess_to_full_map(nlevels, ness)
    assert len(emap) == Ne
    for i in range(Ne):
        f = ix.map_ess_to_full(i, nlevels, ness)
        assert emap[i] == f
        assert ix.map_full_to_ess(f, nlevels, ness) == i
        # brute force: per-oscillator levels preserved
        assert _brute_levels(f, nlevels) == _brute_levels(i, ness)


@pytest.mark.parametrize("nlevels,ness", CASES)
def test_masks(nlevels, ness):
    N = int(np.prod(nlevels))
    em = ix.essential_mask(nlevels, ness)
    gm = ix.guard_mask(nlevels, ness)
    for i in range(N):
        lv = _brute_levels(i, nlevels)
        is_ess = all(l < ne for l, ne in zip(lv, ness))
        is_guard = any(l == nl - 1 and l >= ne
                       for l, nl, ne in zip(lv, nlevels, ness))
        assert em[i] == is_ess
        assert gm[i] == is_guard
        assert ix.is_essential(i, nlevels, ness) == is_ess
        assert ix.is_guard_level(i, nlevels, ness) == is_guard


def test_lift_matrix():
    nlevels, ness = [3, 2], [2, 2]
    rng = np.random.default_rng(0)
    V = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    Vf = ix.lift_matrix_ess_to_full(V, nlevels, ness)
    emap = ix.ess_to_full_map(nlevels, ness)
    np.testing.assert_array_equal(Vf[np.ix_(emap, emap)], V)
    for g in range(6):
        if g not in emap:
            assert Vf[g, g] == 1.0
            row = Vf[g].copy()
            row[g] = 0
            assert np.all(row == 0)


def test_permutation_gate_matches_dense():
    """apply_permutation_gate_to_states == dense assemble_gate application
    for every permutation gate, with rotation and guard levels."""
    from quandary_tpu.models import gates

    rng = np.random.default_rng(3)
    for name, nlv, ness in [
        ("cnot", [3, 2], [2, 2]),
        ("swap", [2, 3], [2, 2]),
        ("xgate", [3], [2]),
        ("cqnot", [2, 2, 2], [2, 2, 2]),
        ("swap0q", [2, 2, 2], [2, 2, 2]),
    ]:
        N = int(np.prod(nlv))
        rot = [0.11, 0.07, 0.05][: len(nlv)]
        T = 3.0
        Vess = gates.from_name(name, ness)
        Vfull = gates.assemble_gate(Vess, nlv, ness, rot, T)
        # Schroedinger
        x0 = rng.normal(size=(3, N)) + 1j * rng.normal(size=(3, N))
        want = np.einsum("ij,bj->bi", Vfull, x0)
        got = gates.apply_permutation_gate_to_states(
            name, x0, nlv, ness, rot, T, lindblad=False)
        np.testing.assert_allclose(got, want, atol=1e-12)
        # Lindblad
        r0 = rng.normal(size=(2, N, N)) + 1j * rng.normal(size=(2, N, N))
        want = np.einsum("ij,bjk,lk->bil", Vfull, r0, Vfull.conj())
        got = gates.apply_permutation_gate_to_states(
            name, r0, nlv, ness, rot, T, lindblad=True)
        np.testing.assert_allclose(got, want, atol=1e-12)

