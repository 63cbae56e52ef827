"""Device banded-identity kernel (ops/ident_jax.py): bit-parity vs its
numpy mirror, exact counts on constructed alignments, and behavioral
agreement with the host WFA identity on realistic pairs."""
import numpy as np
import pytest

from smoothxg_jax.ops.ident_jax import (DeviceBandedIdentity,
                                        host_banded_identity,
                                        identity_from_counts)
from smoothxg_jax.ops.wfa import gap_compressed_identity, wfa_align

rng = np.random.default_rng(5)


def _rand(L):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, L))


def _mutate(s, subs=0, ins=0, dele=0):
    s = list(s)
    for i in rng.choice(len(s), subs, replace=False):
        s[i] = "ACGT"[rng.integers(0, 4)]
    for _ in range(ins):
        p = rng.integers(0, len(s))
        s.insert(p, "ACGT"[rng.integers(0, 4)])
    for _ in range(dele):
        p = rng.integers(0, len(s))
        del s[p]
    return "".join(s)


def test_counts_identical_and_substitution():
    a = _rand(300)
    sc, m, x, g = host_banded_identity(a, a, return_counts=True)
    assert (sc, m, x, g) == (0, 300, 0, 0)
    b = a[:100] + ("A" if a[100] != "A" else "C") + a[101:]
    sc, m, x, g = host_banded_identity(a, b, return_counts=True)
    assert (sc, m, x, g) == (7, 299, 1, 0)
    assert identity_from_counts(m, x, g) == 299 / 300


def test_counts_single_gap_run():
    a = _rand(260)
    b = a[:120] + a[125:]          # one 5-bp deletion
    sc, m, x, g = host_banded_identity(a, b, return_counts=True)
    assert (sc, m, x, g) == (11 + 5 * 1, 255, 0, 1)
    assert identity_from_counts(m, x, g) == 255 / 256


def test_device_bit_identical_to_mirror():
    pairs = []
    for L in (40, 130, 390, 511):
        a = _rand(L)
        pairs.append((a, _mutate(a, subs=L // 15, ins=2, dele=1)))
    pairs.append(("ACGT" * 30, "TTTT" * 25))      # dissimilar
    pairs.append((_rand(200), _rand(200)))        # random vs random
    dev = DeviceBandedIdentity()
    got = dev.identities(pairs)
    want = [host_banded_identity(a, b) for a, b in pairs]
    assert got == want                            # float64 from int counts


def test_max_score_bail_matches_mirror():
    a, b = _rand(300), _rand(300)
    dev = DeviceBandedIdentity()
    assert dev.identities([(a, b)], max_score=50) == \
        [host_banded_identity(a, b, max_score=50)]
    assert dev.identities([(a, b)], max_score=50) == [0.0]


def test_agrees_with_wfa_identity():
    """Both estimators compute optimal affine-gap alignment identity;
    within-band cases agree closely (tie-broken paths may differ by a
    count or two)."""
    for _ in range(6):
        a = _rand(420)
        b = _mutate(a, subs=20, ins=3, dele=2)
        score, cig = wfa_align(a, b, max_distance_threshold=0)
        want = gap_compressed_identity(cig)
        got = host_banded_identity(a, b)
        assert abs(got - want) < 0.01, (got, want)


def test_swapped_pair_is_symmetric():
    a = _rand(300)
    b = _mutate(a, subs=10, ins=4)
    assert host_banded_identity(a, b) == host_banded_identity(b, a)
