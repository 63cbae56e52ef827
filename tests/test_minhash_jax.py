"""Device MinHash (ops/minhash_jax.py) parity vs its numpy mirror and
behavioral agreement with the classic uint64 host route."""
import numpy as np
import pytest

from smoothxg_jax.ops.minhash import kmer_hashes, mash_distance
from smoothxg_jax.ops.minhash_jax import (DeviceMinHash, host_distance_matrix,
                                          kmer_hashes32)

rng = np.random.default_rng(11)


def _mutate(base: str, frac: float) -> str:
    s = list(base)
    for i in rng.choice(len(s), int(len(s) * frac), replace=False):
        s[i] = "ACGT"[rng.integers(0, 4)]
    return "".join(s)


def _family(n: int, L: int, frac: float = 0.06) -> list[str]:
    base = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
    return [base] + [_mutate(base, frac) for _ in range(n - 1)]


def test_hashes32_mirror_basics():
    s = "ACGTACGTTTGACCA" * 10
    h = kmer_hashes32(s, 16)
    assert h.dtype == np.uint32 and len(h) > 0
    assert (np.diff(h.astype(np.int64)) > 0).all()
    # canonical: revcomp gives the same set
    rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
    assert np.array_equal(kmer_hashes32(rc, 16), h)
    # invalid chars drop k-mers spanning them
    assert len(kmer_hashes32("ACGTN" + s, 16)) == len(h)
    assert len(kmer_hashes32("AC", 16)) == 0


def test_device_matrix_bit_identical_to_mirror():
    seqs = _family(9, 430) + ["ACGT" * 60]
    dm = DeviceMinHash(k=16)
    got = dm.distance_matrix(seqs)
    want = host_distance_matrix(seqs, k=16)
    assert np.array_equal(got, want)          # bit-identical float64


def test_device_matrix_mask_and_tiny():
    seqs = _family(5, 300)
    mask = np.array([True, True, False, True, True])
    got = DeviceMinHash(k=16).distance_matrix(seqs, mask)
    want = host_distance_matrix(seqs, k=16, mask=mask)
    assert np.array_equal(got, want)
    assert got[0, 2] == 1.0 and got[2, 2] == 0.0
    one = DeviceMinHash(k=16).distance_matrix(["ACGTACGTACGTACGTAA"])
    assert one.shape == (1, 1) and one[0, 0] == 0.0


def test_agrees_with_uint64_route():
    """The 32-bit hash space changes distances only by hash collisions:
    on realistic block families the two routes order pairs the same and
    differ by < 1e-3 absolute."""
    seqs = _family(8, 500)
    k = 16
    m32 = host_distance_matrix(seqs, k=k)
    for i in range(len(seqs)):
        for j in range(i + 1, len(seqs)):
            h1 = kmer_hashes(seqs[i], k)
            h2 = kmer_hashes(seqs[j], k)
            d64 = mash_distance(h1, h2, k)
            assert abs(m32[i, j] - d64) < 1e-3


@pytest.mark.parametrize("n,L", [(24, 700), (40, 260)])
def test_device_matrix_shapes(n, L):
    seqs = _family(n, L)
    got = DeviceMinHash(k=16).distance_matrix(seqs)
    want = host_distance_matrix(seqs, k=16)
    assert np.array_equal(got, want)
