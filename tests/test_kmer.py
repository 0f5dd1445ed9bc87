import numpy as np
import pytest

from dynamont_jax.utils.kmer import (
    kmer2int,
    int2kmer,
    seq_to_kmer_ids,
    successing_kmer,
    precessing_kmer,
    hamming_distance_ids,
    hamming_table,
)


def test_kmer2int_roundtrip_dna():
    # DNA: int2kmer reverses digits, so round trip must hold
    for kmer in ["AAAAA", "ACGTA", "TTTTT", "GCGCG", "TACGT"]:
        v = kmer2int(kmer, 4)
        assert int2kmer(v, 4, 5, rna=False) == kmer


def test_kmer2int_rna_orientation():
    # RNA: itoa emits in reversed (5'->3') direction (ref: utils.cpp:220-223)
    kmer = "ACGTC"
    v = kmer2int(kmer, 4)
    assert int2kmer(v, 4, 5, rna=True) == kmer[::-1]


def test_kmer2int_values():
    assert kmer2int("AAAAA", 4) == 0
    assert kmer2int("AAAAC", 4) == 1
    assert kmer2int("CAAAA", 4) == 256
    assert kmer2int("TTTTT", 4) == 1023


def test_seq_to_kmer_ids_matches_scalar():
    seq = "ACGTACGGTTACGA"
    ids = seq_to_kmer_ids(seq, 5, 4)
    expected = [kmer2int(seq[i : i + 5], 4) for i in range(len(seq) - 4)]
    assert ids.tolist() == expected


def test_successor_predecessor():
    step = 4 ** 4
    k = kmer2int("ACGTC", 4)
    # append G: CGTCG
    assert successing_kmer(k, 2, step, 4) == kmer2int("CGTCG", 4)
    # prepend T: TACGT
    assert precessing_kmer(k, 3, step, 4) == kmer2int("TACGT", 4)


def test_successor_predecessor_inverse():
    step = 4 ** 4
    rng = np.random.default_rng(0)
    for _ in range(50):
        k = int(rng.integers(0, 4 ** 5))
        nt = int(rng.integers(0, 4))
        s = successing_kmer(k, nt, step, 4)
        # predecessor of the successor with the dropped leading digit restores k
        lead = k // step
        assert precessing_kmer(s, lead, step, 4) == k


def test_hamming():
    a = kmer2int("ACGTC", 4)
    b = kmer2int("ACGTC", 4)
    assert hamming_distance_ids(a, b, 4, 5) == 0
    c = kmer2int("TCGTA", 4)
    assert hamming_distance_ids(a, c, 4, 5) == 2
    table = hamming_table(4, 3)
    for _ in range(20):
        rng = np.random.default_rng(1)
        x, y = rng.integers(0, 64, 2)
        assert table[x, y] == hamming_distance_ids(int(x), int(y), 4, 3)


def test_invalid_characters_raise():
    with pytest.raises(ValueError):
        seq_to_kmer_ids("ACGXZ", 3, 4)


def test_int2kmers_batch_matches_scalar():
    import numpy as np

    from dynamont_jax.utils.kmer import int2kmer, int2kmers_batch

    rng = np.random.default_rng(3)
    for A, S in ((4, 5), (4, 9)):
        vals = rng.integers(0, A ** S, size=50)
        for rna in (False, True):
            got = int2kmers_batch(vals, A, S, rna)
            want = [int2kmer(int(v), A, S, rna) for v in vals]
            assert got == want
