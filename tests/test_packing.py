"""Bucket-packing tests: the packer must (a) never mix wildly different
padded lengths when splitting is cheaper, (b) respect batch_size and
max_batch_samples, (c) keep the compiled-shape set small via the pad
ladder, and (d) beat the old count-only grouping on a ragged mix."""

import numpy as np
import pytest

from dynamont_jax.models.packing import (
    pack_buckets,
    round_up,
    t_pad_ladder,
)


def rows_cost(lengths, buckets, t_pad_to=2048, group=8):
    total = 0
    for b in buckets:
        t_pad = t_pad_ladder(max(lengths[i] for i in b) + 1, t_pad_to)
        total += (round_up(len(b), group) // group) * t_pad
    return total


def test_ladder_monotone_and_bounded():
    prev = 0
    for T in range(1, 70000, 997):
        p = t_pad_ladder(T, 512)
        assert p >= T
        assert p >= prev  # monotone in T
        assert p - T < max(512, T // 8) + 1  # relative waste bounded
        prev = p


def test_ladder_shape_count_bounded():
    pads = {t_pad_ladder(T, 512) for T in range(1000, 64000)}
    assert len(pads) < 60  # ~8 pad points per octave


def test_covers_all_indices_once():
    lengths = [8000, 12000, 16000, 24000, 32000] * 7 + [8000]
    buckets = pack_buckets(lengths, 16, 2**22, 2048)
    seen = sorted(i for b in buckets for i in b)
    assert seen == list(range(len(lengths)))
    for b in buckets:
        assert 1 <= len(b) <= 16


def test_equal_lengths_fill_full_buckets():
    buckets = pack_buckets([16000] * 64, 16, 2**22, 2048)
    assert sorted(len(b) for b in buckets) == [16, 16, 16, 16]


def test_ragged_mix_groups_by_pad():
    # the round-3 ragged bench mix: 36 reads cycling 5 lengths
    lengths = [[8000, 12000, 16000, 24000, 32000][s % 5] for s in range(36)]
    buckets = pack_buckets(lengths, 16, 2**22, 2048, group=8)
    # the packing beats the old count-only grouping (sorted, chunk 16) —
    # the round-3 padding waste was ~29% of device rows on this mix
    order = sorted(range(36), key=lambda i: lengths[i])
    old = [order[i:i + 16] for i in range(0, 36, 16)]
    assert rows_cost(lengths, buckets) < 0.75 * rows_cost(lengths, old)
    # and is no worse than the natural pure-per-pad grouping (the DP may
    # merge a remainder group UP a pad point only when that costs less)
    by_pad: dict = {}
    for i, L in enumerate(lengths):
        by_pad.setdefault(t_pad_ladder(L + 1, 2048), []).append(i)
    pure = [grp[i:i + 16] for grp in by_pad.values()
            for i in range(0, len(grp), 16)]
    assert rows_cost(lengths, buckets) <= rows_cost(lengths, pure)


def test_respects_max_batch_samples():
    lengths = [100_000] * 8
    cap = 2 * t_pad_ladder(100_001, 512)  # only 1-2 reads per launch fit
    buckets = pack_buckets(lengths, 16, cap, 512, group=1)
    for b in buckets:
        t_pad = t_pad_ladder(100_001, 512)
        assert len(b) * t_pad <= cap or len(b) == 1


def test_group_quantum_prefers_multiples():
    # 9 equal reads, group 8: 8+1 and 9 cost the same rows (2 group-rows)
    # so the packer must not split below the launch-overhead tie-break
    buckets = pack_buckets([16000] * 9, 16, 2**22, 2048, group=8)
    assert len(buckets) == 1


def test_empty():
    assert pack_buckets([], 16, 2**22, 2048) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_pools_valid(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2000, 60000, size=50).tolist()
    buckets = pack_buckets(lengths, 16, 2**22, 2048)
    seen = sorted(i for b in buckets for i in b)
    assert seen == list(range(50))
    # buckets are emitted short-to-long
    maxes = [max(lengths[i] for i in b) for b in buckets]
    assert maxes == sorted(maxes)
