import numpy as np

from dynamont_jax.utils.signal import hampel_filter, normalize_signal, prepare_read_sequence


def _reference_hampel(signal, WINDOW=3, n_sigmas=3.0):
    """Literal port of the reference loop (ref: FileIO.py:17-43) as the oracle."""
    k = 1.4826
    HALF_WINDOW = WINDOW // 2
    original = signal.copy()
    window = original[:WINDOW].copy()
    for i in range(HALF_WINDOW, len(signal) - HALF_WINDOW - 1):
        median = np.median(window)
        mad = k * np.median(np.abs(window - median))
        if np.abs(original[i] - median) > n_sigmas * mad:
            signal[i] = median
        window[:-1] = window[1:]
        window[-1] = original[i + HALF_WINDOW + 1]
    return signal


def test_hampel_matches_reference_w3():
    rng = np.random.default_rng(42)
    sig = rng.normal(0, 1, 500)
    sig[50] = 25.0
    sig[200] = -30.0
    ours = hampel_filter(sig.copy(), 3, 3.0)
    ref = _reference_hampel(sig.copy(), 3, 3.0)
    np.testing.assert_array_equal(ours, ref)
    assert ours[50] != 25.0  # outlier replaced


def test_hampel_matches_reference_w6():
    rng = np.random.default_rng(7)
    sig = rng.normal(0, 1, 333)
    sig[100] = 100.0
    ours = hampel_filter(sig.copy(), 6, 5.0)
    ref = _reference_hampel(sig.copy(), 6, 5.0)
    np.testing.assert_array_equal(ours, ref)


def test_hampel_short_signal_noop():
    sig = np.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(hampel_filter(sig.copy()), _reference_hampel(sig.copy()))


def test_normalize():
    sig = np.array([10, 20, 30], dtype=np.float32)
    out = normalize_signal(sig, 10.0, 10.0)
    np.testing.assert_allclose(out, [0.0, 1.0, 2.0])
    assert out.dtype == np.float64


def test_prepare_read_sequence():
    assert prepare_read_sequence("ACGT", rna=False) == "ACGT"
    assert prepare_read_sequence("ACGT", rna=True) == "AAAAAAAAA" + "TGCA"
    # already has the polyA anchor after reversal -> no double prefix
    assert prepare_read_sequence("GGG" + "A" * 9, rna=True) == "A" * 9 + "GGG"
