"""NTC MAP segmentation parity vs the reference dynamont-NTC output."""

import numpy as np
import pytest

from dynamont_jax.models.ntc import run_ntc
from dynamont_jax.models.registry import load_model_for_pore

from tests.ref_oracle import run_reference
from tests.synthetic import make_read, signal_to_text

pytestmark = [pytest.mark.slow, pytest.mark.parity]


@pytest.fixture(scope="module")
def model():
    return load_model_for_pore("rna002")


def _parse_ref(segstring):
    out = []
    for part in segstring.strip().split(";"):
        if not part:
            continue
        state = part[0]
        fields = part[1:].split(",")
        out.append((state, int(fields[0]), int(fields[1]), float(fields[2]), fields[3]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ntc_segments_match_reference(model, seed):
    sig, read = make_read(model, n_bases=25, seed=seed)
    p = run_reference("dynamont-NTC", signal_to_text(sig), read)
    assert p.returncode == 0, p.stderr
    ref = _parse_ref(p.stdout.splitlines()[0])
    res = run_ntc(sig, read, model, "rna002")
    got = [
        ("M" if s[0] == "M" else s[0], s[1], s[2], s[3], s[4])
        for s in res.segments
    ]
    assert len(got) == len(ref)
    n_mismatch = 0
    for g, r in zip(got, ref):
        same = (
            g[0] == r[0] and g[1] == r[1] and g[2] == r[2]
            and abs(g[3] - r[3]) < 1e-4 and g[4] == r[4]
        )
        n_mismatch += 0 if same else 1
    # near-ties in the max-DP can resolve differently at ULP level between
    # implementations; demand essentially full agreement
    assert n_mismatch <= max(1, len(ref) // 50), (
        f"{n_mismatch}/{len(ref)} mismatches; first few: "
        f"{[(g, r) for g, r in zip(got, ref) if g != r][:3]}"
    )


def test_native_ntc_walker_matches_python(model):
    """The C++ slot walker must reproduce the Python walk exactly."""
    import dynamont_jax.native as native
    from dynamont_jax.models import ntc as ntc_mod

    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    sig, read = make_read(model, n_bases=22, seed=9)
    res_native = run_ntc(sig, read, model, "rna002")
    # force the Python walk by disabling the native path
    orig = native.ntc_traceback_native
    native.ntc_traceback_native = lambda *a, **k: None
    try:
        res_py = run_ntc(sig, read, model, "rna002")
    finally:
        native.ntc_traceback_native = orig
    assert res_native.segments == res_py.segments


def test_ntc_production_length_matches_reference(model):
    """Production-scale parity: ONE T~16k read border-for-border through
    the BATCHED fp32 engine (the production path) vs dynamont-NTC.
    Closes the ladder at real read length — the small-N tests above
    anchor exactness, this anchors the 16k-step fp32 accumulation
    (ref: NTC_main.cpp:151-175 at production T)."""
    import jax.numpy as jnp

    from dynamont_jax.models.batch import BatchItem
    from dynamont_jax.models.ntc_batch import NTCBatchEngine

    sig, read = make_read(model, n_bases=1350, mean_dwell=12.0, seed=3)
    sig = sig[:16000]
    p = run_reference("dynamont-NTC", signal_to_text(sig), read)
    assert p.returncode == 0, p.stderr
    ref = _parse_ref(p.stdout.splitlines()[0])
    eng = NTCBatchEngine(model, "rna002", dtype=jnp.float32,
                         fallback=False)
    out = eng.run([BatchItem(sig, read)])[0]
    assert out.error is None, out.error
    assert len(out.segments) == len(ref)
    n_mismatch = 0
    for g, r in zip(out.segments, ref):
        same = (
            g[0] == r[0] and g[1] == r[1] and g[2] == r[2]
            and abs(g[3] - r[3]) < 5e-3 and g[4] == r[4]
        )
        n_mismatch += 0 if same else 1
    # fp32 near-ties may flip occasional segments over 16k steps
    assert n_mismatch <= max(2, len(ref) // 50), (
        f"{n_mismatch}/{len(ref)} mismatches"
    )
