import numpy as np

from dynamont_jax.utils.output import (
    format_segmentation,
    format_segmentation_output,
    parse_segment_string,
    segments_to_string,
)


def test_parse_roundtrip():
    segs = [("M", 2, 0, 1.0), ("M", 3, 2, 0.89565)]
    s = segments_to_string(segs)
    assert s == "M2,0,1.00000;M3,2,0.89565;"
    parsed = parse_segment_string(s)
    assert parsed == [("M", 2, 0, 1.0, None), ("M", 3, 2, 0.89565, None)]


def test_polish_column():
    segs = [("M", 2, 0, 1.0, "ACGTC")]
    assert segments_to_string(segs) == "M2,0,1.00000,ACGTC;"
    assert parse_segment_string("M2,0,1.00000,ACGTC;") == [("M", 2, 0, 1.0, "ACGTC")]


def test_format_segmentation_output_golden_dna():
    # golden string from the reference test suite (ref: test_FileIO.py:59-71)
    output = "M2,0,1.000000;M3,2,1.000000;M4,871,0.895648;"
    read = "AAACCCGGG"
    rows = format_segmentation_output(output, 10, 1000 + 10, read, 5, rna=False)
    assert rows.shape == (3, 8)
    # start/end offsets
    assert list(rows[0][:2]) == [10, 12]
    assert list(rows[1][:2]) == [12, 881]
    assert list(rows[2][:2]) == [881, 1010]
    # basepos/base/motif
    assert rows[0][2] == 2 and rows[0][3] == "A" and rows[0][4] == "AAACC"
    assert rows[2][2] == 4 and rows[2][3] == "C" and rows[2][4] == "ACCCG"
    assert all(r[5] == "M" for r in rows)
    assert rows[2][6] == 0.895648
    assert all(r[7] == "NA" for r in rows)


def test_format_segmentation_output_rna_mirroring():
    output = "M2,0,1.000000;"
    read = "AAACCCGGG"  # processing orientation (3'->5')
    rows = format_segmentation_output(output, 0, 100, read, 5, rna=True)
    # basepos mirrored: len(read) - 2 - 1 = 6; motif reversed
    assert rows[0][2] == 6
    assert rows[0][4] == "CCAAA"
    assert rows[0][3] == "A"


def test_format_segmentation_bytes():
    rows = np.array([[0, 5, 2, "A", "AAACC", "M", 1.0, "NA"]], dtype=object)
    out = format_segmentation("rid", "sid", rows)
    assert out == b"rid,sid,0,5,2,A,AAACC,M,1.0,NA\n"


def test_fused_csv_matches_two_step():
    import numpy as np

    from dynamont_jax.io.output import (
        format_segments, format_segments_csv, rows_to_csv_bytes,
    )

    rng = np.random.default_rng(0)
    read = "".join(rng.choice(list("ACGT"), size=40))
    for rna in (False, True):
        for with_polish in (False, True):
            segs = []
            t = 0
            for n in range(2, 30):
                t += int(rng.integers(1, 20))
                p = float(np.float32(rng.random()))
                seg = ("M", n, t, p)
                if with_polish:
                    seg = seg + ("AAGCA",)
                segs.append(seg)
            rows = format_segments(segs, 7, 999, read, 5, rna)
            two_step = rows_to_csv_bytes("rid", "sid", rows)
            fused = format_segments_csv(
                "rid", "sid", segs, 7, 999, read, 5, rna
            )
            assert fused == two_step


def test_summaries_to_segments_vectorized():
    import numpy as np

    from dynamont_jax.ops.nt_banded_device import summaries_to_segments

    starts = np.array([3, -1, 5, 9, -1, 12, 44], np.int32)
    med = np.array([0.0, 0.1, 0.25, 0.5, 0.9, 1.0, 0.75], np.float32)
    segs = summaries_to_segments(starts, med, 6, 5)
    # n=0 ignored; n in 1..5 with starts >= 0 kept; basepos = n - 1 + 2
    assert segs == [
        ("M", 3, 5, float(np.float32(0.25))),
        ("M", 4, 9, float(np.float32(0.5))),
        ("M", 6, 12, float(np.float32(1.0))),
    ]
    assert all(isinstance(s[1], int) and isinstance(s[3], float)
               for s in segs)


def test_native_summaries_csv_matches_python():
    import numpy as np
    import pytest

    from dynamont_jax.io.output import format_segments_csv
    from dynamont_jax.native import summaries_csv_native
    from dynamont_jax.ops.nt_banded_device import summaries_to_segments

    if summaries_csv_native("x,y,", np.zeros(4, np.int32),
                            np.zeros(4, np.float32), 2, "ACGTA", 5, False,
                            0, 10) is None:
        pytest.skip("native lib unavailable")

    rng = np.random.default_rng(7)
    for trial in range(20):
        N = int(rng.integers(2, 60))
        read = "".join(rng.choice(list("ACGT"), size=N + 6))
        starts = np.where(
            rng.random(N + 4) < 0.3, -1, rng.integers(0, 10000, N + 4)
        ).astype(np.int32)
        med = rng.random(N + 4).astype(np.float32)
        # exercise repr edge cases: integral, tiny-scientific, near-1
        med[1] = 0.0
        if N > 3:
            med[2] = 1.0
            med[3] = np.float32(3.1e-06)
        rna = bool(trial % 2)
        off = int(rng.integers(0, 100))
        last = int(rng.integers(10000, 20000))
        segs = summaries_to_segments(starts, med, N, 5)
        want = format_segments_csv("rid", "sid", segs, off, last, read, 5,
                                   rna)
        got = summaries_csv_native("rid,sid,", starts, med, N, read, 5,
                                   rna, off, last)
        assert got == want, f"trial {trial}"


def test_plain_csv_writer_and_resume_without_zstandard(tmp_path, monkeypatch):
    """A non-.zst outfile is plain CSV text and never imports zstandard;
    --resume repairs a plain file cut mid-row."""
    import builtins
    import sys

    from dynamont_jax.io import output as out_io

    real_import = builtins.__import__

    def no_zstd(name, *a, **kw):
        if name == "zstandard":
            raise ImportError("zstandard unavailable")
        return real_import(name, *a, **kw)

    monkeypatch.delitem(sys.modules, "zstandard", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_zstd)
    out = tmp_path / "run.csv"
    w = out_io.SegmentationWriter(str(out))
    w.put_result(b"r1,s1,0,5,0,A,AAAAA,M,0.9,\n")
    w.put_result(b"r2,s2,0,4,0,C,CCCCC,M,0.8,\n")
    w.put_error("error: 3, boom\tRid: r3")
    w.close()
    assert out.read_bytes().startswith(out_io.CSV_HEADER)
    assert (tmp_path / "run.errors").read_text().count("\n") == 1
    assert out_io.prepare_resume(str(out)) == {"r1", "r2"}
    with open(out, "ab") as f:
        f.write(b"r3,s3,0,2,0,G,GG")          # hard kill mid-row
    # the trailing read is re-segmented: its rows may be incomplete
    assert out_io.prepare_resume(str(out)) == {"r1"}
    assert out.read_bytes().endswith(b"r1,s1,0,5,0,A,AAAAA,M,0.9,\n")
