"""Evaluation/plotting tooling tests."""

import json

import numpy as np
import pytest

from dynamont_jax.eval.compare_tools import (
    borders_from_segments, evaluate, generate_control, segment_lengths,
)
from dynamont_jax.eval.edge_detection import wavelet_peaks, window_edges
from dynamont_jax.eval.evaluate_reads import (
    compute_n50, compute_stats, global_alignment, report,
)


def test_evaluate_exact_matches():
    gt = np.array([10, 20, 30])
    res = evaluate(gt, np.array([10, 20, 30]), max_distance=5)
    # exact hit counts once at every threshold
    assert res[5] == 3
    assert res[0] == 3 and res[-1] == 3


def test_evaluate_with_offsets():
    gt = np.array([10, 30])
    res = evaluate(gt, np.array([12, 27]), max_distance=5)
    m = 5
    assert res[m] == 0                 # no exact hits
    # 10 vs 12 -> d=-2; 30 vs 27 -> d=+3
    assert res[m - 3] >= 1 and res[m + 2] >= 1


def test_evaluate_neighbor_stealing_with_remaining_candidates():
    """The next gt steals the shared prediction; the current gt must
    re-select among its remaining candidates instead of crashing (the
    reference's re-selection lambda raises KeyError here,
    ref: compareTools.py:357-376 — deliberate fix, see evaluate())."""
    # gt=10: candidates pred 11 (d=-1), 13 (d=-3); gt=11: pred 11 is exact
    # (d=0) so it steals pred 11 from gt=10, which falls back to pred 13.
    res = evaluate(np.array([10, 11]), np.array([11, 13]), max_distance=5)
    assert res[5] == 1          # one exact hit (gt=11)
    assert res[-1] == 2         # both gts matched within distance 5


def test_evaluate_prev_stealing_with_remaining_candidates():
    """Mirror case: the previous gt keeps the shared prediction."""
    # gt=10 matched pred 10 exactly; gt=11's best is also pred 10 but the
    # previous match is closer, so gt=11 falls back to pred 14 (d=-3).
    res = evaluate(np.array([10, 11]), np.array([10, 14]), max_distance=5)
    assert res[5] == 1
    assert res[-1] == 2


def test_evaluate_empty_pred():
    assert evaluate(np.array([5, 9]), np.array([]), 3).sum() == 0


def test_generate_control_shapes():
    regions = {"r1": [(10, 100, 200)]}
    rnd, uni = generate_control(regions, seed=1)
    assert len(uni["r1"]) == 10
    assert len(rnd["r1"]) == 10
    assert np.all((rnd["r1"] >= 100) & (rnd["r1"] < 200))
    assert uni["r1"][0] == 100 and uni["r1"][-1] == 199


def test_segment_utils():
    segs = [(0, 5, "A", "AAAAA"), (5, 9, "C", "CCCCC")]
    assert list(segment_lengths({"r": segs})) == [5, 4]
    assert list(borders_from_segments(segs)) == [0, 5]


def test_global_alignment_and_n50():
    assert global_alignment("ACGT", "ACGT") == 0
    assert global_alignment("ACGT", "ACTT") == 1
    assert compute_n50([1, 2, 3, 4, 10]) == 10
    assert compute_n50([5, 5, 5, 5]) == 5


def test_compute_stats_report():
    basecalls = {"a": "ACGTACGT", "b": "ACGT", "c": "GGGG"}
    segmented = {"a": "ACGTACGT", "b": "ACG"}
    stats = report(compute_stats(basecalls, segmented))
    assert stats["total"] == 3 and stats["present"] == 2
    assert stats["missing"] == 1 and stats["identical"] == 1
    assert stats["truncated"] == 1


def test_wavelet_peaks_finds_step_edges():
    rng = np.random.default_rng(0)
    sig = np.concatenate([
        rng.normal(0, 0.05, 200), rng.normal(2, 0.05, 200),
        rng.normal(-1, 0.05, 200),
    ])
    peaks = wavelet_peaks(sig, threshold=0.5)
    assert len(peaks) >= 2
    assert any(abs(p - 200) <= 5 for p in peaks)
    assert any(abs(p - 400) <= 5 for p in peaks)


def test_window_edges_finds_step():
    rng = np.random.default_rng(1)
    sig = np.concatenate([rng.normal(0, 0.05, 100), rng.normal(3, 0.05, 100)])
    edges = window_edges(sig, threshold=3.0)
    assert any(abs(e - 100) <= 3 for e in edges)


def test_collect_metrics_roundtrip(tmp_path):
    from dynamont_jax.eval import collect_metrics

    j = tmp_path / "tool.json"
    j.write_text(json.dumps({"present": 5, "N50": 1000, "lengths": [1, 2]}))
    t = tmp_path / "time.txt"
    t.write_text("Elapsed time: 00:10:05 h:m:s\nMax Memory: 1234 MB\n")
    out = tmp_path / "metrics.csv"
    collect_metrics.main([
        "--tool", "dynamont", str(j), "--time", "dynamont", str(t),
        "-o", str(out),
    ])
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "Tool,Value,Metric"
    assert any("n50_length" in ln for ln in lines)
    assert any("Memory in MB" in ln for ln in lines)


def test_plot_segmentation_smoke(tmp_path):
    from dynamont_jax.io.output import format_segments
    from dynamont_jax.models.registry import load_model_for_pore
    from dynamont_jax.plot.segmentation import plot_borders
    from tests.synthetic import make_read

    model = load_model_for_pore("rna002")
    sig, read = make_read(model, n_bases=20, seed=0)
    segs = [("M", i + 2, i * 9, 0.9) for i in range(10)]
    rows = format_segments(segs, 0, len(sig), read, 5, rna=True)
    out = tmp_path / "plot.png"
    plot_borders(sig, rows, read, "readX", str(out), model,
                 border_probs=np.log(np.random.rand(len(sig))))
    assert out.exists() and out.stat().st_size > 0


def test_plot_params_smoke(tmp_path):
    from dynamont_jax.plot.trained_params import plot_parameters

    csv = tmp_path / "params.csv"
    csv.write_text(
        "epoch,batch,read,m1,e2,Zchange\n0,1,4,0.03,0.97,5.0\n0,2,8,0.031,0.969,2.0\n"
    )
    plot_parameters(str(csv), str(tmp_path))
    assert (tmp_path / "m1.pdf").exists()
    assert (tmp_path / "Zchange.pdf").exists()


def test_plot_tool_segments_cli(tmp_path):
    from dynamont_jax.plot.tool_segments import main as pts_main

    sig = ",".join(f"{v:.3f}" for v in 80 + 10 * np.sin(np.arange(200) / 7))
    tsv = tmp_path / "reads.tsv"
    tsv.write_text(f"r1\ts1\t{sig}\tACGTACGTAC\n")
    dyn = tmp_path / "dyn.csv"
    dyn.write_text(
        "readid,signalid,start,end,basepos,base,motif,state,"
        "posterior_probability,polish\n"
        "r1,s1,10,40,2,A,AACGT,M,0.9,NA\n"
        "r1,s1,40,90,3,C,ACGTA,M,0.8,NA\n"
    )
    u4 = tmp_path / "u4.tsv"
    u4.write_text(
        "a\tb\tc\td\tkmer\trid\tstart\tlength\n"
        "x\tx\tx\tx\tAAGAA\tr1\t15\t30\n"
    )
    out = tmp_path / "plots"
    pts_main([
        "--tsv", str(tsv), "--dynamont", str(dyn), "--uncalled4", str(u4),
        "--readid", "r1", "-o", str(out), "--region", "10:90",
        "--formats", "png",
    ])
    assert (out / "r1_tool_segmentation.png").stat().st_size > 0
    assert (out / "r1_tool_segmentation_region.png").stat().st_size > 0


def test_seg_to_fasta(tmp_path):
    from dynamont_jax.eval.converters import seg_to_fasta

    seg = tmp_path / "seg.csv"
    seg.write_text(
        "readid,signalid,start,end,basepos,base,motif,state,posterior_probability,polish\n"
        "r1,r1,0,5,3,A,AACGT,M,0.9,NA\n"
        "r1,r1,5,9,4,C,ACGTC,M,0.9,NA\n"
    )
    out = tmp_path / "out.fasta"
    n = seg_to_fasta(str(seg), {"r1": "AAACGTCCC"}, False, str(out))
    assert n == 1
    # one base per segment row, ordered by signal start (ref: segToFasta.py)
    assert out.read_text() == ">r1\nAC\n"
    # rna flips 5'->3'
    seg_to_fasta(str(seg), {"r1": "AAACGTCCC"}, True, str(out))
    assert out.read_text() == ">r1\nCA\n"


def test_seg_to_fasta_flavors(tmp_path):
    from dynamont_jax.eval.converters import seg_to_fasta

    # f5c resquiggle: kmer_idx indexes into the basecalled read
    f5cr = tmp_path / "f5c_resquiggle.tsv"
    f5cr.write_text(
        "read_id\tkmer_idx\tstart_raw_idx\tend_raw_idx\n"
        "r1\t0\t10\t20\n"
        "r1\t1\t.\t.\n"      # unaligned rows are skipped
        "r1\t2\t20\t30\n"
    )
    out = tmp_path / "o1.fasta"
    assert seg_to_fasta(str(f5cr), {"r1": "GATTACA"}, False, str(out)) == 1
    assert out.read_text() == ">r1\nGT\n"

    # f5c eventalign: read_index resolved through the .sum sidecar; base is
    # the middle of model_kmer
    f5ce = tmp_path / "f5c_eventalign.tsv"
    f5ce.write_text(
        "contig\tread_index\tmodel_kmer\tstart_idx\tend_idx\n"
        "c\t0\tAACGT\t100\t110\n"
        "c\t0\tUUUUU\t50\t60\n"
    )
    (tmp_path / "f5c_eventalign.sum").write_text(
        "read_index\tread_name\n0\trX\n"
    )
    assert seg_to_fasta(str(f5ce), {}, False, str(out)) == 1
    assert out.read_text() == ">rX\nTC\n"

    # uncalled4: aln.read_id + dtw.start + middle of seq.kmer
    u4 = tmp_path / "uncalled4.tsv"
    u4.write_text(
        "aln.read_id\tseq.kmer\tdtw.start\tdtw.length\n"
        "r9\tAAGAA\t7\t3\n"
        "r9\tCCTCC\t2\t5\n"
    )
    assert seg_to_fasta(str(u4), {}, False, str(out)) == 1
    assert out.read_text() == ">r9\nTG\n"


def test_downstream_eval(tmp_path):
    from dynamont_jax.eval import downstream

    flye = tmp_path / "assembly_info.txt"
    flye.write_text(
        "#seq_name\tlength\tcov.\tcirc.\n"
        "contig_1\t1000\t30.0\tN\ncontig_2\t4000\t50.0\tN\ncontig_3\t500\t10.0\tN\n"
    )
    vcf = tmp_path / "variants.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        "chr1\t100\tsv1\tN\t<DEL>\t20\tPASS\tSVTYPE=DEL;END=200\n"
        "chr1\t900\tsv2\tN\t<INS>\t20\tPASS\tSVTYPE=INS\n"
    )
    out = tmp_path / "summary.txt"
    downstream.main([str(flye), str(vcf), str(out)])
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "Total length: 5500"
    assert lines[1] == "N50: 4000"
    assert lines[3] == "Number of structural variants: 2"
    # round-trips into the metric aggregator's downstream parser
    from dynamont_jax.eval.collect_metrics import add_downstream_metrics
    rows = []
    add_downstream_metrics(rows, "dynamont", str(out))
    assert ("dynamont", 4000, "flye n50") in rows


def _write_tombo_fast5(path, readid, starts, lengths, bases, signal_len):
    import h5py

    with h5py.File(path, "w") as f5:
        grp = f5.create_group(
            "Analyses/RawGenomeCorrected_000/BaseCalled_template"
        )
        grp.attrs["status"] = "success"
        grp.attrs["read_start_rel_to_raw"] = 0
        ev = np.zeros(
            len(starts),
            dtype=[("start", "<i8"), ("length", "<i8"), ("base", "S1")],
        )
        ev["start"] = starts
        ev["length"] = lengths
        ev["base"] = bases
        ds = grp.create_dataset("Events", data=ev)
        ds.attrs["read_start_rel_to_raw"] = 10
        raw = f5.create_group(f"Raw/Reads/Read_{readid}")
        raw.create_dataset("Signal", data=np.zeros(signal_len, np.int16))


def test_tombo_reader_and_fasta(tmp_path):
    """read_tombo_borders mirrors RNA event borders into sequencing time
    (ref: compareTools.py:215-243); tombo_to_fasta rebuilds the sequence."""
    from dynamont_jax.eval.converters import tombo_to_fasta
    from dynamont_jax.plot.readers import read_tombo_borders

    d = tmp_path / "f5"
    d.mkdir()
    _write_tombo_fast5(
        d / "readX.fast5", "readX",
        starts=[0, 5, 12], lengths=[5, 7, 8], bases=[b"A", b"U", b"G"],
        signal_len=100,
    )
    borders = read_tombo_borders(str(d))
    assert "readX" in borders
    # starts+offset(10) = 10,15,22; ends = 15,22,30 -> unique {10,15,22,30}
    # mirrored: 100 - b - 1
    assert set(borders["readX"]) == {100 - b - 1 for b in (10, 15, 22, 30)}

    out = tmp_path / "out"
    n = tombo_to_fasta(str(d), rna=True, outfile=str(out))
    assert n == 1
    txt = (tmp_path / "out.fasta").read_text()
    assert txt == ">readX\nGTA\n"  # A,U->T,G sorted by start then reversed


def test_compare_tools_main_with_tombo_dorado_controls(tmp_path):
    import h5py

    from dynamont_jax.eval.compare_tools import main

    with h5py.File(tmp_path / "gt.h5", "w") as h5:
        h5.create_dataset("readX", data=np.array([20, 50, 80]))
    # dorado TSV matching read_dorado's columns
    dor = tmp_path / "dorado.tsv"
    dor.write_text(
        "readid\tsignalid\tposition\tbase\tmotif\tstart\tend\n"
        + "".join(
            f"readX\tsig\t{i}\tA\tAAAAA\t{s}\t{e}\n"
            for i, (s, e) in enumerate([(18, 49), (49, 81), (81, 95)])
        )
    )
    f5dir = tmp_path / "f5"
    f5dir.mkdir()
    _write_tombo_fast5(
        f5dir / "readX.fast5", "readX",
        starts=[9, 39, 69], lengths=[30, 30, 19], bases=[b"A", b"C", b"G"],
        signal_len=100,
    )
    out = tmp_path / "ratios.csv"
    main([
        "--gt", str(tmp_path / "gt.h5"), "--dorado", str(dor),
        "--tombo", str(f5dir), "--controls", "--max-distance", "5",
        "--plot", str(tmp_path / "fig"), "-o", str(out),
    ])
    txt = out.read_text()
    for tool in ("dorado", "tombo", "control_random", "control_uniform"):
        assert tool in txt, txt
    # dorado borders 18,49,81 are within 2 of every gt changepoint
    assert "dorado,5,1.0" in txt
    for suffix in ("_found_ratio.png", "_upset.png", "_seglen.png"):
        assert (tmp_path / f"fig{suffix}").exists()


def test_paper_figures(tmp_path):
    from dynamont_jax.eval.paper_figures import (
        aggregated_scores, load_metrics, main,
    )

    csv = tmp_path / "metrics.csv"
    csv.write_text(
        "Tool,Value,Metric\n"
        "dynamont,0.5,median delta\ndynamont,90,present\n"
        "dynamont,0.2,homogeneity\n"
        "f5c,0.4,median delta\nf5c,80,present\nf5c,0.4,homogeneity\n"
    )
    df = load_metrics(str(csv))
    assert "Metric Score" in df.columns
    # homogeneity is cost-like: smaller -> higher score
    h = df[df["Metric"] == "homogeneity"].set_index("Tool")["Metric Score"]
    assert h["dynamont"] > h["f5c"]
    agg = aggregated_scores(df)
    assert set(agg.index) == {"dynamont", "f5c"}

    tex = tmp_path / "out.tex"
    main(["tex", "-i", str(csv), "-o", str(tex)])
    body = tex.read_text()
    assert "cellcolor" in body and "aggregated metric score" in body

    hm = tmp_path / "hm.png"
    main(["heatmap", "-d", "ds1", str(csv), "-d", "ds2", str(csv),
          "-o", str(hm)])
    assert hm.exists()

    score_csv = tmp_path / "scores.csv"
    score_csv.write_text(
        "Tool,Score,Segment Quality\n"
        "dynamont,0.4,Median Delta\ndynamont,0.1,Homogeneity\n"
        "f5c,0.3,Median Delta\nf5c,0.2,Homogeneity\n"
    )
    main(["datasets", "-d", "ds1", str(score_csv), "-o",
          str(tmp_path / "cmp")])
    assert (tmp_path / "cmp_contrast.png").exists()
    assert (tmp_path / "cmp_homogeneity.png").exists()


def test_collect_metrics_scores_option(tmp_path):
    from dynamont_jax.eval import collect_metrics

    score_csv = tmp_path / "scores.csv"
    score_csv.write_text(
        "Tool,Score,Segment Quality\n"
        "dynamont,0.5,Median Delta\ndynamont,0.7,Median Delta\n"
    )
    out = tmp_path / "metrics.csv"
    collect_metrics.main(["--scores", str(score_csv), "-o", str(out)])
    assert "dynamont,0.6,Median Delta" in out.read_text()
