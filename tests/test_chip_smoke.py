"""chip_smoke.py's phases at a tiny size on the CPU.

On the card the script runs these at production size; here the same
functions run on a few short reads, the kernels in interpret mode (passed
explicitly) and the CLIs on the XLA path the CPU takes. The platform check
lives only in main()."""

import json
import os

import jax
import pytest

import chip_smoke as cs

TINY = dict(n_bases=36)


def test_phase_kernels_tiny():
    out = cs.phase_kernels(n_reads=3, n_train=3, interpret=True, reps=1,
                           **TINY)
    assert out["fwd_vit_choice_agreement_min"] >= 0.999
    for k in ("backward", "forward", "fwd_vit", "walk", "segment",
              "train_fp32"):
        assert out[k + "_kernel"]["best_s"] > 0
    assert out["train_fp64_scan"]["best_s"] > 0


def test_phase_basic_tiny(tmp_path):
    out = cs.phase_basic(str(tmp_path), n_reads=4, n_long=2, n_ref=2,
                         n_bases_long=60, interpret=True, **TINY)
    assert out["reads"] == 6 and out["ref_reads"] == 3
    assert out["ref_rows"] > 0
    assert out["ref_rows_differing"] <= max(1, out["ref_rows"] // 50)
    assert out["warm_wall_s"] > 0
    assert out["bucket"]["reads"] == 4
    assert out["bucket_kernel_memory"]["output_size_in_bytes"] > 0


def test_phase_resquiggle_tiny(tmp_path):
    out = cs.phase_resquiggle(str(tmp_path), n_reads=2, n_ref=1, n_bases=20)
    assert out["ref_rows"] > 0


def test_phase_train_tiny(tmp_path):
    out = cs.phase_train(str(tmp_path), n_reads=4, batch_size=2, **TINY)
    assert out["m1_rel"] <= 1e-3 and out["e2_rel"] <= 1e-3
    assert out["kmers_beyond_bound"] == 0
    assert os.path.exists(tmp_path / "train_fp32" / "trained_0_2.model")


def test_phase_train_trimmed_tiny(tmp_path):
    out = cs.phase_train_trimmed(str(tmp_path), n_reads=4, batch_size=2,
                                 trim_bases=3, **TINY)
    assert out["samples_cut"] == 27
    assert out["kmers_beyond_bound"] <= max(1, out["kmers"] // 100)
    assert os.path.exists(
        tmp_path / "train_trimmed_fp64" / "trained_0_2.model")


def test_phase_four_inference_on_virtual_devices():
    out = cs.phase_four_inference(4, n_reads=8, batch_size=2, **TINY)
    assert out["reads"] == 8


def test_phase_four_train_on_virtual_devices():
    out = cs.phase_four_train(4, n_reads=8, **TINY)
    assert out["reads"] == 8


def test_check_cli_output_flags_errors_and_missing_reads(tmp_path):
    out = tmp_path / "o.csv"
    out.write_text("readid,signalid,start,end,basepos,base,motif,state,"
                   "posterior_probability,polish\nr1,r1,0,5,0,A,AAAAA,M,0.9,\n")
    items = [("r1", None, "A")]
    assert set(cs.check_cli_output(str(out), items)) == {"r1"}
    with pytest.raises(AssertionError, match="missing"):
        cs.check_cli_output(str(out), items + [("r2", None, "C")])
    (tmp_path / "o.errors").write_text("error: 3, Z\tRid: r1\n")
    with pytest.raises(AssertionError, match="errors"):
        cs.check_cli_output(str(out), items)


def test_compare_rows_counts_border_and_posterior_changes():
    row = lambda start, p: ["r", "r", str(start), "9", "3", "A", "AAAAA",  # noqa: E731
                            "M", str(p), ""]
    want = [row(0, 0.9), row(9, 0.8)]
    assert cs.compare_rows([row(0, 0.9), row(9, 0.8001)], want, 2e-3) == (0, 2)
    assert cs.compare_rows([row(1, 0.9), row(9, 0.81)], want, 2e-3) == (2, 2)


def test_main_fails_without_gpu_and_prints_no_result(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) == 2
    assert cs.main(["--four"]) == 2
    out = capsys.readouterr().out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
