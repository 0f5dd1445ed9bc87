"""Read/job sources for the batch pipelines.

Primary source mirrors the reference: a dorado basecall BAM (tags qs/ns/ts/
sp/pi/fn/sm/sd, ref: segment.py:226-260) + pod5/fast5/slow5 raw files via
read5_ont. Both pysam and read5_ont are optional; environments without them
can use the plain-TSV source (one read per line:
readid<TAB>signalid<TAB>comma-separated-signal<TAB>read-5'-3'), which feeds
the same job tuples.
"""

from __future__ import annotations

import sys
from collections import OrderedDict
from dataclasses import dataclass
from os.path import join

import numpy as np

from dynamont_jax.utils.signal import hampel_filter, prepare_read_sequence


@dataclass
class ReadJob:
    """One read ready for the DP (normalized, filtered, oriented)."""

    readid: str
    signalid: str
    signal: np.ndarray       # normalized + hampel-filtered slice
    read: str                # processing orientation
    read_5to3: str           # as basecalled (for output formatting... RNA uses
                             # the processing-orientation read there too)
    sig_offset: int          # start index within the full raw signal


_RAW_CACHE: OrderedDict = OrderedDict()
_RAW_CACHE_SIZE = 4  # ref: segment.py:117-130


def _open_raw(path: str):
    """read5_ont (pod5/fast5/slow5) when installed; otherwise the
    internal h5py multi-read fast5 reader (io/fast5.py) so the raw-bytes
    path works in read5_ont-less environments."""
    try:
        import read5_ont
    except ImportError:
        if path.endswith(".fast5"):
            from dynamont_jax.io.fast5 import Fast5Reader

            return Fast5Reader(path)
        raise
    return read5_ont.read(path)


def _get_raw(path: str):
    if path in _RAW_CACHE:
        _RAW_CACHE.move_to_end(path)
        return _RAW_CACHE[path]
    if len(_RAW_CACHE) >= _RAW_CACHE_SIZE:
        _, old = _RAW_CACHE.popitem(last=False)
        old.close()
    _RAW_CACHE[path] = _open_raw(path)
    return _RAW_CACHE[path]


def generate_bam_jobs(data_path: str, basecalls: str, min_qual: float = 0):
    """Yield raw job tuples from a dorado BAM (ref: segment.py:193-262)."""
    import pysam

    qual_skipped = 0
    with pysam.AlignmentFile(basecalls, "rb", check_sq=False) as samfile:
        for br in samfile.fetch(until_eof=True):
            qs = br.get_tag("qs")
            if min_qual and qs < min_qual:
                qual_skipped += 1
                continue
            readid = br.query_name
            signalid = br.get_tag("pi") if br.has_tag("pi") else readid
            seq = br.query_sequence
            ns = br.get_tag("ns")
            ts = br.get_tag("ts")
            sp = br.get_tag("sp") if br.has_tag("sp") else 0
            raw_file = join(
                data_path, br.get_tag("fn") if br.has_tag("fn") else br.get_tag("f5")
            )
            shift = br.get_tag("sm")
            scale = br.get_tag("sd")
            yield (raw_file, shift, scale, sp + ts, sp + ns, seq, readid, signalid)
    print(f"Skipped reads due to low quality: {qual_skipped}", file=sys.stderr)


def materialize_bam_job(args, rna: bool) -> ReadJob:
    """Load + normalize one BAM job (ref: segment.py:132-179). The shift>400
    heuristic selects raw DACs over pA values (dorado 0.9.x change)."""
    raw_file, shift, scale, start, end, read, readid, signalid = args
    r5 = _get_raw(raw_file)
    if shift > 400:
        signal = r5.getSignal(signalid)[start:end]
    else:
        signal = r5.getpASignal(signalid)[start:end]
    signal = (np.asarray(signal, dtype=np.float64) - shift) / scale
    hampel_filter(signal)
    oriented = prepare_read_sequence(read, rna)
    return ReadJob(
        readid=readid, signalid=signalid, signal=signal, read=oriented,
        read_5to3=read, sig_offset=start,
    )


def generate_tsv_jobs(path: str, rna: bool, min_qual: float = 0):
    """Plain-TSV read source (testing / pysam-less environments).

    Columns: readid, signalid, signal (comma-separated raw values), read
    (5'->3'). Signals are taken as already calibrated; normalization =
    (x - median) / MAD-ish scale is NOT applied — provide normalized values
    or add shift/scale columns 5 and 6.
    """
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            readid, signalid, sig_text, read = parts[:4]
            # parse the CSV floats in C (still raises on malformed input)
            signal = np.array(sig_text.split(","), dtype=np.float64)
            if len(parts) >= 6:
                shift, scale = float(parts[4]), float(parts[5])
                signal = (signal - shift) / scale
            hampel_filter(signal)
            oriented = prepare_read_sequence(read, rna)
            yield ReadJob(
                readid=readid, signalid=signalid, signal=signal,
                read=oriented, read_5to3=read, sig_offset=0,
            )
