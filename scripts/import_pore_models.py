"""One-time import of pore-model data tables into packaged .npz files.

Pore models are measurement data (per-k-mer current level mean/stdev), not
code. This script converts TSV pore models (e.g. the ones shipped with the
reference implementation, or ONT's published tables) into the compact .npz
layout used by dynamont_jax.models.registry.

Usage: python scripts/import_pore_models.py SRC.model DST.npz
       python scripts/import_pore_models.py --all SRC_MODELS_DIR
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from dynamont_jax.utils.pore_model import load_pore_model, save_pore_model_npz

# canonical relative layout inside a dynamont-style models/ directory
KNOWN = {
    "rna/rna002/rna002_5mer.model": "rna002_5mer.npz",
    "rna/rna002/trained_rna002_5mer.model": "trained_rna002_5mer.npz",
    "rna/rna004/rna004_5mer.model": "rna004_5mer.npz",
    "rna/rna004/rna004_9mer.model": "rna004_9mer.npz",
    "dna/r10.4.1/dna_r10.4.1_e8.2_260bps.model": "dna_r10.4.1_e8.2_260bps.npz",
    "dna/r10.4.1/dna_r10.4.1_e8.2_400bps.model": "dna_r10.4.1_e8.2_400bps.npz",
}


def convert(src: str, dst: str) -> None:
    # load in DNA orientation (no reversal) so the npz is canonical 5'->3'
    model = load_pore_model(src, rna=False)
    save_pore_model_npz(dst, model)
    print(f"{src} -> {dst}  K={model.num_kmers} kmer_size={model.kmer_size}")


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(here, "..", "dynamont_jax", "models_data")
    os.makedirs(outdir, exist_ok=True)
    if sys.argv[1] == "--all":
        root = sys.argv[2]
        for rel, out in KNOWN.items():
            src = os.path.join(root, rel)
            if os.path.exists(src):
                convert(src, os.path.join(outdir, out))
            else:
                print(f"skip (missing): {src}")
    else:
        convert(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
    main()
