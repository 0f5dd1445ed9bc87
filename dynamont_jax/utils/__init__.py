from dynamont_jax.utils.kmer import (
    kmer2int,
    int2kmer,
    seq_to_kmer_ids,
    successing_kmer,
    precessing_kmer,
)
from dynamont_jax.utils.pore_model import PoreModel, read_kmer_models, write_kmer_models
from dynamont_jax.utils.signal import hampel_filter, normalize_signal

__all__ = [
    "kmer2int",
    "int2kmer",
    "seq_to_kmer_ids",
    "successing_kmer",
    "precessing_kmer",
    "PoreModel",
    "read_kmer_models",
    "write_kmer_models",
    "hampel_filter",
    "normalize_signal",
]
