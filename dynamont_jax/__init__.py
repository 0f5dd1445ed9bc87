"""dynamont-jax: a JAX nanopore raw-signal segmentation / resquiggling engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of rnajena/dynamont
(pair-HMM forward-backward + Viterbi segmentation of Oxford Nanopore raw current
signals against basecalled reads, plus Baum-Welch parameter training).

Layer map (mirrors the reference's capabilities, not its architecture):

  utils/     numeric + k-mer + pore-model utilities   (ref: src/cpp/utils.cpp)
  ops/       DP: XLA scans + Triton kernels for the GPU (ref: src/cpp/NT*.cpp, NTC.cpp)
  models/    per-pore model registry + end-to-end read pipelines
  parallel/  jax.sharding meshes, data-parallel + psum training reductions
  io/        BAM/fast5/pod5 readers, CSV writers          (ref: src/python/segmentation)
  cli/       reference-compatible command line tools
"""

__version__ = "0.1.0"
