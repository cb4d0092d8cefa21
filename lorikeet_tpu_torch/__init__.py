"""lorikeet_tpu_torch: the PyTorch/CUDA port of lorikeet_tpu.

The port owns only the modules on the jax import chain of the `call` path
(likelihoods, engine, processing, cli and their helpers) and imports the
jax-free host modules (BAM/FASTA/VCF I/O, assembly, native C++ kernels,
models, strain analysis) from ``lorikeet_tpu`` unchanged.  The pair-HMM
forward runs as a hand-written CUDA kernel (``csrc/pairhmm.cu``) built at
first use; nothing here imports jax.
"""
