"""lorikeet_tpu_torch: the PyTorch/CUDA port of lorikeet_tpu.

A package of its own: it imports ``torch``, never ``jax``, and nothing of
``lorikeet_tpu``.  The host modules (BAM/FASTA/VCF I/O, assembly, the native
C++ components, models, strain analysis, the simulator) are its own copies,
numpy and ctypes code with the same names and results as the JAX package's.
The device kernels are hand-written CUDA (``csrc/pairhmm.cu``: grouped and
flat pair-HMM forward; ``csrc/sw.cu``: Smith-Waterman with traceback), built
at first use into ``build/``; the activity chain and the sharded steps
(``parallel/``) are torch ops over ``torch.distributed``.
"""

__version__ = "0.1.0"
