"""semantic_merge_tpu_torch — the semantic merge engine on an NVIDIA GPU.

A port of ``semantic_merge_tpu`` (JAX on a TPU) to PyTorch and CUDA. It
mirrors that package's module names and keeps its own copies of the
host code it needs; it never imports the JAX package. The port runs
``semdiff`` and ``semmerge`` end to end (``python -m
semantic_merge_tpu_torch``): scan, encode, the device diff join, the
embedding signature matcher (whose attention step is the hand-written
CUDA kernel in ``kernels/flash_chunk.cu``), refinement and lift; for a
merge, both sides' diffs in one device call, the device compose, the
applier, the text layer, the crash-safe in-place commit and the git
notes. Entry points run on the CUDA card, and on the CPU only when
asked (``--device cpu``).
"""
