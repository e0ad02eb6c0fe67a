"""PyTorch/CUDA port of the DLA detection pipeline.

A second package beside the JAX reference (``gpy_dla_detection_tpu``):
the same Gaussian-process DLA catalog path, written with PyTorch tensors
and hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).  It imports
``torch`` and never ``jax``, and nothing of the JAX package: the
numpy-only modules it needs (``params``, ``constants``,
``data.spectrum``, ``data.samples``, ``data.catalog``,
``models.selection``) are its own copies, equal to the reference's.
Besides the catalog slice it carries the absorber MCMC head
(``models.mcmc``, ``models.absorber_mcmc``).

Float32 tensors on a CUDA device run the kernels; float32 tensors on the
CPU run each kernel's plain PyTorch twin; float64 (CPU only) runs the
exact conformance path.
"""

__version__ = "0.1.0"
