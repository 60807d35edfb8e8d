"""gvamp_tpu_torch: the PyTorch / CUDA port of gvamp_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``gvamp_tpu``.  It runs the
linear VAMP path on one device, on complete (imputed) genotypes and on
genotypes with missing calls: the primal LMMSE block CG with SLQ Onsager
traces, the secant-extrapolated warm start and the folded noise pass,
then the LOO and LOCO association p-values.  The packed-genotype products
run in hand-written CUDA kernels on the card (``csrc/matvec.cu``) and in
their plain PyTorch versions on the CPU.  The port imports ``torch`` and never
``jax``; from ``gvamp_tpu`` it uses only the host modules that import no
JAX (``io``, ``native``, ``options``, ``ckpt.write_scalar_history`` and the
numpy helpers of ``sim``).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
