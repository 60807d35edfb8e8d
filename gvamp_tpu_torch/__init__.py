"""gvamp_tpu_torch: the PyTorch / CUDA port of gvamp_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``gvamp_tpu``.  It runs on one
device the linear, probit and Huber VAMP engines, one phenotype or
several (``multi``), on complete (imputed) genotypes, on genotypes with
missing calls and on dense methylation data, the LOO and LOCO association
p-values, and every run mode of the JAX CLI.  The packed-genotype
products run in hand-written CUDA kernels on the card (``csrc/``) and in
their plain PyTorch versions on the CPU.

The package stands alone: it imports ``torch`` and never ``jax``, and
nothing of ``gvamp_tpu``, not even its modules that import no JAX.  What
it needs from them it keeps as its own copies (``io``, ``native``,
``options``, ``ckpt.write_scalar_history``, the numpy helpers of ``sim``).
Only the tests import both packages, to compare them.  Its entry points
put the data on the card unless the caller names the CPU.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
