from gvamp_tpu_torch.io import plink, vecio

__all__ = ["plink", "vecio"]
