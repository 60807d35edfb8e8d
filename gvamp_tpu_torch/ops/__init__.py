"""Packed-genotype operators of the PyTorch port."""
