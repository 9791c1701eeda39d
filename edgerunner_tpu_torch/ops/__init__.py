"""Attention, kernels, sampling and point helpers of the PyTorch port."""
