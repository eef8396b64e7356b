"""Tensor (PyTorch) encoder stages."""
