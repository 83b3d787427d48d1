"""Kernel wrappers, each beside its plain PyTorch version."""
