"""Attention ops of the port and the paged flash-decode CUDA kernel."""
