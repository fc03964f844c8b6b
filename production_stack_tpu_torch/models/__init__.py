"""Model definitions of the port (llama family)."""
