"""Serving engine of the port: config, scheduler, KV bookkeeping, runner."""
