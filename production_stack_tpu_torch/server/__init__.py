"""OpenAI-compatible HTTP front end of the port (standard library only)."""
