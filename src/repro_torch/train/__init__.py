"""Steps and the optimizer of the port (LM train, prefill and decode so
far)."""
