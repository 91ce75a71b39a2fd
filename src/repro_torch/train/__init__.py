"""Step builders of the port (LM prefill and decode so far)."""
