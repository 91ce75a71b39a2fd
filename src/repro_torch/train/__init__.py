"""Steps, engine and optimizer of the port: full-batch GNN training with
RSC, and LM train, prefill and decode."""
