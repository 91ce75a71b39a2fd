"""Models of the port: GNNs under ``models.gnn``, the LM stack under
``models.lm``."""
