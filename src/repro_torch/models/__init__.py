"""Models of the port (GNNs under ``models.gnn``)."""
