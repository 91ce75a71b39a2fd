"""The LM stack of the port: config, layers, attention, backbone."""
