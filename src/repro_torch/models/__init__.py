"""Model code of the port: config, layers, attention, embedding and the
dense transformer."""
