"""Training and serving steps of the port (``repro.train``): the
optimizers, int8 gradient compression, the training step and serving."""
