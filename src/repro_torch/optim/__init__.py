"""Optimizers of the port (port of ``repro.optim``): the L1 log-linear pCTR
model of the paper's application layer."""
