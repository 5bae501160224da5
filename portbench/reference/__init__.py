"""The plain reference: NumPy (and, for the control, plain PyTorch) over
the benchmark's own inputs.  It imports nothing of the program."""
