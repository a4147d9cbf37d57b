"""The benchmark's plain references: plain PyTorch and NumPy, importing
nothing of the program."""
