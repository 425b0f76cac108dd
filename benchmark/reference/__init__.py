"""The plain reference: float32 PyTorch, no kernel, nothing of the program."""
