"""The plain reference: the served model and its quantized cache, in plain
PyTorch, importing nothing of the program."""
