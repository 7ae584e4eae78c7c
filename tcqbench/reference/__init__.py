"""The plain reference that decides ``correct``: a serial OTCD in plain
PyTorch, which imports nothing of the program."""
