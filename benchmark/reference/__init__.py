"""Plain PyTorch and numpy references the benchmark judges the program against."""
