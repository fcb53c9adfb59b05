"""Plain float32 PyTorch statements of what the program computes. Nothing
here imports the program or JAX; the cells hand these the same weights and
inputs they hand the program."""
