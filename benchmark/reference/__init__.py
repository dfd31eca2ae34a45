"""The plain reference of the benchmark: the SpatialRGPT composite's forward,
loss and optimizer in plain PyTorch (float32, TF32 off), written from the
published architectures and configurations, independent of the program:
nothing here imports the port or JAX, and it reads only the benchmark's
own tensors and configuration files."""
