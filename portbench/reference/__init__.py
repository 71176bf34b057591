"""The plain reference the served tokens are judged against: PyTorch in
fp32 with TF32 off, written from the model's equations and the config
file alone. It imports no ``repro_torch``, ``repro`` or ``jax``, reads the
weights the benchmark made (never anything the program derived from
them), and runs after the program's state is freed, layer by layer, so
that it fits beside the weights."""
