"""The plain reference: numpy and plain PyTorch in float32 (float64 for the
consensus), written from the published semantics. It imports neither JAX
nor anything of ``latice_tpu`` or ``latice_tpu_torch``, and takes only the
weights and inputs that the benchmark made."""
