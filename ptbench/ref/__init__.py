"""Plain PyTorch references of the benchmark's configurations.  They
import nothing of the port (`repro_torch`) or of the JAX package."""
