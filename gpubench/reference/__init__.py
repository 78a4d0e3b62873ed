"""Plain PyTorch references of the benchmark's models, in float32 with
TF32 off: no kernel, cache or batching of the program, and nothing
imported from ``distkeras_torch`` or JAX. They take the benchmark's
seeded weights (``gpubench.weights``) and inputs, and work out again
whatever the program derives from them.

``precision.F32`` is the reference; ``precision.FP8`` rounds every
matrix product's operands to float8 e4m3 (per-tensor scales), the
control that a comparison has to reject.
"""
