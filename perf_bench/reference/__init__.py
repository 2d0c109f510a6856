"""Plain float32 references the benchmark judges the program by.

Plain ``torch`` only, TF32 off: the two architectures' forward passes
(``model``), the qsgd quantizer, EF-BV and AdamW (``train``).  They import
nothing of the program, of ``repro`` or of ``jax``; the weights and the
quantizer's uniform draws come from the harness, made from the seed.
"""
