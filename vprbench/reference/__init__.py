"""The plain reference of the benchmark's cells: VGG16 + NetVLAD + PCA, the
exact scan, the int8 scheme and the SARE-ind step with SGD, written in plain
PyTorch. It imports nothing of the port or of the JAX package, and takes
nothing that the port made: the benchmark hands it the weights, frames,
gallery rows and tuples it made itself.

Every product runs in one of three precisions (``prec``):
  * ``"f64"``: float64, the reference proper;
  * ``"f32"``: float32 with TF32 off;
  * ``"tf32"``: float32 with both operands of every product rounded to TF32
    (a 10-bit mantissa, to nearest, ties away from zero) and, in a backward,
    the gradient that enters each product rounded the same way: the control,
    the next precision below the f32 that the configurations state. The
    rounding is explicit, so it means the same on the CPU and on the card.
"""
