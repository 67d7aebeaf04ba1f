"""The plain reference of every configuration.

Plain PyTorch, run on the card after the measured window has closed. It
imports neither JAX, nor the JAX package, nor anything of the program
(``pyvisim_tpu_torch``); where it needs the program's plain versions it
holds frozen copies, each headed with the file and commit it was copied
from. It takes the benchmark's inputs (images, float32 weights, centres,
gallery rows) and works out again everything the program derives from
them.
"""
