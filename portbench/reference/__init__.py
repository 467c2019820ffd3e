"""The plain reference that judges the program's outputs: NumPy in
float64. It imports neither JAX, the JAX package nor anything of the
port, and takes nothing the port made but the outputs it judges; each
configuration names its model's module here (`plane`, `motion`)."""
