"""The benchmark's plain reference: a path tracer (`tracer`) and the display
pass (`post`) in plain PyTorch, written from the reference renderer's
shaders.  Nothing here imports the program under test or JAX."""
