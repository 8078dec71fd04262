"""The plain float32 reference that decides ``correct``: imports neither
JAX, ``repro`` nor ``repro_torch``, and takes nothing the program made."""
