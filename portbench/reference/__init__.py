"""The plain float32 reference the cells' outputs are held to.  Imports
neither JAX nor anything of the program."""
