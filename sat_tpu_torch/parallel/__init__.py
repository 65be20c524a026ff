"""The training and evaluation steps, the process group and the mesh."""
