"""The operations and bytes of each kernel's call, one file per kernel,
counted from the shapes and the inputs alone: the work that the inputs need,
the same whatever kernel computes it."""
