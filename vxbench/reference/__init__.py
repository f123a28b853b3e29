"""Plain references of the benchmark's configurations: PyTorch tensor
code that imports nothing of the program, works every table out again
from the inputs, and runs in any float dtype (the controls run it in a
lower precision than the configuration states)."""
