"""Operation and byte counts of the program's kernels, and the chip's peaks."""
