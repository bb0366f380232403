"""Work counts of the program's kernels from their shapes, and the peaks they are held to."""
