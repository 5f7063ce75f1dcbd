"""The benchmark's harness: the cell's set-up, its timed window, the trace
and its reading, and the comparison with the plain reference."""
