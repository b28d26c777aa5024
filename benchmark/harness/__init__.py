"""The general parts of the benchmark: finding files by name, the timed
window, the trace's reduction, the comparisons and the result line."""
